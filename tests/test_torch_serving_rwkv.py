"""A mixed-family RoutedServer — two reduced RWKV6 experts and one reduced
dense expert behind one AE bank, ring layout, ``max_len`` 64 — in the
port against the reference on the same weights, serial and overlapped:
the same expert, fine class and tokens for every uid, and equal
``host_blocks``. The ring engine serves whatever cache tree the model
returns (a recurrent state here, K/V for the dense expert); a paged
engine refuses the RWKV family in both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro.configs import get_config
from repro.core import ExpertRegistry, build_matcher, init_ae
from repro.models import build_model
from repro.serve import ExpertEngine, Request, RoutedServer
from repro_torch import core as tcore
from repro_torch import serve as tserve
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config as tget
from repro_torch.models import build_model as tbuild
from test_torch_rwkv import trained_like

EXPERTS = [("rwkv_a", "rwkv6_7b"), ("rwkv_b", "rwkv6_7b"),
           ("dense", "llama3_2_1b")]
PER_EXPERT = 5


@pytest.fixture(scope="module")
def fleet():
    rng = np.random.default_rng(0)
    names = [n for n, _ in EXPERTS]
    aes = [init_ae(jax.random.PRNGKey(10 + i)) for i in range(len(names))]
    data = [(rng.random((64, 784), dtype=np.float32), np.arange(64) % 3)
            for _ in names]
    jm = build_matcher(aes, names, data)
    tm = tcore.ExpertMatcher(
        to_torch(jax.device_get(jm.bank_params), device="cpu"),
        to_torch(jax.device_get(jm.bank_states), device="cpu"), names,
        to_torch(np.asarray(jm.centroids), device="cpu"),
        to_torch(np.asarray(jm.centroid_mask), device="cpu"))
    jreg, treg = ExpertRegistry(), tcore.ExpertRegistry()
    for i, (name, arch) in enumerate(EXPERTS):
        jmod = build_model(get_config(arch).reduced(name=name))
        params = jax.device_get(jmod.init(jax.random.PRNGKey(i)))
        if jmod.cfg.family == "rwkv":
            params = trained_like(params, seed=i)
        jreg.add(name, ExpertEngine(jmod, params, max_len=64))
        tmod = tbuild(tget(arch).reduced(name=name))
        treg.add(name, tserve.ExpertEngine(
            tmod, to_torch(params, device="cpu"), max_len=64, device="cpu"))
    # fingerprints chosen by their (deterministic) route: PER_EXPERT
    # requests for each expert; prompts of 2-6 and 28-32 tokens give every
    # expert length buckets 8 (an RWKV scan prefill) and 32 (chunked,
    # ssm_chunk 16)
    cands = rng.random((256, 784), dtype=np.float32)
    route = np.asarray(jm.assign_coarse(jnp.asarray(cands)))
    picks = [np.flatnonzero(route == e)[:PER_EXPERT]
             for e in range(len(names))]
    assert all(len(p) == PER_EXPERT for p in picks)
    traffic = []
    for uid, j in enumerate(np.stack(picks, axis=1).ravel()):
        n = 4 + 26 * (uid % 2) + int(rng.integers(-2, 3))
        traffic.append((uid, cands[j], rng.integers(
            0, 300, size=n).astype(np.int32), int(rng.integers(1, 7))))
    return jm, tm, jreg, treg, traffic


@pytest.mark.parametrize("executor", ["serial", "overlapped"])
def test_mixed_family_server_matches_reference(fleet, executor):
    jm, tm, jreg, treg, traffic = fleet
    E = len(EXPERTS)
    blocks0 = [(jreg[e].backend.stats.host_blocks,
                treg[e].backend.stats.host_blocks) for e in range(E)]
    jsrv = RoutedServer(jm, jreg, max_batch=4, executor=executor)
    tsrv = tserve.RoutedServer(tm, treg, max_batch=4, executor=executor,
                               device="cpu")
    want = jsrv.serve([Request(u, f, p, m) for u, f, p, m in traffic])
    got = tsrv.serve([tserve.Request(u, f, p, m) for u, f, p, m in traffic])
    assert [r.uid for r in got] == [r.uid for r in want]
    for g, w in zip(got, want):
        assert (g.expert, g.fine_class) == (w.expert, w.fine_class), g.uid
        np.testing.assert_array_equal(g.tokens, w.tokens, err_msg=str(g.uid))
    assert {r.expert for r in got} == {n for n, _ in EXPERTS}
    for e in range(E):
        jb = jreg[e].backend.stats.host_blocks - blocks0[e][0]
        tb = treg[e].backend.stats.host_blocks - blocks0[e][1]
        assert tb == jb, (executor, e)
    # both RWKV prefill branches ran: a bucket below ssm_chunk (scan) and
    # multiples of it (chunked)
    chunk = treg[0].backend.model.cfg.ssm_chunk
    for e in range(2):
        sbs = {sb for _, sb in treg[e].backend.core._prefill_shapes}
        assert min(sbs) < chunk and max(sbs) >= 2 * chunk, sbs


def test_paged_rwkv_engine_is_refused_in_both():
    jmod = build_model(get_config("rwkv6_7b").reduced())
    tmod = tbuild(tget("rwkv6_7b").reduced())
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="paged KV cache protocol"):
        ExpertEngine(jmod, params, max_len=64, kv_layout="paged")
    with pytest.raises(ValueError, match="paged KV cache protocol"):
        tserve.ExpertEngine(tmod, to_torch(params, device="cpu"), max_len=64,
                            kv_layout="paged", device="cpu")
