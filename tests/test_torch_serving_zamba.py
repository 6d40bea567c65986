"""Zamba2 experts behind the port's RoutedServer against the reference's,
on the same weights (f32 reduced configs, the CPU): two reduced
``zamba2_7b`` (5 layers, ``attn_every`` 2: two shared-block applications
with their own K/V groups, ``dt_bias`` trained-like) beside one reduced
dense ``llama3_2_1b``, behind one AE bank, ring layout, ``max_len`` 64,
serial and overlapped. Every uid's expert, fine class and tokens are
equal, and so are ``host_blocks``. The ring engine serves whatever cache
tree the model returns (SSM states, conv windows and K/V here) and
requires decode to write each leaf in place. ``plan_placement`` banks
the two Zamba2 experts as the reference's planner does, and the bank's
tokens equal JAX's banked server's and the per-engine server's. Paged and
speculative Zamba2 engines are refused in both packages. ``cuda``: a
Zamba2 engine's graph tokens equal its eager tokens equal the CPU's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro.configs import get_config
from repro.core import ExpertRegistry, build_matcher, init_ae
from repro.models import build_model
from repro.serve import ExpertEngine, Request, RoutedServer
from repro.serve import plan_placement as jplan
from repro_torch import core as tcore
from repro_torch import serve as tserve
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config as tget
from repro_torch.models import build_model as tbuild
from test_torch_zamba import SMALL, trained_like

EXPERTS = [("zamba_a", "zamba2_7b"), ("zamba_b", "zamba2_7b"),
           ("dense", "llama3_2_1b")]
PER_EXPERT = 5


def _arch_kw(arch):
    return SMALL if arch == "zamba2_7b" else {}


def _weights():
    out = []
    for i, (name, arch) in enumerate(EXPERTS):
        jmod = build_model(get_config(arch).reduced(name=arch,
                                                    **_arch_kw(arch)))
        params = jax.device_get(jmod.init(jax.random.PRNGKey(i)))
        if jmod.cfg.family == "hybrid":
            params = trained_like(params, seed=i)
        out.append(params)
    return out


def _registries(weights):
    """Fresh JAX and port registries of the three experts on the same
    weights (one config name per arch, so the two Zamba2 experts share an
    ``ExpertSpec``)."""
    jreg, treg = ExpertRegistry(), tcore.ExpertRegistry()
    for (name, arch), params in zip(EXPERTS, weights):
        kw = _arch_kw(arch)
        jreg.add(name, ExpertEngine(build_model(get_config(arch).reduced(
            name=arch, **kw)), params, max_len=64))
        treg.add(name, tserve.ExpertEngine(
            tbuild(tget(arch).reduced(name=arch, **kw)),
            to_torch(params, device="cpu"), max_len=64, device="cpu"))
    return jreg, treg


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
    # fingerprints chosen by their (deterministic) route: PER_EXPERT
    # requests for each expert; prompts of 2-6 and 28-32 tokens give
    # length buckets 8 (a padded 16-token chunk) and 32 (two chunks)
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
    return jm, tm, _weights(), traffic


def _serve_both(jsrv, tsrv, traffic):
    want = jsrv.serve([Request(u, f, p, m) for u, f, p, m in traffic])
    got = tsrv.serve([tserve.Request(u, f, p, m) for u, f, p, m in traffic])
    assert [r.uid for r in got] == [r.uid for r in want]
    for g, w in zip(got, want):
        assert (g.expert, g.fine_class) == (w.expert, w.fine_class), g.uid
        np.testing.assert_array_equal(g.tokens, w.tokens, err_msg=str(g.uid))
    return got


@pytest.mark.parametrize("executor", ["serial", "overlapped"])
def test_zamba_server_matches_reference(fleet, executor):
    jm, tm, weights, traffic = fleet
    jreg, treg = _registries(weights)
    jsrv = RoutedServer(jm, jreg, max_batch=4, executor=executor)
    tsrv = tserve.RoutedServer(tm, treg, max_batch=4, executor=executor,
                               device="cpu")
    got = _serve_both(jsrv, tsrv, traffic)
    assert {r.expert for r in got} == {n for n, _ in EXPERTS}
    for e in range(len(EXPERTS)):
        assert treg[e].backend.stats.host_blocks == \
            jreg[e].backend.stats.host_blocks, (executor, e)
    # both prefill shapes ran: a padded chunk (8) and two chunks (32)
    for e in range(2):
        sbs = {sb for _, sb in treg[e].backend.core._prefill_shapes}
        assert {8, 32} <= sbs, sbs
        assert treg[e].backend.stats.decode_steps > 0


@pytest.mark.parametrize("executor", ["serial", "overlapped"])
def test_zamba_bank_matches_reference(fleet, executor):
    """``plan_placement`` banks the two Zamba2 experts (the dense one
    stays solo), as the reference's planner does; the banked server's
    tokens equal JAX's banked server's and the per-engine server's, and
    the bank's ``host_blocks`` equal JAX's bank's."""
    jm, tm, weights, traffic = fleet
    jreg, treg = _registries(weights)
    jp, tp = jplan(jreg), tserve.plan_placement(treg)
    assert tp.shard_of == jp.shard_of
    assert [(s.experts, s.banked) for s in tp.shards] == \
        [(s.experts, s.banked) for s in jp.shards]
    assert [s.experts for s in tp.shards if s.banked] == [(0, 1)]
    jsrv = RoutedServer(jm, jreg, max_batch=4, executor=executor,
                        placement=jp)
    tsrv = tserve.RoutedServer(tm, treg, max_batch=4, executor=executor,
                               placement=tp, device="cpu")
    got = _serve_both(jsrv, tsrv, traffic)
    solo = tserve.RoutedServer(tm, _registries(weights)[1], max_batch=4,
                               executor=executor, device="cpu")
    alone = solo.serve([tserve.Request(u, f, p, m)
                        for u, f, p, m in traffic])
    for g, s in zip(got, alone):
        np.testing.assert_array_equal(g.tokens, s.tokens, err_msg=str(g.uid))
    jb = next(s.bank for s in jp.shards if s.banked)
    tb = next(s.bank for s in tp.shards if s.banked)
    assert tb.stats.host_blocks == jb.stats.host_blocks


@pytest.mark.parametrize("kw,match", [
    ({"kv_layout": "paged"}, "paged KV cache protocol"),
    ({"speculate_k": 2}, "speculative verify protocol")],
    ids=["paged", "speculative"])
def test_paged_and_speculative_zamba_are_refused_in_both(kw, match):
    cfg = get_config("zamba2_7b").reduced()
    jmod = build_model(cfg)
    tmod = tbuild(tget("zamba2_7b").reduced())
    assert not tmod.supports_paged_kv and not tmod.supports_verify
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match=match):
        ExpertEngine(jmod, params, max_len=64, **kw)
    with pytest.raises(ValueError, match=match):
        tserve.ExpertEngine(tmod, to_torch(params, device="cpu"), max_len=64,
                            device="cpu", **kw)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_zamba_graph_equals_eager_equals_cpu(cuda, fleet):
    """A Zamba2 engine on the card through captured decode graphs, and
    eagerly, against the CPU engine on the same weights: equal tokens
    over both prefill shapes; the graph engine captured its steps."""
    weights = fleet[2][0]
    tmod = tbuild(tget("zamba2_7b").reduced(**SMALL))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 300, size=n).astype(np.int32)
               for n in (5, 20, 30)]

    def drain(eng):
        eng.admit([0, 1, 2], prompts, [9, 12, 10])
        while eng.n_active:
            eng.tick(defer=True)
            eng.harvest()
        return dict(eng.poll())

    want = drain(tserve.ExpertEngine(tmod, to_torch(weights, device="cpu"),
                                     max_len=64, device="cpu"))
    gpu = to_torch(weights, device=cuda)
    graph = tserve.ExpertEngine(tmod, gpu, max_len=64, device=cuda)
    got = drain(graph)
    eager = drain(tserve.ExpertEngine(tmod, gpu, max_len=64, device=cuda,
                                      capture_decode=False))
    for u in want:
        np.testing.assert_array_equal(got[u], want[u])
        np.testing.assert_array_equal(eager[u], want[u])
    assert graph.stats.decode_captured > 0
