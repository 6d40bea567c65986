"""The port's RoutedServer against the reference's on the same bridged
weights: one reduced dense arch per expert, ring KV, serial and
overlapped executors. Both return the same expert, fine class and tokens
for every uid, and EngineStats.host_blocks follows the same rule."""
import jax
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro.configs import get_config
from repro.core import ExpertRegistry, build_matcher, train_bank
from repro.data import load_benchmark
from repro.models import build_model
from repro.serve import ExpertEngine, Request, RoutedServer
from repro_torch import core as tcore
from repro_torch import serve as tserve
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config as tget
from repro_torch.launch.mesh import ExpertMesh
from repro_torch.models import build_model as tbuild

ARCHS = ["smollm_135m", "llama3_2_1b"]


@pytest.fixture(scope="module")
def fleet():
    bench = load_benchmark(names=["mnist", "har"], n_per_dataset=400, seed=0)
    names = list(bench)
    aes, _ = train_bank([(n, bench[n]["server"][0]) for n in names],
                        epochs=4, batch_size=64)
    cents = [(bench[n]["server"][0], bench[n]["server"][1]) for n in names]
    jm = build_matcher(aes, names, cents)
    tm = tcore.ExpertMatcher(
        to_torch(jax.device_get(jm.bank_params), device="cpu"),
        to_torch(jax.device_get(jm.bank_states), device="cpu"), names,
        to_torch(np.asarray(jm.centroids), device="cpu"),
        to_torch(np.asarray(jm.centroid_mask), device="cpu"))
    jreg, treg = ExpertRegistry(), tcore.ExpertRegistry()
    for i, n in enumerate(names):
        jmod = build_model(get_config(ARCHS[i]).reduced(name=f"e{i}"))
        params = jax.device_get(jmod.init(jax.random.PRNGKey(i)))
        jreg.add(n, ExpertEngine(jmod, params, max_len=64))
        tmod = tbuild(tget(ARCHS[i]).reduced(name=f"e{i}"))
        treg.add(n, tserve.ExpertEngine(tmod, to_torch(params, device="cpu"),
                                        max_len=64, device="cpu"))
    rng = np.random.default_rng(0)
    traffic = []
    for uid in range(12):
        x, _ = bench[names[uid % 2]]["client_a"]
        traffic.append((uid, x[uid], rng.integers(
            0, 300, size=int(rng.integers(2, 30))).astype(np.int32),
            int(rng.integers(1, 7))))
    return jm, tm, jreg, treg, traffic


@pytest.mark.parametrize("executor", ["serial", "overlapped"])
def test_routed_server_matches_reference(fleet, executor):
    jm, tm, jreg, treg, traffic = fleet
    blocks0 = [(jreg[e].backend.stats.host_blocks,
                treg[e].backend.stats.host_blocks) for e in range(2)]
    jsrv = RoutedServer(jm, jreg, max_batch=4, executor=executor)
    tsrv = tserve.RoutedServer(tm, treg, max_batch=4, executor=executor,
                               device="cpu")
    want = jsrv.serve([Request(u, f, p, m) for u, f, p, m in traffic])
    got = tsrv.serve([tserve.Request(u, f, p, m) for u, f, p, m in traffic])
    assert [r.uid for r in got] == [r.uid for r in want]
    for g, w in zip(got, want):
        assert (g.expert, g.fine_class) == (w.expert, w.fine_class), g.uid
        np.testing.assert_array_equal(g.tokens, w.tokens, err_msg=str(g.uid))
        np.testing.assert_allclose(g.coarse_scores, w.coarse_scores,
                                   rtol=2e-5, atol=1e-6)
    for e in range(2):
        jb = jreg[e].backend.stats.host_blocks - blocks0[e][0]
        tb = treg[e].backend.stats.host_blocks - blocks0[e][1]
        assert tb == jb, (executor, e)
    assert tsrv.scheduler.stats.as_dict() == {
        k: v for k, v in jsrv.scheduler.stats.as_dict().items()
        if k in tsrv.scheduler.stats.as_dict()}
    snap = tsrv.snapshot()
    assert snap["executor"] == {"name": executor}
    assert snap["scheduler"]["responses"] == len(traffic)
    assert snap["engines"]["shard0"]["host_blocks"] == \
        treg[0].backend.stats.host_blocks
    assert snap["router"]["routed"] == len(traffic)


def _engine(seed=0, max_len=32):
    model = tbuild(tget("smollm_135m").reduced(name=f"eng-{seed}"))
    params = model.init(torch.Generator().manual_seed(seed), device="cpu")
    return tserve.ExpertEngine(model, params, max_len=max_len, device="cpu")


def test_serial_blocks_once_per_tick_per_wave_overlapped_less():
    """Serial: one host block per admitted wave plus one per tick; the
    overlapped path blocks only when a row can complete."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 50, 5), rng.integers(0, 50, 7)]
    eng = _engine()
    eng.admit([0, 1], prompts, [4, 6])
    while eng.n_active:
        eng.tick()
    serial = dict(eng.poll())
    assert eng.stats.host_blocks == 1 + 5
    eng2 = _engine()
    eng2.admit([0, 1], prompts, [4, 6], defer=True)
    while eng2.n_active:
        eng2.tick(defer=True)
        eng2.harvest()
    over = dict(eng2.poll())
    assert eng2.stats.host_blocks == 2       # rows finish at 4 and 6
    for u in (0, 1):
        np.testing.assert_array_equal(serial[u], over[u])


def test_bucket_ladder_and_shape_counters():
    assert tserve.make_buckets(8, 64) == (8, 16, 32, 64)
    assert tserve.make_buckets(1, 12) == (1, 2, 4, 8, 12)
    assert tserve.bucket_for(9, (4, 8)) == 8
    with pytest.raises(ValueError):
        tserve.make_buckets(8, 4)
    eng = _engine(seed=2)
    rng = np.random.default_rng(0)
    eng.admit([0], [rng.integers(0, 50, 5)], [2])
    eng.admit([1], [rng.integers(0, 50, 6)], [1])      # same (1, 8) bucket
    assert eng.stats.prefill_compiles == 1
    eng.admit([2], [rng.integers(0, 50, 20)], [1])     # new length bucket
    assert eng.stats.prefill_compiles == 2
    while eng.n_active:
        eng.tick()
    assert eng.stats.decode_compiles == 1
    assert {u for u, _ in eng.poll()} == {0, 1, 2}


def test_generate_does_not_steal_scheduler_rows():
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 50, 6), rng.integers(0, 50, 4)]
    ref = _engine(seed=3)
    ref.admit([0, 1], prompts, [3, 4])
    while ref.n_active:
        ref.tick()
    want = dict(ref.poll())
    eng = _engine(seed=3)
    eng.admit([0, 1], prompts, [3, 4])
    eng.tick()
    out = eng.generate(rng.integers(0, 50, size=(2, 5)), 2)
    assert out.shape == (2, 2)
    while eng.n_active:
        eng.tick()
    got = dict(eng.poll())
    assert set(got) == {0, 1}
    for u in (0, 1):
        np.testing.assert_array_equal(got[u], want[u])


def test_later_slice_options_raise():
    """Banked placement, the hub and the expert mesh are ported (A9,
    A12): an object that is no mesh raises an ``AttributeError``, a mesh
    that does not divide the slot bank the reference's ``ValueError``.
    Every A10 family builds: Zamba2 (A10.3) and the encoder-decoder
    (A10.4)."""
    tmod = tbuild(tget("smollm_135m").reduced(name="later"))
    reg = tcore.ExpertRegistry()
    for name in ("a", "b"):              # one bank, laid out over the mesh
        reg.add(name, tserve.ExpertEngine(tmod, tmod.init(0, device="cpu"),
                                          max_len=64, device="cpu"))
    with pytest.raises(AttributeError, match="shape"):
        tserve.plan_placement(reg, mesh=object())
    with pytest.raises(AttributeError, match="shape"):
        tserve.ExpertHub(tmod, n_slots=1, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="must divide the bank's 3"):
        tserve.ExpertHub(tmod, n_slots=3, mesh=ExpertMesh(("cpu",) * 2),
                         device="cpu")
    assert tbuild(tget("seamless_m4t_large_v2").reduced(
        name="now-encdec")).cfg.family == "encdec"
    assert tbuild(tget("zamba2_7b").reduced(
        name="now-hybrid")).cfg.family == "hybrid"
