"""MoE experts behind the port's RoutedServer against the reference's, on
the same bridged weights (f32 reduced configs, the CPU).

A capacity-dispatch MoE expert (``olmoe_1b_7b`` reduced: 4 experts, top
2, factor 1.25) serves beside a dense one (``llama3_2_1b`` reduced). Its
prefill drops tokens past capacity over the whole padded wave (padding
rows and positions take slots too), and a chunked prefill drops per
chunk, so these cases hold the port to the reference's drops as they
fall: ring and paged (``chunk_len`` 16, prompts of up to four chunks, a
cohort served twice so that the prefix cache hits), serial and
overlapped, and speculative decoding (k 2, the ``table`` draft). Every
uid's expert, fine class and tokens are equal, and so are
``host_blocks`` and the paged and spec counters. ``plan_placement``
leaves dispatch MoE experts solo and banks ``moe_impl="dense"`` ones,
whose bank gives JAX's banked server's tokens and the per-engine
server's. ``cuda``: a MoE engine's graph tokens equal its eager tokens
equal the CPU's, ring and paged.
"""
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
from repro.serve import plan_placement as jplan
from repro_torch import core as tcore
from repro_torch import serve as tserve
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config as tget
from repro_torch.models import build_model as tbuild
from repro_torch.tree import tree_map

#: the counters a paged or spec run must share with the reference's
COUNTERS = ("host_blocks", "decode_steps", "tokens_generated",
            "prefill_tokens_submitted", "prefill_tokens_computed",
            "prefix_dup_rows", "prefix_full_hits", "prefix_pages_shared",
            "verify_steps", "tokens_drafted", "tokens_accepted",
            "spec_fallback_waves")
ARCHS = (("olmoe_1b_7b", {}), ("llama3_2_1b", {}))


@pytest.fixture(scope="module")
def fleet():
    bench = load_benchmark(names=["mnist", "har"], n_per_dataset=300, seed=0)
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
    feats = [bench[n]["client_a"][0] for n in names]
    return names, jm, tm, feats


def _models(arch, name, **kw):
    return (build_model(get_config(arch).reduced(name=name, **kw)),
            tbuild(tget(arch).reduced(name=name, **kw)))


def _servers(fleet, archs, executor, budget=0, placement=False, **kw):
    names, jm, tm, _ = fleet
    jreg, treg = ExpertRegistry(), tcore.ExpertRegistry()
    for i, (n, (arch, akw)) in enumerate(zip(names, archs)):
        jmod, tmod = _models(arch, f"e{i}", **akw)
        p = jax.device_get(jmod.init(jax.random.PRNGKey(10 + i)))
        jreg.add(n, ExpertEngine(jmod, p, max_len=64, **kw))
        treg.add(n, tserve.ExpertEngine(tmod, to_torch(p, device="cpu"),
                                        max_len=64, device="cpu", **kw))
    jp = jplan(jreg) if placement else None
    tp = tserve.plan_placement(treg) if placement else None
    jsrv = RoutedServer(jm, jreg, max_batch=4, executor=executor,
                        prefill_tokens_per_step=budget, placement=jp)
    tsrv = tserve.RoutedServer(tm, treg, max_batch=4, executor=executor,
                               prefill_tokens_per_step=budget,
                               placement=tp, device="cpu")
    return jsrv, tsrv, jreg, treg, jp, tp


def _traffic(fleet, rng, n, lo, hi, uid0=0):
    feats = fleet[3]
    return [(u, feats[u % 2][u], rng.integers(0, 300, size=int(
        rng.integers(lo, hi + 1))).astype(np.int32), int(rng.integers(2, 7)))
        for u in range(uid0, uid0 + n)]


def _serve_both(jsrv, tsrv, traffic):
    want = jsrv.serve([Request(u, f, p, m) for u, f, p, m in traffic])
    got = tsrv.serve([tserve.Request(u, f, p, m) for u, f, p, m in traffic])
    assert [r.uid for r in got] == [r.uid for r in want]
    for g, w in zip(got, want):
        assert (g.expert, g.fine_class) == (w.expert, w.fine_class), g.uid
        np.testing.assert_array_equal(g.tokens, w.tokens, err_msg=str(g.uid))
    return got


def _counters(reg):
    return [{k: getattr(reg[e].backend.stats, k) for k in COUNTERS}
            for e in range(len(reg))]


@pytest.mark.parametrize("executor", ["serial", "overlapped"])
@pytest.mark.parametrize("kv", ["ring", "paged"])
def test_moe_server_matches_reference(fleet, kv, executor):
    """Ring: prompts of 2-40 tokens in waves of up to 4. Paged: chunked
    prefill (16 tokens a chunk and a step), prompts of up to 60 tokens,
    and a cohort sharing a 32-token head served twice (fresh uids, the
    tails reversed): its second pass reuses the cached head, so the MoE
    prefill runs only the later chunks, whose drops differ from a cold
    prefill's, as the reference's do."""
    kw = {"kv_layout": "paged", "chunk_len": 16} if kv == "paged" else {}
    jsrv, tsrv, jreg, treg, _, _ = _servers(
        fleet, ARCHS, executor, budget=16 if kv == "paged" else 0, **kw)
    rng = np.random.default_rng(21)
    traffic = _traffic(fleet, rng, 10, 2, 60 if kv == "paged" else 40)
    if kv == "paged":
        head = rng.integers(0, 300, size=32)
        for u in range(3):
            traffic.append((20 + u, fleet[3][0][7], np.concatenate(
                [head, rng.integers(0, 300, size=8 + 4 * u)]).astype(
                    np.int32), 3))
    _serve_both(jsrv, tsrv, traffic)
    if kv == "paged":
        _serve_both(jsrv, tsrv, [
            (u + 100, f, np.concatenate([p[:32], p[32:][::-1]])
             if u >= 20 else p, m) for u, f, p, m in traffic])
    assert _counters(treg) == _counters(jreg)
    moe = treg[0].backend.stats
    assert moe.decode_steps > 0
    if kv == "paged":
        assert moe.suffix_compiles > 0 and moe.prefix_full_hits > 0
        for e in range(2):
            treg[e].backend.core.pool.check()


def test_moe_spec_server_matches_reference(fleet):
    """``speculate_k=2`` with the ``table`` draft: the verify window runs
    the MoE dropless, as decode does; tokens and spec counters equal."""
    jsrv, tsrv, jreg, treg, _, _ = _servers(fleet, ARCHS, "overlapped",
                                            speculate_k=2, draft="table")
    rng = np.random.default_rng(22)
    traffic = [(u, f, p % 100, m + 6) for u, f, p, m in
               _traffic(fleet, rng, 8, 3, 16)]
    _serve_both(jsrv, tsrv, traffic)
    assert _counters(treg) == _counters(jreg)
    assert treg[0].backend.stats.verify_steps > 0


def test_dispatch_moe_stays_singleton_and_dense_moe_banks(fleet):
    """Two dispatch MoE experts and two dense llama ones: the planner
    banks the llama pair only, as the reference's does."""
    names, _, tm, _ = fleet
    reg = tcore.ExpertRegistry()
    jreg = ExpertRegistry()
    for i, (arch, tag) in enumerate((("llama3_2_1b", "d"),
                                     ("llama3_2_1b", "d"),
                                     ("mixtral_8x22b", "m"),
                                     ("mixtral_8x22b", "m"))):
        jmod, tmod = _models(arch, f"pair-{tag}")
        p = jax.device_get(jmod.init(jax.random.PRNGKey(30 + i)))
        jreg.add(f"x{i}", ExpertEngine(jmod, p, max_len=64))
        reg.add(f"x{i}", tserve.ExpertEngine(tmod, to_torch(p, device="cpu"),
                                             max_len=64, device="cpu"))
    assert not reg[2].backend.spec.bankable
    plan, jp = tserve.plan_placement(reg), jplan(jreg)
    assert plan.shard_of == jp.shard_of
    assert [(s.experts, s.banked) for s in plan.shards] == \
        [(s.experts, s.banked) for s in jp.shards]
    banked = [s for s in plan.shards if s.banked]
    assert len(banked) == 1 and banked[0].experts == (0, 1)
    assert {s.experts[0] for s in plan.shards if not s.banked} == {2, 3}
    assert isinstance(reg[2].backend, tserve.ExpertEngine)
    hub_model = tbuild(tget("mixtral_8x22b").reduced(name="hub-moe"))
    with pytest.raises(ValueError):
        tserve.ExpertHub(hub_model, n_slots=1, device="cpu")


@pytest.mark.parametrize("executor", ["serial", "overlapped"])
def test_dense_impl_moe_bank_matches_reference(fleet, executor):
    """Two ``moe_impl="dense"`` MoE experts bank together; the bank's
    tokens equal JAX's banked server's and the port's per-engine
    server's."""
    archs = [("olmoe_1b_7b", {"moe_impl": "dense"})] * 2
    jsrv, tsrv, _, _, jp, tp = _servers(fleet, archs, executor,
                                        placement=True)
    assert [s.banked for s in tp.shards] == [True]
    solo = _servers(fleet, archs, "serial")[1]
    rng = np.random.default_rng(23)
    traffic = _traffic(fleet, rng, 10, 2, 40)
    got = _serve_both(jsrv, tsrv, traffic)
    alone = solo.serve([tserve.Request(u, f, p, m)
                        for u, f, p, m in traffic])
    for g, s in zip(got, alone):
        np.testing.assert_array_equal(g.tokens, s.tokens, err_msg=str(g.uid))
    jb, tb = jp.shards[0].bank, tp.shards[0].bank
    assert tb.stats.host_blocks == jb.stats.host_blocks


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["ring", "paged"])
def test_cuda_moe_graph_equals_eager_equals_cpu(cuda, kv):
    """A dispatch MoE engine (factor 0.5: its prefills drop) on the card
    through captured decode graphs, and eagerly, against the CPU engine
    on the same weights: equal tokens."""
    _, tmod = _models("olmoe_1b_7b", "cuda-moe", moe_capacity_factor=0.5)
    cpu = tmod.init(torch.Generator().manual_seed(3), device="cpu")
    gpu = tree_map(lambda t: t.to(cuda), cpu)
    kw = {"kv_layout": "paged", "chunk_len": 16} if kv == "paged" else {}
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 300, size=n).astype(np.int32)
               for n in (5, 20, 40)]

    def drain(eng):
        # blocking admission: a chunked wave's prefill chunks land first
        eng.admit([0, 1, 2], prompts, [9, 12, 10])
        while eng.n_active:
            eng.tick(defer=True)
            eng.harvest()
        return dict(eng.poll())

    want = drain(tserve.ExpertEngine(tmod, cpu, max_len=64, device="cpu",
                                     **kw))
    graph = tserve.ExpertEngine(tmod, gpu, max_len=64, device=cuda, **kw)
    got = drain(graph)
    eager = drain(tserve.ExpertEngine(tmod, gpu, max_len=64, device=cuda,
                                      capture_decode=False, **kw))
    for u in want:
        np.testing.assert_array_equal(got[u], want[u])
        np.testing.assert_array_equal(eager[u], want[u])
    assert graph.stats.decode_captured > 0

