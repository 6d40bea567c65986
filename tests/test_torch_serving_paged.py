"""The port's paged RoutedServer against the reference's on the same
bridged weights: kv_layout="paged", serial and overlapped. For every uid
both return the same expert, fine class and tokens, and every engine
ends with equal prefill, prefix-sharing, copy-on-write and host-block
counters; after the drain each page pool's books balance and only the
prefix cache holds pages. Cases: shared-prefix cohorts served twice
(in-wave dedup, then cross-wave prefix-cache hits), a wrapping duplicate
(copy-on-write), chunked prefill under a token budget, and a pool small
enough to force PagePoolExhausted backpressure."""
import jax
import numpy as np
import pytest

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
from repro_torch.models import build_model as tbuild

COUNTERS = ("prefill_tokens_submitted", "prefill_tokens_computed",
            "prefill_rows_computed", "prefix_dup_rows", "prefix_full_hits",
            "prefix_pages_shared", "pages_copied", "host_blocks",
            "decode_steps", "tokens_generated")


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
    jmod = build_model(get_config("smollm_135m").reduced(name="pg"))
    tmod = tbuild(tget("smollm_135m").reduced(name="pg"))
    params = [jax.device_get(jmod.init(jax.random.PRNGKey(s)))
              for s in (0, 1)]
    feats = [bench[n]["client_a"][0] for n in names]
    return names, jm, tm, jmod, tmod, params, feats


def _servers(fleet, executor, budget=0, **kw):
    names, jm, tm, jmod, tmod, params, _ = fleet
    jreg, treg = ExpertRegistry(), tcore.ExpertRegistry()
    for n, p in zip(names, params):
        jreg.add(n, ExpertEngine(jmod, p, max_len=64, kv_layout="paged",
                                 **kw))
        treg.add(n, tserve.ExpertEngine(tmod, to_torch(p, device="cpu"),
                                        max_len=64, kv_layout="paged",
                                        device="cpu", **kw))
    jsrv = RoutedServer(jm, jreg, max_batch=4, executor=executor,
                        prefill_tokens_per_step=budget)
    tsrv = tserve.RoutedServer(tm, treg, max_batch=4, executor=executor,
                               prefill_tokens_per_step=budget,
                               check_every=1, device="cpu")
    return jsrv, tsrv, jreg, treg


def _serve_both(jsrv, tsrv, traffic):
    want = jsrv.serve([Request(u, f, p, m) for u, f, p, m in traffic])
    got = tsrv.serve([tserve.Request(u, f, p, m) for u, f, p, m in traffic])
    assert [r.uid for r in got] == [r.uid for r in want]
    for g, w in zip(got, want):
        assert (g.expert, g.fine_class) == (w.expert, w.fine_class), g.uid
        np.testing.assert_array_equal(g.tokens, w.tokens, err_msg=str(g.uid))


def _assert_books(jsrv, tsrv, jreg, treg):
    for e in range(len(treg)):
        js, ts = jreg[e].backend.stats, treg[e].backend.stats
        assert {k: getattr(ts, k) for k in COUNTERS} == \
            {k: getattr(js, k) for k in COUNTERS}, e
        core = treg[e].backend.core
        assert all(getattr(ts, f"{k}_compiles") <= v
                   for k, v in core.executable_bounds().items()), e
        core.pool.check()
        cache_refs = sum(1 for k in core.prefix_cache._lru if k[0] == "pg")
        assert core.pool.used_count(0) == cache_refs
        assert core.pool.telemetry() == jreg[e].backend.core.pool.telemetry()
    ss, js = tsrv.scheduler.stats, jsrv.scheduler.stats
    assert (ss.kv_stalls, ss.batches) == (js.kv_stalls, js.batches)
    assert ss.invariant_checks > 0
    snap = tsrv.snapshot()
    assert snap["kv"]["shard0"] == treg[0].backend.core.pool.telemetry()


def _cohorts(fleet, rng, uid0):
    """Two cohorts of four clients (a shared 24-token prefix plus 4-6
    own tokens; one client repeats another's prompt exactly) and a
    duplicate pair of 60-token prompts whose decode wraps into its
    prompt pages. A cohort shares one fingerprint, so it routes to one
    expert together."""
    feats = fleet[6]
    traffic = []
    for c in range(2):
        head = rng.integers(0, 300, size=24)
        prompts = [np.concatenate([head, rng.integers(0, 300, size=int(n))])
                   for n in rng.integers(4, 7, size=3)]
        prompts.append(prompts[1].copy())
        for p in prompts:
            traffic.append((uid0 + len(traffic), feats[c][c], p.astype(
                np.int32), int(rng.integers(3, 7))))
    long = rng.integers(0, 300, size=60).astype(np.int32)
    for _ in range(2):
        traffic.append((uid0 + len(traffic), feats[0][5], long, 6))
    return traffic


@pytest.mark.parametrize("executor", ["serial", "overlapped"])
def test_prefix_sharing_and_cow_match_reference(fleet, executor):
    jsrv, tsrv, jreg, treg = _servers(fleet, executor)
    rng = np.random.default_rng(3)
    first = _cohorts(fleet, rng, 0)
    _serve_both(jsrv, tsrv, first)
    # the same prompts again with fresh uids: cross-wave prefix hits
    again = [(u + 100, f, p, m) for u, f, p, m in first]
    _serve_both(jsrv, tsrv, again)
    _assert_books(jsrv, tsrv, jreg, treg)
    st = [treg[e].backend.stats for e in range(2)]
    assert sum(s.prefix_dup_rows for s in st) > 0
    assert sum(s.prefix_full_hits for s in st) > 0
    assert sum(s.pages_copied for s in st) > 0


@pytest.mark.parametrize("executor", ["serial", "overlapped"])
def test_chunked_prefill_matches_reference(fleet, executor):
    jsrv, tsrv, jreg, treg = _servers(fleet, executor, budget=16,
                                      chunk_len=16)
    feats = fleet[6]
    rng = np.random.default_rng(11)
    traffic = []
    for u in range(10):
        e = u % 2
        traffic.append((u, feats[e][u], rng.integers(
            0, 300, size=int(rng.integers(1, 61))).astype(np.int32),
            int(rng.integers(1, 7))))
    # a cohort of two-chunk prompts sharing a 16-token head; the second
    # pass keeps the head and changes the tails, so it adopts the cached
    # head and skips chunk 0
    head = rng.integers(0, 300, size=16)
    for u in range(2):
        traffic.append((10 + u, feats[0][3], np.concatenate(
            [head, rng.integers(0, 300, size=14)]).astype(np.int32), 3))
    _serve_both(jsrv, tsrv, traffic)
    _serve_both(jsrv, tsrv, [
        (u + 100, f, np.concatenate([p[:16], p[16:][::-1]])
         if u >= 10 else p, m) for u, f, p, m in traffic])
    _assert_books(jsrv, tsrv, jreg, treg)
    st = [treg[e].backend.stats for e in range(2)]
    assert sum(s.suffix_compiles for s in st) > 0
    assert sum(s.prefix_pages_shared for s in st) > 0
    assert sum(s.prefix_full_hits for s in st) > 0


def test_pool_exhaustion_requeues_like_reference(fleet):
    """A 40-page pool hosts about one long-prompt wave: admissions stall
    (kv_stalls > 0) and requeue, with the reference's tokens."""
    jsrv, tsrv, jreg, treg = _servers(fleet, "overlapped", pool_pages=40)
    feats = fleet[6]
    rng = np.random.default_rng(13)
    traffic = [(u, feats[u % 2][u], rng.integers(
        0, 300, size=int(rng.integers(33, 48))).astype(np.int32),
        int(rng.integers(2, 7))) for u in range(12)]
    _serve_both(jsrv, tsrv, traffic)
    _assert_books(jsrv, tsrv, jreg, treg)
    assert tsrv.scheduler.stats.kv_stalls > 0
