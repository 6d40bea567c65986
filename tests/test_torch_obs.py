"""The port's observability contract (``repro_torch.obs`` through the
port's scheduler, engine and hub), held to ``tests/test_obs.py``'s
lifecycle cases on reduced ``smollm-135m`` on the CPU:

  * **propagation** — a trace id minted at ``Scheduler.submit`` follows
    the request through the hub's park, stage and commit to
    ``request.finish``;
  * **span balance** — every ``begin_device`` handle is closed once
    traffic drains, across the ``PagePoolExhausted`` requeue and the
    speculative no-wrap fallback;
  * **zero new host blocks** — ``EngineStats.host_blocks`` and the tokens
    are the same with the tracer on and off (device spans close only
    inside the engine's existing syncs);
  * **snapshot stability** — ``snapshot()``'s tree keys;
  * **the static gate** — planted O001/O002/O003 violations are caught
    by ``repro_torch.analysis.obs_lint``, and the compliant idioms pass.

On the card (``-m cuda``): tracer on and off give equal ``host_blocks``
and tokens under captured decode graphs, serial and overlapped.
"""
import textwrap

import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.analysis import obs_lint
from repro_torch.configs import get_config
from repro_torch.core import ExpertRegistry
from repro_torch.models import build_model
from repro_torch.obs import Tracer
from repro_torch.serve import (ExpertEngine, ExpertHub, Request, RoutedServer,
                               Scheduler, SchedulerConfig, SchedulerStats)

CPU = "cpu"


@pytest.fixture(scope="module")
def model():
    return build_model(get_config("smollm-135m").reduced(name="obs-t"))


@pytest.fixture(scope="module")
def params2(model):
    return [model.init(s, device=CPU) for s in range(2)]


def _reqs(rng, n, n_experts, lo=3, hi=28, max_new=(1, 5)):
    return [Request(uid=u, features=np.zeros(784, np.float32),
                    prompt=rng.integers(0, 50,
                                        size=int(rng.integers(lo, hi))),
                    max_new_tokens=int(rng.integers(*max_new)),
                    expert=int(u % n_experts))
            for u in range(n)]


def _by(recs, name):
    return [r for r in recs if r["name"] == name]


# -- propagation: park -> stage -> commit -> serve ---------------------------


def test_trace_id_propagates_through_hub_lifecycle(tmp_path, model,
                                                   params2):
    """One trace id per request, minted at submit, visible in the hub's
    park / stage / commit records, the engine's device spans and the
    finish event."""
    store = str(tmp_path / "store")
    hub = ExpertHub(model, n_slots=1, max_len=32, store=store, device=CPU)
    for i, p in enumerate(params2):
        hub.add_expert(f"ex{i}", p, cold=True)
    tracer = Tracer()
    srv = RoutedServer(None, hub.build_registry(), max_batch=4, hub=hub,
                       tracer=tracer, device=CPU)
    try:
        resps = srv.serve(_reqs(np.random.default_rng(3), 6, n_experts=2))
    finally:
        hub.close()
    assert len(resps) == 6
    assert srv.scheduler.stats.resident_stalls >= 1   # cold start parked

    recs = tracer.records()
    trace_of = {r["args"]["uid"]: r["args"]["trace"]
                for r in _by(recs, "request.submit")}
    assert sorted(trace_of) == list(range(6))
    assert len(set(trace_of.values())) == 6 and 0 not in trace_of.values()
    parked = {t for r in _by(recs, "hub.park") for t in r["args"]["traces"]}
    assert parked and parked <= set(trace_of.values())
    assert _by(recs, "hub.stage"), "cold staging left no stage span"
    assert all(r["ph"] == "X" and r["dur"] > 0
               for r in _by(recs, "hub.stage"))
    commits = _by(recs, "hub.commit")
    assert commits and all(r["cat"] == "enqueue" for r in commits)
    waved = {t for r in _by(recs, "wave.prefill")
             for t in r["args"]["traces"]}
    finishes = _by(recs, "request.finish")
    assert {r["args"]["uid"] for r in finishes} == set(range(6))
    for r in finishes:
        a = r["args"]
        assert a["trace"] == trace_of[a["uid"]]
        assert a["total_ms"] >= a["queue_ms"] >= 0.0
        assert a["stalled_ms"] >= 0.0
    assert parked & waved            # submit -> park -> prefill -> finish
    assert any(r["args"]["stalled_ms"] > 0.0 for r in finishes)
    assert tracer.open_device_count() == 0
    snap = srv.snapshot()
    ex = snap["hub"]["experts"]
    assert set(ex) == {"ex0", "ex1"}
    for row in ex.values():
        assert {"hits", "state", "pins", "misses", "stage_ms",
                "commit_ms", "resident_s"} <= set(row)
    assert any(row["stage_ms"] > 0 for row in ex.values())
    assert snap["scheduler"]["latency"]["queue_ms"]["count"] == 6


# -- span balance under the rollback paths -----------------------------------


def test_span_balance_under_pool_exhaustion(model, params2):
    """``PagePoolExhausted`` requeues leak no device span (it opens only
    after admission succeeds) and leave a ``kv.requeue`` record carrying
    the stalled rows' trace ids."""
    reg = ExpertRegistry()
    reg.add("ex0", ExpertEngine(model, params2[0], max_len=64,
                                kv_layout="paged", pool_pages=40,
                                device=CPU))
    tracer = Tracer()
    sched = Scheduler(None, reg, config=SchedulerConfig(max_batch=4),
                      tracer=tracer)
    rng = np.random.default_rng(11)
    # 4-row waves of 33-48 token prompts own ~24 of 40 pages: wave two
    # cannot admit while wave one is resident -> the stall path fires
    reqs = [Request(uid=u, features=np.zeros(784, np.float32),
                    prompt=rng.integers(0, 100,
                                        size=int(rng.integers(33, 48))),
                    max_new_tokens=int(rng.integers(2, 7)), expert=0)
            for u in range(12)]
    sched.submit(reqs)
    assert len(sched.drain()) == 12
    assert sched.stats.kv_stalls >= 1, "the pool never stalled"
    recs = tracer.records()
    requeues = _by(recs, "kv.requeue")
    assert requeues
    submit_traces = {r["args"]["trace"]
                     for r in _by(recs, "request.submit")}
    assert all(set(r["args"]["traces"]) <= submit_traces
               for r in requeues)
    assert tracer.open_device_count() == 0
    dev = [r for r in recs if r["cat"] == "device"]
    assert len(dev) >= len(_by(recs, "wave.prefill"))
    kv = sched.obs.snapshot()["kv"]["shard0"]
    assert kv["exhausted"] >= 1
    assert kv["page_allocs"] > kv["used"] >= 0


def test_span_balance_under_spec_fallback(model, params2):
    """A speculative wave demoted to plain decode by the no-wrap gate
    stays balanced and leaves one ``spec.fallback`` event."""
    eng = ExpertEngine(model, params2[0], kv_layout="paged", page_size=8,
                       speculate_k=4, draft="table", max_len=16,
                       min_len_bucket=8, batch_buckets=(1, 2), device=CPU)
    tracer = Tracer()
    eng.bind_tracer(tracer)
    p = np.random.default_rng(5).integers(0, 100, size=8).astype(np.int32)
    # Sb + steps = 17 > C = 16 trips the gate -> plain-decode fallback
    eng.admit([0, 1], [p, p.copy()], [10, 10])
    while eng.has_pending:
        eng.tick()
        eng.poll()
    assert eng.stats.spec_fallback_waves == 1
    assert eng.stats.verify_steps == 0
    recs = tracer.records()
    fb = _by(recs, "spec.fallback")
    assert len(fb) == 1
    assert _by(recs, "wave.decode"), "fallback wave left no decode span"
    assert not _by(recs, "wave.verify")
    assert tracer.open_device_count() == 0
    assert fb[0]["args"]["wave"] in {r["args"]["wave"]
                                     for r in _by(recs, "wave.prefill")}


# -- zero new host blocks ----------------------------------------------------


def _serve_traced(model, params, reqs, tracer, dev, executor="overlapped"):
    reg = ExpertRegistry()
    for i, p in enumerate(params):
        reg.add(f"ex{i}", ExpertEngine(model, p, max_len=32, device=dev))
    sched = Scheduler(None, reg, executor=executor, tracer=tracer)
    sched.submit(reqs)
    out = {r.uid: r.tokens for r in sched.drain()}
    blocks = sum(reg[e].backend.stats.host_blocks for e in range(len(params)))
    return out, blocks


def test_host_blocks_identical_with_tracing_on(model, params2):
    """The same traffic with and without a live tracer makes exactly the
    same host-blocking syncs and the same tokens."""
    reqs = _reqs(np.random.default_rng(7), 10, n_experts=2)
    got_off, blocks_off = _serve_traced(model, params2, reqs, None, CPU)
    tracer = Tracer()
    got_on, blocks_on = _serve_traced(model, params2, reqs, tracer, CPU)
    assert blocks_on == blocks_off > 0
    for uid in got_off:
        np.testing.assert_array_equal(got_on[uid], got_off[uid],
                                      err_msg=str(uid))
    assert tracer.open_device_count() == 0
    assert len(_by(tracer.records(), "request.finish")) == 10


# -- snapshot tree stability -------------------------------------------------


def test_snapshot_tree_keys_are_stable(model, params2):
    """The tree's top-level groups and per-group leaf names, as the
    reference pins them."""
    reg = ExpertRegistry()
    reg.add("ex0", ExpertEngine(model, params2[0], max_len=32,
                                kv_layout="paged", speculate_k=2,
                                draft="table", device=CPU))
    sched = Scheduler(None, reg)
    rng = np.random.default_rng(0)
    sched.submit(_reqs(rng, 4, n_experts=1, lo=3, hi=12))
    sched.drain()
    snap = sched.obs.snapshot()
    assert sorted(snap) == ["engines", "executor", "kv", "scheduler"]
    assert set(snap["scheduler"]) == set(SchedulerStats().as_dict()) \
        | {"latency"}
    assert snap["scheduler"]["responses"] == 4
    for h in ("queue_ms", "stalled_ms"):
        assert set(snap["scheduler"]["latency"][h]) == \
            {"count", "sum", "mean", "p50", "p95", "p99", "max"}
    assert snap["scheduler"]["latency"]["queue_ms"]["count"] == 4
    eng = snap["engines"]["shard0"]
    assert {"host_blocks", "decode_steps", "spec_fallback_waves"} <= \
        set(eng)
    assert eng["draft"] == {"name": "table", "kind": "BigramTableDraft"}
    assert set(snap["kv"]["shard0"]) == {"free", "used", "page_allocs",
                                         "page_releases", "exhausted"}
    assert snap["executor"]["name"] in ("serial", "overlapped")
    held = sched.stats
    sched.submit(_reqs(rng, 2, n_experts=1, lo=3, hi=12))
    sched.drain()
    assert held.responses == 4 and sched.stats.responses == 6
    with pytest.raises(AttributeError):
        held.responses = 0


# -- the static gate: planted O001-O003 violations ---------------------------

_CAPTURED = """
    class DecodeGraph:
        def _body(self):
            self.out.copy_(step(self.tok, self.core.tracer))

    def step(tok, tracer):
        {line}
        return tok + 1
"""


def test_obs_lint_catches_tracer_call_in_captured_body():
    src = textwrap.dedent(_CAPTURED.format(line='tracer.event("tick")'))
    vs = obs_lint.lint_source(src, "src/repro_torch/serve/planted.py")
    assert any(v.rule == "O001" and v.func == "step" for v in vs), vs
    # a metric update there is as silent: it counts the capture only
    src = textwrap.dedent(_CAPTURED.format(line="counter.inc()"))
    vs = obs_lint.lint_source(src, "src/repro_torch/serve/planted.py")
    assert any(v.rule == "O001" for v in vs), vs


def test_obs_lint_tracer_outside_captured_body_passes():
    src = textwrap.dedent("""
        class DecodeGraph:
            def _body(self):
                self.out.copy_(self.tok + 1)

        def tick(graph, tracer):
            tracer.event("tick")     # host code around the replay
            graph._body()
    """)
    vs = obs_lint.lint_source(src, "src/repro_torch/serve/planted.py")
    assert not [v for v in vs if v.rule == "O001"], vs


def test_obs_lint_catches_unsynced_device_span():
    src = textwrap.dedent("""
        import torch

        def prefill(tracer, a, b):
            with tracer.span("wave.prefill"):
                out = torch.matmul(a, b)     # enqueued, not finished
            return out
    """)
    vs = obs_lint.lint_source(src, "src/repro_torch/serve/planted.py")
    assert any(v.rule == "O002" for v in vs), vs
    src = textwrap.dedent("""
        def tick(self, w):
            self.tracer.end_device(w.sp_decode)   # no sync in sight
    """)
    vs = obs_lint.lint_source(src, "src/repro_torch/serve/planted.py")
    assert any(v.rule == "O002" for v in vs), vs


def test_obs_lint_synced_and_enqueue_spans_pass():
    src = textwrap.dedent("""
        import torch

        def prefill(tracer, a, b):
            with tracer.span("wave.prefill"):
                out = torch.matmul(a, b)
                torch.cuda.synchronize()
            with tracer.enqueue_span("hub.commit"):
                torch.matmul(a, b)           # enqueue is the measurement
            return out

        def materialize(self, w):
            host = self._fetch(w.planes)     # the engine's host wait
            self.tracer.end_device(w.sp_decode)
            return host
    """)
    vs = obs_lint.lint_source(src, "src/repro_torch/serve/planted.py")
    assert not [v for v in vs if v.rule == "O002"], vs


def test_obs_lint_catches_computed_histogram_buckets():
    src = textwrap.dedent("""
        from repro_torch.obs import Histogram

        LAT_BUCKETS = (1.0, 10.0, 100.0)

        def make(n):
            ok1 = Histogram(buckets=(0.5, 5.0, 50.0))
            ok2 = Histogram(LAT_BUCKETS)
            ok3 = Histogram()
            bad = Histogram(buckets=tuple(2.0 ** i for i in range(n)))
            return ok1, ok2, ok3, bad
    """)
    vs = obs_lint.lint_source(src, "src/repro_torch/obs/planted.py")
    assert [v.rule for v in vs] == ["O003"], vs


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("executor", ["serial", "overlapped"])
def test_cuda_host_blocks_identical_with_tracing_on(cuda, model, executor):
    """Under captured decode graphs, the tracer on and off give the same
    host blocks and tokens: device spans ride the engine's syncs."""
    dev = cuda
    params = [model.init(s, device=dev) for s in range(2)]
    reqs = _reqs(np.random.default_rng(7), 10, n_experts=2)
    got_off, blocks_off = _serve_traced(model, params, reqs, None, dev,
                                        executor)
    tracer = Tracer()
    got_on, blocks_on = _serve_traced(model, params, reqs, tracer, dev,
                                      executor)
    assert blocks_on == blocks_off > 0
    for uid in got_off:
        np.testing.assert_array_equal(got_on[uid], got_off[uid],
                                      err_msg=str(uid))
    assert tracer.open_device_count() == 0
    assert len(_by(tracer.records(), "request.finish")) == 10
