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
  * **step phases and device ranges** — every ``sched.*`` phase, range
    and ``engine.fetch`` resolves its ``parent`` inside its
    ``sched.step``, the phases sum to no more than the step, ranges
    drain in order without waiting on an event (a fake event class),
    ``decode.replay`` / ``verify.replay`` records equal the engines'
    steps, ``first_token_ms`` <= ``total_ms``, and under the CPU profiler
    the spans are host ranges of the same names (function scope);
  * **the static gate** — planted O001/O002/O003 violations are caught
    by ``repro_torch.analysis.obs_lint``, and the compliant idioms pass.

On the card (``-m cuda``): tracer on and off give equal ``host_blocks``
and tokens under captured decode graphs, serial and overlapped, and the
replays' ranges carry device time.
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
from repro_torch.obs.trace import NULL_RANGE
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
        assert 0.0 < a["first_token_ms"] <= a["total_ms"]
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
    assert _by(recs, "decode.replay"), "fallback wave left no decode range"
    assert not _by(recs, "verify.replay")
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


# -- step phases, parents and device ranges ----------------------------------

_PHASES = ("sched.hub", "sched.admit", "sched.chunks", "sched.tick",
           "sched.harvest", "sched.emit")
_RANGES = ("prefill.dispatch", "decode.replay", "verify.replay",
           "ring.swap")


def _mixed_server(model, params, tracer, executor="overlapped"):
    """A ring engine (two waves share a bucket, so they swap) and a
    chunked paged one behind one scheduler."""
    reg = ExpertRegistry()
    reg.add("ring", ExpertEngine(model, params[0], max_len=64,
                                 batch_buckets=(1, 2, 4), device=CPU))
    reg.add("paged", ExpertEngine(model, params[1], max_len=64,
                                  kv_layout="paged", chunk_len=16,
                                  batch_buckets=(1, 2, 4), device=CPU))
    return reg, Scheduler(None, reg, executor=executor, tracer=tracer,
                          config=SchedulerConfig(
                              max_batch=2, prefill_tokens_per_step=16))


def _serve_mixed(model, params, tracer, executor="overlapped"):
    reg, sched = _mixed_server(model, params, tracer, executor)
    rng = np.random.default_rng(21)
    sched.submit(_reqs(rng, 6, n_experts=2, lo=3, hi=40, max_new=(2, 7)))
    out = list(sched.step())
    sched.submit([Request(uid=100 + r.uid, features=r.features,
                          prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                          expert=r.expert)
                  for r in _reqs(rng, 4, n_experts=2, lo=3, hi=12)])
    out += sched.drain()
    return reg, sched, out


@pytest.mark.parametrize("executor", ["serial", "overlapped"])
def test_phase_spans_and_ranges_nest_inside_their_step(model, params2,
                                                       executor):
    """Every phase span, device range and ``engine.fetch`` resolves its
    ``parent`` to a record of its own step; a step's phases take no
    more than the step."""
    tracer = Tracer()
    _serve_mixed(model, params2, tracer, executor)
    recs = tracer.records()
    by_id = {r["id"]: r for r in recs}
    assert len(by_id) == len(recs), "record ids are not unique"
    steps = _by(recs, "sched.step")
    assert steps and all(r["parent"] == 0 for r in steps)
    assert [r["args"]["step"] for r in steps] == list(range(len(steps)))

    def step_of(r):
        while r["name"] != "sched.step":
            assert r["parent"] in by_id, (r["name"], r["parent"])
            r = by_id[r["parent"]]
        return r["id"]

    names = set(_PHASES) | set(_RANGES) | {"engine.fetch"}
    seen = {r["name"] for r in recs if r["name"] in names}
    assert seen >= set(_PHASES) | {"prefill.dispatch", "decode.replay",
                                   "ring.swap", "engine.fetch"}, seen
    for r in recs:
        if r["name"] in names:
            step_of(r)
    for r in recs:
        if r["name"] in _PHASES:
            assert by_id[r["parent"]]["name"] == "sched.step"
    for st in steps:
        kids = [r for r in recs if r["parent"] == st["id"]]
        assert {r["name"] for r in kids} == set(_PHASES)
        assert sum(r["dur"] for r in kids) <= st["dur"]
        a = st["args"]
        assert a["waves_ticked"] >= 0 and a["rows_admitted"] >= 0
    assert sum(r["args"]["rows_admitted"] for r in steps) == 10
    assert sum(r["args"]["responses"] for r in steps) == 10
    for r in recs:
        if r["name"] in _RANGES and r["cat"] != "enqueue":
            assert r["cat"] == "device" and r["tid"] == "cpu"
            assert r["args"]["device_ms"] >= 0.0
            assert r["args"]["enqueue_ms"] >= 0.0
    swaps = _by(recs, "ring.swap")
    assert {r["cat"] for r in swaps} == {"device", "enqueue"}
    assert all(r["args"]["bytes_in"] > 0 for r in swaps)
    pf = _by(recs, "prefill.dispatch")
    assert any("k" in r["args"] for r in pf), "no chunk dispatch range"


def test_replay_ranges_equal_the_engines_steps(model, params2):
    """One ``decode.replay`` record a plain decode step, one
    ``verify.replay`` a verify; their args carry the step's shape; every
    response's ``first_token_ms`` lies within its ``total_ms``."""
    tracer = Tracer()
    reg, sched, out = _serve_mixed(model, params2, tracer)
    assert len(out) == 10
    recs = tracer.records()
    steps = sum(reg[e].backend.stats.decode_steps for e in range(2))
    reps = _by(recs, "decode.replay")
    assert len(reps) == steps > 0
    for r in reps:
        a = r["args"]
        assert 1 <= a["rows"] <= a["Bb"] and 0 <= a["live_rows"] <= a["rows"]
        assert a["slots"] > a["j"] >= 0 and a["position"] == 0
        assert "eager" not in a and "captured" not in a    # CPU: no capture
    pf = _by(recs, "prefill.dispatch")
    assert sum(r["args"]["tokens"] for r in pf) == sum(
        reg[e].backend.stats.prefill_tokens_computed for e in range(2))
    for r in _by(recs, "request.finish"):
        a = r["args"]
        assert 0.0 < a["first_token_ms"] <= a["total_ms"]

    spec = ExpertEngine(model, params2[0], max_len=32, speculate_k=2,
                        draft="table", device=CPU)
    tracer = Tracer()
    spec.bind_tracer(tracer)
    p = np.random.default_rng(5).integers(0, 100, size=6).astype(np.int32)
    spec.admit([0, 1], [p, p.copy()], [6, 4])
    while spec.has_pending:
        spec.tick()
        spec.poll()
    recs = tracer.records()
    assert spec.stats.verify_steps > 0
    assert len(_by(recs, "verify.replay")) == spec.stats.verify_steps
    assert not _by(recs, "decode.replay")


class _FakeEvent:
    """A CUDA event stand-in: completes when the test says so, and fails
    the test if anything reads its time before ``query()`` said True."""

    made = 0

    def __init__(self):
        type(self).made += 1
        self.t = None
        self.done = False
        self.asked = False

    def record(self, stream=None):
        self.t = _FakeEvent.clock
        _FakeEvent.clock += 1.0
        self.done, self.asked = False, False

    def query(self):
        self.asked = self.done
        return self.done

    def elapsed_time(self, other):
        assert self.asked and other.asked, "elapsed_time before query()"
        return other.t - self.t

    def synchronize(self):
        raise AssertionError("the tracer waited on an event")


_FakeEvent.clock = 0.0


class _FakeCudaTracer(Tracer):
    def _new_event(self, dev):
        return _FakeEvent()

    def _stream(self, dev):
        return None


def test_device_ranges_drain_in_order_without_waiting():
    """Ranges fold in enqueue order, stopping at the first whose events
    have not completed; no event's time is read before ``query()`` said
    so; folded events are reused; a disabled tracer allocates none."""
    dev = torch.device("cuda", 0)
    off = _FakeCudaTracer(enabled=False)
    made = _FakeEvent.made
    with off.device_range("decode.replay", device=dev) as r:
        pass
    assert r is NULL_RANGE and off.collect() == 0
    assert off.records() == [] and _FakeEvent.made == made

    tr = _FakeCudaTracer()
    anchor = _FakeEvent()
    anchor.record()
    anchor.done = True
    tr._anchor[dev] = [anchor, 100.0, False]
    rs = []
    with tr.span("sched.tick") as tick:
        for i in range(3):
            with tr.device_range("decode.replay", device=dev, j=i) as r:
                pass
            rs.append(r)
    assert _FakeEvent.made == made + 1 + 6
    for ev in (rs[0].ev0, rs[0].ev1, rs[2].ev0, rs[2].ev1):
        ev.done = True
    assert tr.collect() == 1               # range 1 blocks range 2
    assert [r["args"]["j"] for r in tr.records()
            if r["name"] == "decode.replay"] == [0]
    rs[1].ev0.done = rs[1].ev1.done = True
    assert tr.collect() == 2
    got = [r for r in tr.records() if r["name"] == "decode.replay"]
    assert [r["args"]["j"] for r in got] == [0, 1, 2]
    for r in got:
        assert r["tid"] == "cuda:0" and r["cat"] == "device"
        assert r["parent"] == tick.id
        assert r["args"]["device_ms"] == 1.0    # one fake ms a mark
        assert r["ts"] >= (100.0 - tr._epoch) * 1e6
    # the six events went back to the free list: no new ones
    with tr.device_range("decode.replay", device=dev):
        pass
    assert _FakeEvent.made == made + 1 + 6


def test_profiler_sees_the_spans_as_record_functions(model, params2):
    """Under ``torch.profiler`` each traced span and range enqueue is a
    host range of the same name, of the profiler's function scope (a
    user-scope ``record_function`` would also put a device range around
    its kernels into a CUDA trace); with the tracer off none is."""
    from torch.profiler import ProfilerActivity, profile
    names = {"sched.step", "sched.tick", "sched.admit", "decode.replay",
             "prefill.dispatch", "engine.fetch"}
    for tracer, want in ((Tracer(), names), (None, set())):
        reg, sched = _mixed_server(model, params2, tracer)
        sched.submit(_reqs(np.random.default_rng(4), 4, n_experts=2))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            sched.drain()
        got = {e.key for e in prof.key_averages()}
        assert got & names == want, got & names
        assert not any("GraphLaunch" in n for n in got & names)
        user = {e.name for e in prof.events()
                if e.name in names and e.scope != 0}
        assert not user, user


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


@pytest.mark.parametrize("line", [
    'tracer.device_range("decode.replay")',
    "tracer.collect()"])
def test_obs_lint_catches_device_range_in_captured_body(line):
    """A range opened, or ranges collected, inside a captured body would
    record or query events once, at capture."""
    src = textwrap.dedent(_CAPTURED.format(line=line))
    vs = obs_lint.lint_source(src, "src/repro_torch/serve/planted.py")
    assert any(v.rule == "O001" and v.func == "step" for v in vs), vs


def test_obs_lint_tracer_outside_captured_body_passes():
    src = textwrap.dedent("""
        class DecodeGraph:
            def _body(self):
                self.out.copy_(self.tok + 1)

        def tick(graph, tracer):
            tracer.event("tick")     # host code around the replay
            with tracer.device_range("decode.replay", device=graph.dev):
                graph._body()
            tracer.collect()
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
    host blocks and tokens: device spans ride the engine's syncs, and
    device ranges are folded only once their events have completed. Every
    replay's range carries device time, on the card's clock put on the
    tracer's."""
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
    torch.cuda.synchronize()
    recs = tracer.records()
    assert len(_by(recs, "request.finish")) == 10
    reps = _by(recs, "decode.replay")
    assert reps and all(r["args"]["device_ms"] > 0 for r in reps)
    assert all(r["tid"] == f"cuda:{dev.index}" for r in reps)
    assert any(r["args"].get("captured") for r in reps)
    steps = [r for r in reps
             if not r["args"].get("eager") and not r["args"].get("captured")]
    assert steps, "no replay was timed"
    # one clock: a replay starts on the card after the host began the
    # tick that enqueued it (within the anchor's error)
    by_id = {r["id"]: r for r in recs}
    for r in reps:
        tick = by_id[r["parent"]]
        assert tick["name"] == "sched.tick"
        assert r["ts"] >= tick["ts"] - 500.0
    fin = _by(recs, "request.finish")
    assert all(0 < r["args"]["first_token_ms"] <= r["args"]["total_ms"]
               for r in fin)
    sched = [r for r in recs if r["name"] == "sched.step"]
    assert all(k in sched[-1]["args"] for k in
               ("num_alloc_retries", "num_sync_all_streams",
                "num_device_alloc", "num_device_free"))
