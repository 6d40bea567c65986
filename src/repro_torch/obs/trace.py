"""Request-lifecycle tracing for the serving mesh.

Design constraints, in order:

1. **Zero new host blocks.** Device work (prefill / decode / verify
   dispatches) is timed with ``begin_device``/``end_device`` handle
   pairs. ``end_device`` is only ever called from the engine's existing
   sync point (``EngineCore._materialize``, which copies the token
   planes to the host and bumps ``EngineStats.host_blocks``) — the
   tracer itself never syncs, so a device span measures *the same*
   enqueue→harvest interval the serving stack already pays for.

2. **One clock read per edge.** A ``span`` reads ``perf_counter`` once
   at enter and once at exit, and exposes the elapsed ``.ms`` so call
   sites that also feed their own stats (e.g. ``HubStats.stage_ms``)
   reuse the measurement instead of reading the clock again. Spans
   *always* measure, even on a disabled tracer — recording is what
   enabling toggles — so stats stay populated when tracing is off.

3. **No dependencies.** Pure stdlib; importable from any layer and
   from tests without torch.

Span taxonomy (the names the exporter and the bench's stage-breakdown
join rely on — see docs/architecture.md "Observability"):

=====================  ====  =======================================
name                   ph    emitted by
=====================  ====  =======================================
``request.submit``     i     ``Scheduler.submit`` (mints trace id)
``route``              X     scheduler, around ``Router.route``
``request.admit``      i     scheduler, per admitted dispatch group
``hub.park``           i     scheduler, rows parked on ``NotResident``
``hub.stage``          X     hub worker/inline, checkpoint → host
``hub.commit``         X     hub, host → device slot install (enqueue)
``kv.requeue``         i     scheduler, ``PagePoolExhausted`` rollback
``wave.prefill``       X     engine, admit enqueue → harvest sync
``wave.chunk``         i     engine, one chunked-prefill dispatch
``wave.decode``        X     engine, decode tick(s) → harvest sync
``wave.verify``        X     engine, speculative verify → harvest sync
``spec.fallback``      i     engine, wave gated to plain decode
``request.finish``     i     scheduler harvest (per response)
=====================  ====  =======================================
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional


class _Span:
    """Live span handle (context manager).

    Always measures — one ``perf_counter`` read at enter, one at exit —
    and publishes the elapsed milliseconds as ``.ms`` so the call site
    can fold the same measurement into its own stats. The record is
    appended to the tracer only when recording is enabled. An exception
    propagating out of the body still closes the span (with an
    ``error`` attribute) so span balance holds under rollback paths.
    """

    __slots__ = ("_tracer", "name", "cat", "args", "t0", "ms")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = 0.0
        self.ms = 0.0

    def set(self, **attrs: Any) -> "_Span":
        self.args.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, etype, evalue, tb) -> bool:
        t1 = time.perf_counter()
        self.ms = (t1 - self.t0) * 1e3
        if etype is not None:
            self.args.setdefault("error", etype.__name__)
        if self._tracer.enabled:
            self._tracer._append(self.name, self.cat, "X", self.t0,
                                 t1 - self.t0, self.args)
        return False


class _DeviceSpan:
    """Open device-work handle: begun at enqueue, ended at a sync site."""

    __slots__ = ("name", "args", "t0", "tid")

    def __init__(self, name: str, args: Dict[str, Any], t0: float,
                 tid: str):
        self.name = name
        self.args = args
        self.t0 = t0
        self.tid = tid


class Tracer:
    """Thread-safe span/event recorder with Chrome + JSONL export.

    One tracer serves the whole mesh: the scheduler thread, the hub's
    stager thread and (in tests) arbitrary callers append under one
    lock. Timestamps are microseconds relative to the tracer's epoch,
    which is what the Chrome ``trace_event`` format wants.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._epoch = time.perf_counter()
        self._lock = threading.Lock()
        self._records: List[Dict[str, Any]] = []
        self._seq = 0
        self._uid_trace: Dict[Any, int] = {}
        self._open: Dict[int, _DeviceSpan] = {}

    # -- clock / ids ---------------------------------------------------
    def now(self) -> float:
        """The tracer's clock (``perf_counter`` seconds) — call sites
        that stamp their own timestamps use this so every number in a
        trace shares one time base."""
        return time.perf_counter()

    def next_id(self) -> int:
        """Mint a fresh id (request traces, wave ids) — monotonic,
        unique across threads."""
        with self._lock:
            self._seq += 1
            return self._seq

    def bind_uid(self, uid: Any, trace: int) -> None:
        """Associate a request uid with its trace id so layers that only
        see uids (the engine core) can label spans without threading
        trace ids through every call signature."""
        if not self.enabled:
            return
        with self._lock:
            self._uid_trace[uid] = trace

    def trace_of(self, uid: Any) -> int:
        with self._lock:
            return self._uid_trace.get(uid, 0)

    def release_uid(self, uid: Any) -> None:
        with self._lock:
            self._uid_trace.pop(uid, None)

    # -- spans ---------------------------------------------------------
    def span(self, name: str, /, **attrs: Any) -> _Span:
        """Host-work span. Must NOT wrap bare device dispatch — rule
        O002 flags that; use ``begin_device``/``end_device`` (completion
        semantics) or ``enqueue_span`` (explicit enqueue semantics)."""
        return _Span(self, name, "host", attrs)

    def enqueue_span(self, name: str, /, **attrs: Any) -> _Span:
        """A span that *deliberately* measures device-work enqueue, not
        completion — e.g. the hub's jitted slot install, whose cost
        model is 'time until the scheduler may proceed'. The ``enqueue``
        category marks the semantics in the exported trace, and O002
        exempts it (the rule exists to catch *accidental* enqueue
        timing)."""
        return _Span(self, name, "enqueue", attrs)

    def event(self, name: str, /, **attrs: Any) -> None:
        """Instant event (Chrome ``ph: i``)."""
        if not self.enabled:
            return
        t = time.perf_counter()
        self._append(name, "host", "i", t, 0.0, attrs)

    # -- device-work handles -------------------------------------------
    def begin_device(self, name: str, /, **attrs: Any
                     ) -> Optional[_DeviceSpan]:
        """Open a device-work span at enqueue time. Returns ``None``
        when disabled (``end_device(None)`` is a no-op), so call sites
        stay unconditional."""
        if not self.enabled:
            return None
        h = _DeviceSpan(name, attrs, time.perf_counter(),
                        threading.current_thread().name)
        with self._lock:
            self._open[id(h)] = h
        return h

    def end_device(self, handle: Optional[_DeviceSpan],
                   **attrs: Any) -> None:
        """Close a device-work span. Callers must already be at a sync
        site (they contain a ``device_get``/``block_until_ready``) —
        rule O002 checks this statically; the tracer never syncs."""
        if handle is None:
            return
        t1 = time.perf_counter()
        handle.args.update(attrs)
        with self._lock:
            self._open.pop(id(handle), None)
        self._append(handle.name, "device", "X", handle.t0,
                     t1 - handle.t0, handle.args, tid=handle.tid)

    def open_device_count(self) -> int:
        """Device spans begun but not yet ended — 0 after a full drain
        (the span-balance invariant the tests assert, including across
        ``PagePoolExhausted`` rollback and speculative fallback)."""
        with self._lock:
            return len(self._open)

    # -- storage / export ----------------------------------------------
    def _append(self, name: str, cat: str, ph: str, t0: float,
                dur_s: float, args: Dict[str, Any],
                tid: Optional[str] = None) -> None:
        rec = {"name": name, "cat": cat, "ph": ph,
               "ts": (t0 - self._epoch) * 1e6,
               "dur": dur_s * 1e6,
               "tid": tid or threading.current_thread().name,
               "args": args}
        with self._lock:
            self._records.append(rec)

    def records(self) -> List[Dict[str, Any]]:
        """A snapshot copy of all records (JSONL-shaped dicts)."""
        with self._lock:
            return [dict(r) for r in self._records]

    def clear(self) -> None:
        with self._lock:
            self._records.clear()

    def export_chrome(self, path: str) -> int:
        """Write Chrome ``trace_event`` JSON (open in chrome://tracing
        or Perfetto). Returns the number of events written."""
        recs = self.records()
        tids: Dict[str, int] = {}
        events: List[Dict[str, Any]] = []
        for r in recs:
            tid = tids.setdefault(r["tid"], len(tids) + 1)
            ev: Dict[str, Any] = {"name": r["name"], "cat": r["cat"],
                                  "ph": r["ph"], "pid": 1, "tid": tid,
                                  "ts": r["ts"], "args": r["args"]}
            if r["ph"] == "X":
                ev["dur"] = r["dur"]
            else:
                ev["s"] = "t"
            events.append(ev)
        meta = [{"name": "thread_name", "ph": "M", "pid": 1, "tid": t,
                 "args": {"name": n}} for n, t in sorted(
                     tids.items(), key=lambda kv: kv[1])]
        with open(path, "w") as fh:
            json.dump({"traceEvents": meta + events,
                       "displayTimeUnit": "ms"}, fh, default=str)
        return len(events)

    def export_jsonl(self, path: str) -> int:
        """One record per line — greppable (``grep '"trace": 42'``)."""
        recs = self.records()
        with open(path, "w") as fh:
            for r in recs:
                fh.write(json.dumps(r, default=str))
                fh.write("\n")
        return len(recs)


#: Shared disabled tracer — the default binding everywhere, so serving
#: code calls ``self.tracer.event(...)`` unconditionally and never
#: branches on "is tracing on". ``span``s on it still measure (stats
#: consumers keep their numbers); nothing is recorded.
NULL_TRACER = Tracer(enabled=False)
