"""Request-lifecycle tracing for the serving mesh.

Design constraints, in order:

1. **Zero new host blocks.** Device work is timed two ways, neither of
   which syncs. ``begin_device``/``end_device`` handle pairs measure
   enqueue to the engine's existing sync point (``end_device`` is only
   ever called from ``EngineCore._materialize``, which copies the token
   planes to the host and bumps ``EngineStats.host_blocks``).
   ``device_range`` records a pair of CUDA events on the current stream
   around an enqueue; ``collect`` folds the ranges whose end event has
   completed (``query()``), in order, and never waits on one. On the
   CPU a range times the host, which is correct there: CPU work is
   synchronous.

2. **One clock read per edge.** A ``span`` reads ``perf_counter`` once
   at enter and once at exit, and exposes the elapsed ``.ms`` so call
   sites that also feed their own stats (e.g. ``HubStats.stage_ms``)
   reuse the measurement instead of reading the clock again. Spans
   *always* measure, even on a disabled tracer — recording is what
   enabling toggles — so stats stay populated when tracing is off. A
   disabled tracer's ``device_range`` is one shared null context: it
   allocates no events and reads no clock.

3. **No dependencies.** Pure stdlib at import; importable from any
   layer and from tests without torch. Device ranges, the per-device
   clock anchor and the profiler tie import torch when first used.

4. **One tree, one clock.** Every record carries an ``id`` and the
   ``parent``: the id of the host span open on the same thread when it
   began (0 at the top). Device timestamps are put on the tracer's clock
   through one anchor event a device (``anchor``, recorded right after
   a ``torch.cuda.synchronize()``). While ``torch.profiler`` runs, every
   host span and every range's enqueue is also a host range of the
   profiler's of the same name (function scope, so it adds no device
   range to the trace), and the profiler's trace nests its own
   operations under the program's phases. No name may contain
   ``GraphLaunch``: profiler readers count graph launches by it.

Span taxonomy (the names the exporter and the benchmark's readers rely
on). ``ph`` X is a span, i an instant; ``cat`` is ``host``, ``enqueue``
(host time of a phase that enqueues device work: the time until the host
may go on) or ``device``:

=====================  ===========  ======================================
name                   ph / cat     emitted by
=====================  ===========  ======================================
``request.submit``     i host       ``Scheduler.submit`` (mints trace id)
``route``              X host       scheduler, around ``Router.route``
``request.admit``      i host       scheduler, per admitted dispatch group
``hub.park``           i host       scheduler, rows parked on
                                    ``NotResident``
``hub.stage``          X host       hub worker/inline, checkpoint → host
``hub.commit``         X enqueue    hub, host → device slot install
``kv.requeue``         i host       scheduler, ``PagePoolExhausted``
                                    rollback
``sched.step``         X enqueue    ``Scheduler.step``: args ``step``,
                                    ``waves_ticked``, ``replays`` (the
                                    engines' step graph replays),
                                    ``rows_admitted``,
                                    ``responses``; on CUDA the step's
                                    deltas of the allocator's
                                    ``num_alloc_retries``,
                                    ``num_sync_all_streams``,
                                    ``num_device_alloc``,
                                    ``num_device_free``
``sched.hub``          X enqueue    executor: the hub's round
``sched.admit``        X enqueue    executor: admission and prefill
``sched.chunks``       X enqueue    executor: pending prefill chunks
``sched.tick``         X enqueue    executor: every shard's decode tick
``sched.harvest``      X enqueue    executor: the engines' harvests
``sched.emit``         X enqueue    scheduler: poll, responses
``engine.fetch``       X host       ``EngineCore._fetch``: the host's
                                    wait on the device (CPU: the copy)
``ring.swap``          X enqueue    ``_StepGraph._make_resident``:
                                    host time of a ring swap's copies;
                                    ``RowSlots``: of a group swap, of a
                                    wave's slot installs
                                    (``rows_installed``) or of a
                                    packing's moves (``rows_moved``)
``ring.swap``          X device     the same copies on the device: args
                                    ``bytes_out``, ``bytes_in``
``prefill.dispatch``   X device     engine, each prefill / chunk: args
                                    ``wave``, ``Bb``, ``Sb`` or chunk
                                    ``k``, ``rows``, ``tokens``
``decode.replay``      X device     ``DecodeGraph.step`` (copy-in to the
                                    clone): args ``engine``,
                                    ``position``, ``wave``, ``waves``,
                                    ``Bb``, ``rows``, ``live_rows``,
                                    ``slots``, ``j``; a row group's
                                    (``step_group``) ``engine``,
                                    ``position``, ``Bb``, ``waves`` (the
                                    waves it carries), ``rows`` (its
                                    decoding rows); ``eager`` /
                                    ``captured`` on a bucket's first two
                                    steps under capture
``verify.replay``      X device     ``VerifyGraph.step``, as above
``wave.prefill``       X device     engine, admit enqueue → harvest sync
``wave.chunk``         i host       engine, one chunked-prefill dispatch
``spec.fallback``      i host       engine, wave gated to plain decode
``request.finish``     i host       scheduler harvest (per response);
                                    ``first_token_ms``: submit to the
                                    device end of the prefill range that
                                    made the row's first token
=====================  ===========  ======================================

A range's record has ``tid`` ``cuda:<index>`` (``cpu`` on the CPU), its
device interval as ``ts``/``dur``, and args ``device_ms`` and
``enqueue_ms`` (host time of the enqueue).
"""
from __future__ import annotations

import collections
import itertools
import json
import sys
import threading
import time
from typing import Any, Dict, Iterable, List, Optional


def _profiler_on() -> bool:
    """Whether ``torch.profiler`` is recording (False without torch)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


def _record_function(name: str):
    """An entered host range of the profiler's, named ``name``, while the
    profiler records (else None): the profiler's trace then nests its
    operations under the program's phase. The range is of the
    profiler's function scope, as an operator's: a ``record_function``
    (user scope) would also put a device range of its name around the
    kernels it launched, which readers of the trace's device time would
    count as device work."""
    if not _profiler_on():
        return None
    import torch
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    if fast is None:
        return None
    rf = fast(name)
    rf.__enter__()
    return rf


class _Span:
    """Live span handle (context manager).

    Always measures — one ``perf_counter`` read at enter, one at exit —
    and publishes the elapsed milliseconds as ``.ms`` so the call site
    can fold the same measurement into its own stats. The record is
    appended to the tracer only when recording is enabled. An exception
    propagating out of the body still closes the span (with an
    ``error`` attribute) so span balance holds under rollback paths.
    """

    __slots__ = ("_tracer", "name", "cat", "args", "t0", "ms", "id",
                 "parent", "_rf")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = 0.0
        self.ms = 0.0
        self.id = 0
        self.parent = 0
        self._rf = None

    def set(self, **attrs: Any) -> "_Span":
        self.args.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        tr = self._tracer
        if tr.enabled:
            self.id, self.parent = tr._push()
            self._rf = _record_function(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, etype, evalue, tb) -> bool:
        t1 = time.perf_counter()
        self.ms = (t1 - self.t0) * 1e3
        if etype is not None:
            self.args.setdefault("error", etype.__name__)
        tr = self._tracer
        if self.id:
            tr._pop(self.id)
            if self._rf is not None:
                self._rf.__exit__(None, None, None)
                self._rf = None
        if tr.enabled:
            tr._append(self.name, self.cat, "X", self.t0, t1 - self.t0,
                       self.args, rid=self.id, parent=self.parent)
        return False


class _DeviceSpan:
    """Open device-work handle: begun at enqueue, ended at a sync site."""

    __slots__ = ("name", "args", "t0", "tid", "id", "parent")

    def __init__(self, name: str, args: Dict[str, Any], t0: float,
                 tid: str, rid: int, parent: int):
        self.name = name
        self.args = args
        self.t0 = t0
        self.tid = tid
        self.id = rid
        self.parent = parent


class _NullRange:
    """What a disabled tracer's ``device_range`` returns: one shared
    context that does nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullRange":
        return self

    def __exit__(self, etype, evalue, tb) -> bool:
        return False


#: the shared null range (call sites that build a range's args only
#: while tracing return it directly)
NULL_RANGE = _NullRange()


class _Range:
    """A device range: a start and an end event on the device's current
    stream around an enqueue (on the CPU, the host's clock around the
    work itself). Folded into a record by ``Tracer.collect`` once its
    end event has completed."""

    __slots__ = ("_tracer", "name", "dev", "args", "id", "parent", "t0",
                 "t1", "ev0", "ev1", "_rf")

    def __init__(self, tracer: "Tracer", name: str, dev,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.dev = dev          # a CUDA device, or None (host-timed)
        self.args = args
        self.ev0 = self.ev1 = None
        self.t0 = self.t1 = 0.0

    def __enter__(self) -> "_Range":
        tr = self._tracer
        self.id, self.parent = next(tr._ids), tr._top()
        self._rf = _record_function(self.name)
        self.t0 = time.perf_counter()
        if self.dev is not None:
            self.ev0 = tr._mark(self.dev)
        return self

    def __exit__(self, etype, evalue, tb) -> bool:
        tr = self._tracer
        if self.dev is not None:
            self.ev1 = tr._mark(self.dev)
        self.t1 = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        if etype is not None:
            self.args.setdefault("error", etype.__name__)
        tr._pending.append(self)
        return False

    def done(self) -> bool:
        """Whether the range's device work has completed (asks the
        events; never waits)."""
        return self.dev is None or (self.ev1 is not None
                                    and self.ev0.query()
                                    and self.ev1.query())


class Tracer:
    """Thread-safe span/event recorder with Chrome + JSONL export.

    One tracer serves the whole mesh: the scheduler thread, the hub's
    stager thread and (in tests) arbitrary callers append under one
    lock. Timestamps are microseconds relative to the tracer's epoch,
    which is what the Chrome ``trace_event`` format wants. Device ranges
    are opened and collected on the scheduler thread.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._epoch = time.perf_counter()
        self._epoch_ns = time.time_ns()
        self._lock = threading.Lock()
        self._records: List[Dict[str, Any]] = []
        self._seq = 0
        self._ids = itertools.count(1)           # record ids
        self._tls = threading.local()            # open host spans
        self._uid_trace: Dict[Any, int] = {}
        self._uid_first: Dict[Any, _Range] = {}
        self._open: Dict[int, _DeviceSpan] = {}
        self._pending: collections.deque = collections.deque()
        self._free: Dict[Any, List[Any]] = {}    # device -> spare events
        self._anchor: Dict[Any, List[Any]] = {}  # device -> [event, t, ok]

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
            self._uid_first.pop(uid, None)

    # -- the open-span stack (this thread's, while enabled) ------------
    def _stack(self) -> List[int]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _top(self) -> int:
        st = self._stack()
        return st[-1] if st else 0

    def _push(self):
        """(a new record id, its parent), the id now open."""
        st = self._stack()
        rid = next(self._ids)
        parent = st[-1] if st else 0
        st.append(rid)
        return rid, parent

    def _pop(self, rid: int) -> None:
        st = self._stack()
        if st and st[-1] == rid:
            st.pop()
        elif rid in st:
            st.remove(rid)

    # -- spans ---------------------------------------------------------
    def span(self, name: str, /, **attrs: Any) -> _Span:
        """Host-work span. Must NOT wrap bare device dispatch — rule
        O002 flags that; use ``begin_device``/``end_device`` (completion
        semantics), ``device_range`` (device time) or ``enqueue_span``
        (explicit enqueue semantics)."""
        return _Span(self, name, "host", attrs)

    def enqueue_span(self, name: str, /, **attrs: Any) -> _Span:
        """A span that *deliberately* measures device-work enqueue, not
        completion — e.g. the hub's jitted slot install, whose cost
        model is 'time until the scheduler may proceed', or a scheduler
        phase. The ``enqueue`` category marks the semantics in the
        exported trace, and O002 exempts it (the rule exists to catch
        *accidental* enqueue timing)."""
        return _Span(self, name, "enqueue", attrs)

    def event(self, name: str, /, **attrs: Any) -> None:
        """Instant event (Chrome ``ph: i``)."""
        if not self.enabled:
            return
        t = time.perf_counter()
        self._append(name, "host", "i", t, 0.0, attrs, rid=next(self._ids),
                     parent=self._top())

    # -- device-work handles -------------------------------------------
    def begin_device(self, name: str, /, **attrs: Any
                     ) -> Optional[_DeviceSpan]:
        """Open a device-work span at enqueue time. Returns ``None``
        when disabled (``end_device(None)`` is a no-op), so call sites
        stay unconditional."""
        if not self.enabled:
            return None
        h = _DeviceSpan(name, attrs, time.perf_counter(),
                        threading.current_thread().name, next(self._ids),
                        self._top())
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
                     t1 - handle.t0, handle.args, tid=handle.tid,
                     rid=handle.id, parent=handle.parent)

    def open_device_count(self) -> int:
        """Device spans begun but not yet ended — 0 after a full drain
        (the span-balance invariant the tests assert, including across
        ``PagePoolExhausted`` rollback and speculative fallback)."""
        with self._lock:
            return len(self._open)

    # -- device ranges (CUDA events) -----------------------------------
    def device_range(self, name: str, /, device=None, **attrs: Any):
        """A context manager timing the device work enqueued inside it on
        ``device``'s current stream (a CUDA ``torch.device``), by a start
        and an end event from a free list; on any other device (or
        None) it times the host. Folded into a ``device`` record by
        ``collect``. Disabled: the shared null context. Never open one
        inside a captured body (O001)."""
        if not self.enabled:
            return NULL_RANGE
        dev = device if device is not None and \
            getattr(device, "type", None) == "cuda" else None
        return _Range(self, name, dev, attrs)

    def _new_event(self, dev):
        import torch
        return torch.cuda.Event(enable_timing=True)

    def _stream(self, dev):
        import torch
        return torch.cuda.current_stream(dev)

    def _mark(self, dev):
        """An event from ``dev``'s free list, recorded on its current
        stream."""
        free = self._free.get(dev)
        ev = free.pop() if free else self._new_event(dev)
        ev.record(self._stream(dev))
        return ev

    def anchor(self, dev) -> None:
        """Tie ``dev``'s clock to the tracer's: wait for the device, then
        record one event and read the host clock. Once a device; call it
        where a sync costs nothing (binding the tracer), never in the
        serving loop."""
        if not self.enabled or getattr(dev, "type", None) != "cuda" \
                or dev in self._anchor:
            return
        import torch
        torch.cuda.synchronize(dev)
        ev = self._new_event(dev)
        ev.record(self._stream(dev))
        self._anchor[dev] = [ev, time.perf_counter(), False]

    def _device_s(self, dev, ev) -> Optional[float]:
        """A completed event's time on the tracer's clock (seconds)."""
        a = self._anchor.get(dev)
        if a is None:
            return None
        if not a[2]:
            if not a[0].query():
                return None
            a[2] = True
        return a[1] + a[0].elapsed_time(ev) / 1e3

    def _interval(self, r: _Range):
        """(start, seconds) of a completed range on the tracer's clock:
        the events' interval, placed by the device's anchor (at the
        enqueue's start where the device has none)."""
        if r.dev is None:
            return r.t0, r.t1 - r.t0
        dur = r.ev0.elapsed_time(r.ev1) / 1e3
        t0 = self._device_s(r.dev, r.ev0)
        return (r.t0 if t0 is None else t0), dur

    def collect(self) -> int:
        """Fold completed device ranges into records, in the order they
        were enqueued, stopping at the first whose events have not
        completed (asked with ``query()``, never waited on); their
        events go back to the free lists. Nothing is asked while a CUDA
        graph is being captured. Returns the ranges folded."""
        pend = self._pending
        if not pend:
            return 0
        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_available() \
                and torch.cuda.is_current_stream_capturing():
            return 0
        n = 0
        while pend and pend[0].done():
            r = pend.popleft()
            t0, dur = self._interval(r)
            args = dict(r.args, device_ms=dur * 1e3,
                        enqueue_ms=(r.t1 - r.t0) * 1e3)
            self._append(r.name, "device", "X", t0, dur, args,
                         tid=(f"cuda:{r.dev.index or 0}" if r.dev is not None
                              else "cpu"),
                         rid=r.id, parent=r.parent)
            if r.dev is not None:
                self._free.setdefault(r.dev, []).extend((r.ev0, r.ev1))
                r.ev0 = r.ev1 = None
                r.t1 = t0 + dur          # the device end, for first_token_s
            n += 1
        return n

    # -- first tokens --------------------------------------------------
    def first_token(self, uids: Iterable[Any], rng) -> None:
        """``rng`` (a ``device_range``) made the first token of the rows
        ``uids``."""
        if not self.enabled or not isinstance(rng, _Range):
            return
        with self._lock:
            for u in uids:
                self._uid_first[u] = rng

    def first_token_s(self, uid: Any) -> Optional[float]:
        """The device end, on the tracer's clock, of the range that made
        row ``uid``'s first token; None where none was recorded or its
        events have not completed (nothing waits)."""
        with self._lock:
            r = self._uid_first.get(uid)
        if r is None:
            return None
        if r.ev1 is None:           # host-timed, or folded already
            return r.t1
        if not r.done():
            return None
        t = self._device_s(r.dev, r.ev1)
        return r.t1 if t is None else t

    # -- storage / export ----------------------------------------------
    def _append(self, name: str, cat: str, ph: str, t0: float,
                dur_s: float, args: Dict[str, Any],
                tid: Optional[str] = None, rid: int = 0,
                parent: int = 0) -> None:
        rec = {"name": name, "cat": cat, "ph": ph,
               "ts": (t0 - self._epoch) * 1e6,
               "dur": dur_s * 1e6,
               "tid": tid or threading.current_thread().name,
               "id": rid or next(self._ids), "parent": parent,
               "args": args}
        with self._lock:
            self._records.append(rec)

    def records(self) -> List[Dict[str, Any]]:
        """A snapshot copy of all records (JSONL-shaped dicts), after
        folding every device range that has completed."""
        self.collect()
        with self._lock:
            return [dict(r) for r in self._records]

    def clear(self) -> None:
        with self._lock:
            self._records.clear()

    def export_chrome(self, path: str) -> int:
        """Write Chrome ``trace_event`` JSON (open in chrome://tracing
        or Perfetto). Returns the number of events written. Each event's
        args carry its ``id`` and ``parent``; the metadata holds the
        epoch on ``perf_counter`` and on ``time.time_ns()``."""
        recs = self.records()
        tids: Dict[str, int] = {}
        events: List[Dict[str, Any]] = []
        for r in recs:
            tid = tids.setdefault(r["tid"], len(tids) + 1)
            ev: Dict[str, Any] = {"name": r["name"], "cat": r["cat"],
                                  "ph": r["ph"], "pid": 1, "tid": tid,
                                  "ts": r["ts"],
                                  "args": dict(r["args"], id=r["id"],
                                               parent=r["parent"])}
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
                       "displayTimeUnit": "ms",
                       "otherData": {"epoch_perf_counter_s": self._epoch,
                                     "epoch_time_ns": self._epoch_ns}},
                      fh, default=str)
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
