"""Deterministic schedule-fuzzing sanitizer for the port's expert-hub
lifecycle (rules S001-S002): the dynamic half of the concurrency gate,
the reference's ``repro.analysis.sanitizer`` kept as the port's own copy.

``races`` proves lock discipline statically; this pass *runs* the two
threads (scheduler driver + hub staging worker) under a cooperative,
seeded scheduler and checks the conservation invariants after real
interleavings:

  * **Shimmed primitives.** ``instrument(hub, itl)`` swaps the hub's
    ``_lock`` / ``_cv`` / ``_stage_q`` and its ``_thread_factory`` seam
    for shims (``ShimLock``, ``ShimCondition``, ``ShimQueue``,
    ``_ManagedThread``) that route every block/wake decision through
    one ``Interleaver``.
  * **Single-run-token scheduling.** Exactly one managed thread runs at
    a time; at every yield point (a ``sys.settrace`` line hook scoped
    to ``serve/hub.py``, plus every shim operation) the interleaver's
    seeded RNG picks the next runnable thread from a sorted candidate
    list. Given a seed, the interleaving — and the recorded trace — is
    byte-identical on replay. Timeouts inside the shims are ignored
    (they would be wall-clock nondeterminism); real deadlocks are
    caught structurally (no runnable thread) and by a watchdog.
  * **Invariants per interleaving** (``fuzz_torch_hub``): ``hub.check()``
    (state-machine legality + ``loads == commits`` + stage-attempt
    conservation), ``PagePool.check()``, pin counts back to baseline
    after drain, clean worker shutdown via ``close()``. The hub is the
    port's ``ExpertHub`` over a torch stub model on the CPU, so it builds
    in milliseconds; the workload is the reference's ``fuzz_hub``'s.
  * **Teeth.** A planted lost-update — the two-line read-modify-write an
    unlocked popularity counter performs — must *lose* updates under
    ``LOST_UPDATE_SEED`` when unlocked and conserve when locked. A
    sanitizer whose planted bug stops reproducing has lost its teeth and
    fails the gate (S002).

Rules:

  S001  conservation violated under an interleaving — an invariant
        (pins, page books, state machine, stats conservation) broke, or
        an unexpected error surfaced from the fuzzed lifecycle.
  S002  determinism/teeth failure — the same seed replayed to a
        different trace, or a planted negative stopped reproducing.

``run()`` arms ``faulthandler`` with a hard timeout, so a real deadlock
dumps every thread's stack instead of hanging the caller.
"""
from __future__ import annotations

import collections
import dataclasses
import faulthandler
import itertools
import random
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from . import REPO_ROOT, Violation

HUB_PATH = "src/repro_torch/serve/hub.py"

# seed under which the planted unlocked read-modify-write demonstrably
# loses increments (the negative test: documented, replayable), and a
# fuzz seed whose workload wants the never-saved expert so the
# staging-failure path is exercised end to end
LOST_UPDATE_SEED = 1
FAIL_SEED = 0
DEFAULT_SEEDS = (0, 1, 2)
SANITIZER_TIMEOUT = 300.0   # faulthandler hard stop for the whole pass


class _AbortError(BaseException):
    """Unwinds managed threads on deadlock/watchdog/shutdown. Derives
    from BaseException so the hub's ``except Exception`` staging guard
    cannot swallow a schedule abort."""


class _TState:
    __slots__ = ("name", "done", "blocked", "in_shim", "notified")

    def __init__(self, name: str):
        self.name = name
        self.done = False
        # predicate gating runnability (None = runnable); evaluated by
        # the scheduler under the monitor
        self.blocked: Optional[Callable[[], bool]] = None
        # True while executing shim internals (incl. cv predicates):
        # yield_point must not recurse into the scheduler from there
        self.in_shim = False
        self.notified = False


class Interleaver:
    """Cooperative deterministic scheduler over real threads.

    One token: only ``_current`` runs; everyone else waits on the
    monitor. Every decision — who runs after a yield, a block, a thread
    exit — is made by ``rng`` over a *sorted* candidate list, so a seed
    fully determines the interleaving. ``trace`` records every yield
    and shim event in global order; byte-equal traces == identical
    interleavings.
    """

    def __init__(self, seed: int, watchdog: float = 30.0):
        self.seed = seed
        self.rng = random.Random(seed)
        self.watchdog = watchdog
        self._mon = threading.Condition()
        self._states: Dict[str, _TState] = {}
        self._by_ident: Dict[int, _TState] = {}
        self._current: Optional[str] = None
        self._managed: List["_ManagedThread"] = []
        self.trace: List[str] = []
        self.aborted: Optional[str] = None
        self._trace_suffix = ("serve/hub.py",)

    # -- registration ----------------------------------------------------
    def _register(self, name: str) -> _TState:
        if name in self._states:
            raise ValueError(f"duplicate managed thread {name!r}")
        st = _TState(name)
        self._states[name] = st
        return st

    def _adopt(self, name: str) -> _TState:
        st = self._states[name]
        self._by_ident[threading.get_ident()] = st
        return st

    def _me(self) -> Optional[_TState]:
        return self._by_ident.get(threading.get_ident())

    # -- scheduling core (all under self._mon) ---------------------------
    def _runnable_locked(self) -> List[str]:
        out = []
        for name in sorted(self._states):
            st = self._states[name]
            if st.done:
                continue
            if st.blocked is not None and not st.blocked():
                continue
            out.append(name)
        return out

    def _abort_locked(self, reason: str, raise_: bool = True) -> None:
        if self.aborted is None:
            self.aborted = reason
        self._mon.notify_all()
        if raise_:
            raise _AbortError(reason)

    def _pick_locked(self) -> None:
        cand = self._runnable_locked()
        if not cand:
            live = sorted(n for n, s in self._states.items()
                          if not s.done)
            self._abort_locked(
                "deadlock: every live thread is blocked "
                f"({','.join(live)})")
        self._current = cand[self.rng.randrange(len(cand))]
        self._mon.notify_all()

    def _wait_turn_locked(self, st: _TState) -> None:
        deadline = time.monotonic() + self.watchdog
        while self.aborted is None and self._current != st.name:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self._abort_locked(
                    f"watchdog: {st.name} starved for "
                    f"{self.watchdog}s (wedged thread?)")
            self._mon.wait(remaining)
        if self.aborted is not None:
            raise _AbortError(self.aborted)
        st.blocked = None

    def _block_locked(self, st: _TState, tag: str,
                      pred: Callable[[], bool]) -> None:
        """Current thread blocks on ``pred``; scheduler picks someone
        else (or us again, once the predicate turns true)."""
        self.trace.append(f"{st.name}|{tag}")
        st.blocked = pred
        self._pick_locked()
        self._wait_turn_locked(st)

    # -- public yield points ---------------------------------------------
    def yield_point(self, tag: str) -> None:
        """A possible context switch. No-op for unmanaged threads and
        inside shim internals."""
        st = self._me()
        if st is None or st.in_shim:
            return
        with self._mon:
            if self.aborted is not None:
                raise _AbortError(self.aborted)
            self.trace.append(f"{st.name}|{tag}")
            self._pick_locked()
            self._wait_turn_locked(st)

    def note(self, tag: str) -> None:
        """Append a marker to the trace without switching."""
        with self._mon:
            self.trace.append(f"#|{tag}")

    def _finish(self, name: str) -> None:
        with self._mon:
            self._states[name].done = True
            if self.aborted is None:
                cand = self._runnable_locked()
                if cand:
                    self._current = cand[self.rng.randrange(len(cand))]
            self._mon.notify_all()

    # -- tracing ---------------------------------------------------------
    def _tracer(self, frame, event, arg):
        if event == "call" and \
                frame.f_code.co_filename.endswith(self._trace_suffix):
            return self._line_tracer
        return None

    def _line_tracer(self, frame, event, arg):
        if event == "line":
            self.yield_point(
                f"{frame.f_code.co_name}:{frame.f_lineno}")
        return self._line_tracer

    # -- driving ---------------------------------------------------------
    def run(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` as the managed ``main`` thread with line tracing
        installed; managed threads it spawns interleave with it."""
        self._register("main")
        self._adopt("main")
        self._current = "main"
        old = sys.gettrace()
        sys.settrace(self._tracer)
        try:
            return fn()
        finally:
            sys.settrace(old)
            self._finish("main")

    def shutdown(self, timeout: float = 5.0) -> None:
        """Abort any still-live managed threads and join their real
        threads — test hygiene so no fuzz thread outlives its run."""
        with self._mon:
            live = [n for n, s in self._states.items() if not s.done]
            if live and self.aborted is None:
                self.aborted = "shutdown"
            self._mon.notify_all()
        for mt in self._managed:
            mt._real.join(timeout)


# -- shimmed primitives ------------------------------------------------


class ShimLock:
    """``threading.Lock`` lookalike whose blocking routes through the
    interleaver (deterministic, deadlock-detected)."""

    def __init__(self, itl: Interleaver):
        self.itl = itl
        self.owner: Optional[str] = None

    def acquire(self, blocking: bool = True, timeout: float = -1):
        itl = self.itl
        st = itl._me()
        if st is None:
            raise RuntimeError("unmanaged thread on a ShimLock")
        with itl._mon:
            st.in_shim = True
            try:
                while self.owner is not None:
                    itl._block_locked(st, "lock.block",
                                      lambda: self.owner is None)
                self.owner = st.name
                itl.trace.append(f"{st.name}|lock.acquire")
            finally:
                st.in_shim = False
        return True

    def release(self) -> None:
        itl = self.itl
        st = itl._me()
        with itl._mon:
            if st is None or self.owner != st.name:
                raise RuntimeError(
                    f"ShimLock released by non-owner "
                    f"({st.name if st else '?'} vs {self.owner})")
            self.owner = None
            itl.trace.append(f"{st.name}|lock.release")

    def locked(self) -> bool:
        return self.owner is not None

    def __enter__(self) -> "ShimLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class ShimCondition:
    """``threading.Condition`` lookalike over a ``ShimLock``. Timeouts
    are deliberately ignored — a wait that would time out in real time
    shows up here as a structural deadlock instead (deterministic)."""

    def __init__(self, lock: ShimLock, itl: Interleaver):
        self.lock = lock
        self.itl = itl
        self._waiters: List[_TState] = []

    def wait_for(self, predicate: Callable[[], bool],
                 timeout: Optional[float] = None) -> bool:
        itl = self.itl
        st = itl._me()
        if st is None:
            raise RuntimeError("unmanaged thread on a ShimCondition")
        with itl._mon:
            if self.lock.owner != st.name:
                raise RuntimeError("wait_for without holding the lock")
            st.in_shim = True
            try:
                while True:
                    if predicate():
                        return True
                    st.notified = False
                    self._waiters.append(st)
                    self.lock.owner = None          # release
                    itl._block_locked(st, "cv.wait",
                                      lambda: st.notified)
                    while self.lock.owner is not None:  # reacquire
                        itl._block_locked(
                            st, "cv.reacquire",
                            lambda: self.lock.owner is None)
                    self.lock.owner = st.name
            finally:
                st.in_shim = False

    def notify_all(self) -> None:
        itl = self.itl
        st = itl._me()
        with itl._mon:
            for w in self._waiters:
                w.notified = True
            self._waiters.clear()
            if st is not None:
                itl.trace.append(f"{st.name}|cv.notify_all")

    notify = notify_all


class ShimQueue:
    """``queue.Queue`` lookalike (put/get) with interleaver blocking."""

    def __init__(self, itl: Interleaver):
        self.itl = itl
        self._items: "collections.deque" = collections.deque()

    def put(self, item: Any) -> None:
        itl = self.itl
        st = itl._me()
        with itl._mon:
            self._items.append(item)
            if st is not None:
                itl.trace.append(f"{st.name}|q.put")

    def get(self) -> Any:
        itl = self.itl
        st = itl._me()
        if st is None:
            raise RuntimeError("unmanaged thread on a ShimQueue")
        with itl._mon:
            st.in_shim = True
            try:
                while not self._items:
                    itl._block_locked(st, "q.get",
                                      lambda: bool(self._items))
                return self._items.popleft()
            finally:
                st.in_shim = False


class _ManagedThread:
    """``threading.Thread`` lookalike under interleaver control:
    cooperative start/join/is_alive, line tracer installed in the new
    thread, aborts unwound quietly."""

    _counter = itertools.count()

    def __init__(self, itl: Interleaver, target: Callable = None,
                 name: Optional[str] = None, daemon: Optional[bool]
                 = None, args: Tuple = (), kwargs: Optional[dict]
                 = None):
        self.itl = itl
        self._target = target
        self._args = args
        self._kwargs = kwargs or {}
        self.name = name or f"managed-{next(self._counter)}"
        self.daemon = True
        self._st: Optional[_TState] = None
        self._real = threading.Thread(target=self._run, name=self.name,
                                      daemon=True)

    def start(self) -> None:
        itl = self.itl
        with itl._mon:
            self._st = itl._register(self.name)
            itl._managed.append(self)
        self._real.start()

    def _run(self) -> None:
        itl = self.itl
        st = itl._adopt(self.name)
        sys.settrace(itl._tracer)
        try:
            with itl._mon:
                itl._wait_turn_locked(st)
            if self._target is not None:
                self._target(*self._args, **self._kwargs)
        except _AbortError:
            pass
        finally:
            sys.settrace(None)
            itl._finish(self.name)

    def is_alive(self) -> bool:
        return self._st is not None and not self._st.done

    def join(self, timeout: Optional[float] = None) -> None:
        itl = self.itl
        me = itl._me()
        if me is None:                 # unmanaged caller: real join
            self._real.join(timeout)
            return
        with itl._mon:
            if self._st is None or self._st.done:
                return
            me.in_shim = True
            try:
                itl._block_locked(me, f"join:{self.name}",
                                  lambda: self._st.done)
            finally:
                me.in_shim = False


def instrument(hub, itl: Interleaver) -> None:
    """Swap the hub's concurrency primitives for interleaver shims.
    Must run before the staging worker first spawns (it is lazy, so any
    time before the first prefetching ``service`` call works)."""
    if hub._stage_thread is not None:
        raise RuntimeError("instrument() after the staging worker "
                           "spawned — too late to shim")
    hub._lock = ShimLock(itl)
    hub._cv = ShimCondition(hub._lock, itl)
    hub._stage_q = ShimQueue(itl)
    hub._thread_factory = (
        lambda target=None, name=None, daemon=None: _ManagedThread(
            itl, target=target, name=name or "hub-stage",
            daemon=daemon))


# -- stub model: a hub that builds in milliseconds ---------------------


@dataclasses.dataclass(frozen=True)
class _StubCfg:
    name: str = "stub"
    family: str = "stub"
    n_experts: int = 0
    moe_impl: str = "none"

    def replace(self, **kw) -> "_StubCfg":
        return dataclasses.replace(self, **kw)


class _StubModel:
    """What ``ExpertHub`` and its bank need at construction: tiny params
    (``embed``: the engine checks its device), paged-KV capable (so the
    fuzz hub runs the paged layout and ``PagePool.check`` is a real
    invariant). The workload never prefills or decodes: it drives the
    residency lifecycle, where the threads interleave."""

    supports_paged_kv = True
    supports_verify = False

    def __init__(self):
        self.cfg = _StubCfg()

    def param_shapes(self):
        return {"embed": torch.empty((4,), device="meta")}

    def init_paged_pool(self, n_pages, page, device=None):
        # + 1: physical page n_pages is the trash page
        return {k: torch.zeros((n_pages + 1, page, 2), device=device)
                for k in ("k", "v")}


def _stub_params() -> Dict[str, torch.Tensor]:
    return {"embed": torch.zeros((4,))}


# -- the fuzzer --------------------------------------------------------


@dataclasses.dataclass
class FuzzResult:
    seed: int
    trace: List[str]
    failures: List[str]          # invariant violations (S001 material)
    errors: List[str]            # exceptions service() surfaced
    stats: Dict[str, float]


def fuzz_torch_hub(seed: int, *, n_experts: int = 4, n_slots: int = 2,
                   steps: int = 30, fail_expert: bool = False,
                   watchdog: float = 30.0, device=None) -> FuzzResult:
    """One seeded interleaving of the port's hub lifecycle, the
    reference's ``fuzz_hub`` workload: a stub-model hub (paged layout,
    host cache of 1) over a cold store, instrumented, driven from the
    managed main thread (acquire / pin / unpin / note_hit / want /
    service / check) while the staging worker interleaves; then a drain,
    the conservation checks and ``close``. With ``fail_expert`` the last
    expert is never saved, so wanting it runs the staging-failure path
    (the worker's cold reset + the scheduler-side re-raise) mid-fuzz.
    The hub's pools and slots live on ``device``: the card unless
    ``"cpu"`` (raises without one), so that on the card the staging
    worker's copies run while the schedule interleaves."""
    from ..checkpoint import save_expert
    from ..device import resolve_device
    from ..serve.hub import ExpertHub, NotResident

    itl = Interleaver(seed, watchdog=watchdog)
    failures: List[str] = []
    errors: List[BaseException] = []
    with tempfile.TemporaryDirectory(prefix="sanitizer-hub-") as store:
        try:
            names = [f"e{i}" for i in range(n_experts)]
            for i, name in enumerate(names):
                if not (fail_expert and i == n_experts - 1):
                    save_expert(store, name, _stub_params())
            hub = ExpertHub(_StubModel(), n_slots=n_slots, max_len=16,
                            min_len_bucket=8, kv_layout="paged",
                            page_size=8, pool_pages=8, store=store,
                            host_cache=1, device=resolve_device(device))
            for name in names:
                hub.add_expert(name)
            instrument(hub, itl)

            def service(block: bool) -> None:
                try:
                    hub.service(block=block)
                except (AssertionError, _AbortError):
                    raise
                except Exception as exc:    # staging failures re-raised
                    errors.append(exc)

            def workload() -> None:
                wl = random.Random(seed ^ 0x5EED5EED)
                pinned: List[int] = []
                try:
                    try:
                        for _ in range(steps):
                            op = wl.randrange(8)
                            e = wl.randrange(n_experts)
                            itl.note(f"op{op}:e{e}")
                            if op <= 1:
                                try:
                                    hub.acquire(e)
                                    hub.pin(e)
                                    pinned.append(e)
                                except NotResident:
                                    pass
                            elif op == 2 and pinned:
                                hub.unpin(pinned.pop())
                            elif op == 3:
                                hub.note_hit(e, 1 + wl.randrange(3))
                            elif op == 4:
                                hub.want(e)
                            elif op <= 6:
                                service(block=wl.random() < 0.3)
                            else:
                                hub.check()
                        while pinned:
                            hub.unpin(pinned.pop())
                        for _ in range(8 * n_experts):
                            if not hub.has_wanted:
                                break
                            service(block=True)
                        if hub.has_wanted and not errors:
                            failures.append("drain did not converge: "
                                            "experts still wanted")
                        hub.check()
                        if hub.total_pins():
                            failures.append(f"pins not back to baseline: "
                                            f"{hub.total_pins()}")
                        st = hub.stats
                        if st.stage_attempts != (st.stage_count
                                                 + st.stage_failures):
                            failures.append(
                                f"stage conservation after drain: "
                                f"{st.stage_attempts} attempts != "
                                f"{st.stage_count} + {st.stage_failures}")
                        hub.bank.core.pool.check()
                    finally:
                        hub.close()
                except AssertionError as exc:
                    failures.append(f"invariant: {exc}")
                except _AbortError as exc:
                    failures.append(f"schedule abort: {exc}")

            itl.run(workload)
            if itl.aborted is not None:
                msg = f"schedule abort: {itl.aborted}"
                if msg not in failures:
                    failures.append(msg)
            return FuzzResult(seed=seed, trace=list(itl.trace),
                              failures=failures,
                              errors=[type(e).__name__ for e in errors],
                              stats=hub.stats.as_dict())
        finally:
            itl.shutdown()


# -- the planted negative ----------------------------------------------


def demo_lost_update(seed: int, *, locked: bool,
                     rounds: int = 10) -> Tuple[int, int, List[str]]:
    """The planted lost-update: two managed threads each bump a shared
    counter ``rounds`` times through the exact two-step
    read-modify-write the pre-gate popularity counter performed
    (``pop[e] += 1`` with the eviction ranking reading concurrently),
    with an explicit yield in the window. Returns (got, want, trace):
    unlocked runs *lose* increments under ``LOST_UPDATE_SEED``; the
    ``locked`` variant conserves under every seed."""
    itl = Interleaver(seed)
    counter: collections.Counter = collections.Counter()
    lock = ShimLock(itl)

    def bump() -> None:
        v = counter[0]
        itl.yield_point("lost-update-window")
        counter[0] = v + 1

    def loop() -> None:
        for _ in range(rounds):
            if locked:
                with lock:
                    bump()
            else:
                bump()

    peer = _ManagedThread(itl, target=loop, name="peer")

    def driver() -> None:
        peer.start()
        loop()
        peer.join()

    try:
        itl.run(driver)
    finally:
        itl.shutdown()
    return counter[0], 2 * rounds, list(itl.trace)


# -- the pass ----------------------------------------------------------


def _diverge(a: List[str], b: List[str]) -> str:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return f"index {i}: {a[i]!r} != {b[i]!r}"
    return f"length {len(a)} != {len(b)}"


def run(root: str = REPO_ROOT, seeds: Tuple[int, ...] = DEFAULT_SEEDS,
        device=None) -> List[Violation]:
    """S001-S002: the planted lost update first, then each seed's fuzz
    and its replay, and the staging-failure seed, on hubs built on
    ``device`` (the card unless ``"cpu"``; raises without one)."""
    vs: List[Violation] = []
    can_dump = threading.current_thread() is threading.main_thread()
    if can_dump:
        # the process's own stderr: a caller's capture may have no fd
        faulthandler.dump_traceback_later(SANITIZER_TIMEOUT, exit=False,
                                          file=sys.__stderr__)
    try:
        # teeth first: the planted unlocked RMW must lose updates under
        # its documented seed, and the locked fix must conserve — a
        # fuzzer that can't reproduce its own planted bug proves
        # nothing about the hub
        got, want, _ = demo_lost_update(LOST_UPDATE_SEED, locked=False)
        if got >= want:
            vs.append(Violation(
                "S002", HUB_PATH, 1, "demo_lost_update",
                f"planted lost-update did NOT reproduce under seed "
                f"{LOST_UPDATE_SEED} (got {got} of {want}) — the "
                "sanitizer lost its teeth"))
        got, want, _ = demo_lost_update(LOST_UPDATE_SEED, locked=True)
        if got != want:
            vs.append(Violation(
                "S001", HUB_PATH, 1, "demo_lost_update",
                f"locked counter lost updates ({got} of {want}) — "
                "ShimLock mutual exclusion broke"))

        for seed in seeds:
            r1 = fuzz_torch_hub(seed, device=device)
            r2 = fuzz_torch_hub(seed, device=device)
            func = f"ExpertHub[fuzz seed={seed}]"
            if r1.trace != r2.trace:
                vs.append(Violation(
                    "S002", HUB_PATH, 1, func,
                    "replay is not byte-deterministic: "
                    + _diverge(r1.trace, r2.trace)))
            for f in r1.failures:
                vs.append(Violation("S001", HUB_PATH, 1, func, f))
            if r1.errors:
                vs.append(Violation(
                    "S001", HUB_PATH, 1, func,
                    f"unexpected lifecycle errors: {r1.errors}"))

        rf = fuzz_torch_hub(FAIL_SEED, fail_expert=True, device=device)
        func = f"ExpertHub[fuzz seed={FAIL_SEED} fail_expert]"
        for f in rf.failures:
            vs.append(Violation("S001", HUB_PATH, 1, func, f))
        if rf.stats["stage_failures"] < 1:
            vs.append(Violation(
                "S002", HUB_PATH, 1, func,
                "staging-failure path never exercised under seed "
                f"{FAIL_SEED} — pick a seed whose workload wants the "
                "missing expert"))
    finally:
        if can_dump:
            faulthandler.cancel_dump_traceback_later()
    return vs
