"""Expert Hub: checkpoint-backed dynamic expert residency over a fixed
bank of device slots, with popularity-driven eviction.

The paper's premise is a central server hosting *numerous* expert
models for clients who cannot run them, so the catalog may be far larger
than device memory. The hub makes residency a managed resource along

    cold checkpoint store  ->  host-staged params  ->  device bank slot
      (checkpoint/io.py          (CPU tensors, staged      (one member of a
       expert store)              by a worker thread)       BankedEngine)

Residency state machine (per catalog entry):

    cold --stage--> staging --> staged --commit--> resident
                                  ^                    |
                                  +------evict---------+

  * **Catalog.** Unbounded: one ``CatalogEntry`` per known expert (host
    params and/or a store pointer, popularity / pins / last-use books).
    Every expert shares the hub's ``ExpertSpec``: equal specs are what
    lets experts take turns in one slot bank.
  * **Slot bank.** A ``BankedEngine`` of ``n_slots`` members, each with
    params tensors of its own (zeros until an expert commits). A commit
    copies the expert's host params into the slot's tensors in place,
    leaf by leaf, on the stream that replays the decode graphs: every
    captured ``DecodeGraph`` / ``VerifyGraph`` reads the slot's params
    at fixed addresses, so an install changes what the next replay
    computes and never needs a new capture (rebinding a slot's params
    would leave every replay on the old expert's weights). On CUDA the
    host params are pinned first and copied without blocking; the pinned
    copy is kept until an event recorded after the copy has completed.
  * **Residency is refcounted.** Rows pin their expert at admission and
    unpin at response; only pin-free residents with no rows in an active
    wave are evictable, so a slot is never recycled under live KV state
    (a paged slot's prefix cache is invalidated on eviction and its live
    pages are checked to be zero).
  * **Eviction is popularity-weighted LRU**: the evictable resident with
    the fewest router hits (``bind_popularity``), ties broken
    least-recently-used.
  * **Prefetch is asynchronous.** Wanted cold experts are staged by a
    worker thread while resident waves decode; the ``DispatchExecutor``
    runs ``Scheduler._service_hub`` before admission, so commits are
    enqueued ahead of the step's decode ticks. The worker reads the
    store and builds CPU tensors, and makes no CUDA call: a call from
    another thread during a graph capture (captures run in the global
    mode) would invalidate the capture. Pinning and the host-to-device
    copy happen on the scheduler thread.
  * **Backpressure.** ``acquire`` on a non-resident expert records the
    want and raises ``NotResident``; the scheduler parks the rows in
    their queues (as on ``PagePoolExhausted``) until the hub commits.

Threading model: the **scheduler thread** drives the whole lifecycle
(``service`` / ``acquire`` / ``pin`` / ``unpin`` / eviction / commit) and
owns the bank, the page pool and the prefix cache. The **staging
worker** (one ``hub-stage`` thread, spawned lazily, joined by
``close()``) takes ``(expert, name, store)`` jobs from ``_stage_q``,
reads the store with no lock held, and publishes the result (params
first, then the ``staged`` state; or the ``cold`` reset and the recorded
error) under ``_lock``. Everything both threads touch is guarded by
``_lock``; ``_cv`` (a condition on that lock) is the one blocking point.
``THREAD_CONTRACT`` states this as data, in the form the race analyzer
(``repro_torch.analysis.races``) reads.
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..checkpoint import io as ckpt_io
from ..core.registry import ExpertRegistry, ExpertSpec, bankable_arch
from ..obs.trace import NULL_TRACER
from ..tree import leaves, tree_map
from ..sharding import leading_sharding
from .core import bank_positions, bucket_for
from .placement import BankedEngine, BankHandle

# ---------------------------------------------------------------------------
# The concurrency contract, as data (a pure literal):
#
#   * ``threads``       — entry-point qualnames per thread; everything
#                         reachable from them is that thread's.
#                         (``Scheduler._service_hub`` / ``_admit_batches``
#                         / ``_tick_engines`` / ``_harvest_engines`` are
#                         roots of their own: the executor in serve/core.py
#                         calls them.)
#   * ``lock_guarded``  — state both threads touch: every access holds the
#                         designated lock (lexically, or in a ``*_locked``
#                         helper whose call sites hold it).
#   * ``queue_handoffs``— cross-thread channels that need no lock.
#   * ``single_writer`` — state one thread owns; the other never reaches it.
#   * ``blocking_calls``— calls that may block the host; never under the
#                         lock (a condition wait releases it, so is exempt).
#   * ``publish_order`` — a ``state`` write publishing the named value comes
#                         after the writes of its payload fields.
# ---------------------------------------------------------------------------
THREAD_CONTRACT = {
    "lock": "_lock",
    "lock_aliases": ["_lock", "_cv"],
    "threads": {
        "scheduler": [
            "Scheduler.submit", "Scheduler.step", "Scheduler.drain",
            "Scheduler.check_invariants", "Scheduler.close",
            "Scheduler._service_hub", "Scheduler._admit_batches",
            "Scheduler._tick_engines", "Scheduler._harvest_engines",
            "ExpertHub.service", "ExpertHub.warmup", "ExpertHub.acquire",
            "ExpertHub.want", "ExpertHub.pin", "ExpertHub.unpin",
            "ExpertHub.note_hit", "ExpertHub.bind_popularity",
            "ExpertHub.slot_of", "ExpertHub.expert_in",
            "ExpertHub.resident_experts", "ExpertHub.has_wanted",
            "ExpertHub.total_pins", "ExpertHub.check", "ExpertHub.close",
            "ExpertHub.__len__",
        ],
        "stager": ["ExpertHub._stage_loop"],
    },
    "lock_guarded": {
        "entry_fields": ["state", "params", "slot", "pins", "last_used",
                         "misses", "stage_ms", "commit_ms",
                         "resident_s", "resident_since"],
        "fields": ["catalog", "_wanted", "_staging", "_stage_errors",
                   "popularity", "_stage_thread", "_closed"],
        "stats_fields": ["loads", "evictions", "resident_misses",
                         "stage_attempts", "stage_count", "stage_ms",
                         "stage_cache_hits", "stage_failures",
                         "commit_count", "commit_ms", "commit_bytes"],
    },
    "queue_handoffs": ["_stage_q"],
    "single_writer": {
        "scheduler": ["_index", "_slot_expert", "_in_flight", "_tick",
                      "host_cache",
                      "queues", "n_queued", "_meta", "_done", "_seq",
                      "_skips", "_steps", "prefix_lru",
                      "refs", "_free", "_lru", "_active"],
    },
    "blocking_calls": ["load_expert", "save_expert", "load_pytree",
                       "save_pytree", "synchronize", "result", "join",
                       "sleep", "wait"],
    "publish_order": {"state": {"staged": ["params"],
                                "resident": ["slot"]}},
}


class NotResident(RuntimeError):
    """Admission outcome: the routed expert has no device slot yet.
    ``ExpertHub.acquire`` records the want before raising, so the
    scheduler parks the rows and retries once the hub commits the expert
    (a later ``service`` call)."""

    def __init__(self, expert: int, name: str):
        super().__init__(
            f"expert {expert} ({name!r}) is not device-resident; "
            "queued for staging")
        self.expert = expert
        self.name = name


class HubStats:
    """Lifecycle counters for one ``ExpertHub``.

    ``loads`` counts slot commits (first load and every re-load),
    ``evictions`` slot recycles, ``resident_misses`` every admission that
    found its expert cold (the scheduler's stall signal). *stage* times
    store -> host tensors (worker thread), *commit* host -> slot (the
    scheduler thread's enqueue of the copies, pinning included);
    ``commit_bytes`` sums the bytes installed.

    Conservation (``ExpertHub.check``): ``loads == commit_count``, and
    ``stage_attempts == stage_count + stage_failures + in-flight``. All
    counters change under the hub lock only.
    """

    def __init__(self):
        self.loads = 0
        self.evictions = 0
        self.resident_misses = 0
        self.stage_attempts = 0         # staging jobs handed out
        self.stage_count = 0            # ... that published params
        self.stage_failures = 0         # ... that failed (entry reset)
        self.stage_ms = 0.0
        self.stage_cache_hits = 0       # wanted expert already staged
        self.commit_count = 0
        self.commit_ms = 0.0
        self.commit_bytes = 0

    @property
    def stage_ms_avg(self) -> float:
        return self.stage_ms / max(self.stage_count, 1)

    @property
    def commit_ms_avg(self) -> float:
        return self.commit_ms / max(self.commit_count, 1)

    def as_dict(self) -> Dict[str, float]:
        return {"loads": self.loads, "evictions": self.evictions,
                "resident_misses": self.resident_misses,
                "stage_attempts": self.stage_attempts,
                "stage_count": self.stage_count,
                "stage_failures": self.stage_failures,
                "stage_ms_avg": self.stage_ms_avg,
                "stage_cache_hits": self.stage_cache_hits,
                "commit_count": self.commit_count,
                "commit_ms_avg": self.commit_ms_avg,
                "commit_bytes": self.commit_bytes}

    def __repr__(self) -> str:
        return (f"HubStats(loads={self.loads}, "
                f"evictions={self.evictions}, "
                f"resident_misses={self.resident_misses}, "
                f"stage={self.stage_count}x{self.stage_ms_avg:.1f}ms"
                f"(+{self.stage_cache_hits} cached, "
                f"{self.stage_failures} failed), "
                f"commit={self.commit_count}x{self.commit_ms_avg:.1f}ms)")


@dataclasses.dataclass
class CatalogEntry:
    """One known expert: where its weights live and who is using it. The
    fields below ``on_disk`` are shared by the scheduler thread and the
    staging worker and guarded by the hub lock."""
    name: str
    params: Any = None              # host-staged CPU tensor tree (or None)
    store: Optional[str] = None     # store root (checkpoint/io)
    on_disk: bool = False           # a checkpoint exists in the store
    state: str = "cold"             # cold | staging | staged | resident
    slot: int = -1                  # device bank slot while resident
    pins: int = 0                   # in-flight rows holding residency
    last_used: int = 0              # hub clock at last admission
    misses: int = 0                 # acquire() found this expert cold
    stage_ms: float = 0.0           # cumulative store -> host latency
    commit_ms: float = 0.0          # cumulative host -> slot latency
    resident_s: float = 0.0         # total seconds spent resident
    resident_since: float = 0.0     # tracer clock at the last commit


@dataclasses.dataclass
class HubMember(BankHandle):
    """Registry-facing handle: one catalog expert served through the
    hub's slot bank (the dynamic counterpart of ``BankMember``)."""
    hub: "ExpertHub"
    expert: int

    @property
    def _bank(self) -> BankedEngine:
        return self.hub.bank

    @property
    def resident(self) -> bool:
        return self.hub.slot_of(self.expert) is not None


class ExpertHub:
    """Dynamic expert residency over a fixed slot bank.

    The hub owns one ``BankedEngine`` of ``n_slots`` slots and an
    unbounded catalog; ``acquire`` / ``pin`` / ``unpin`` are the
    scheduler's admission contract and ``service`` is the per-step
    lifecycle round. Runs on ``cuda`` unless ``device="cpu"``, or over
    ``mesh`` (its ``expert`` axis dividing ``n_slots``: slot ``s`` on
    position ``s // (n_slots // n)``, where its tensors are made);
    options as ``BankedEngine``'s. ``store`` is the checkpoint store root
    (read by the staging worker thread), ``host_cache`` bounds the staged host copies of
    store-backed experts, ``stage_timeout`` bounds a blocking
    ``service`` wait. Call ``close()`` (or use the hub as a context
    manager) to join the worker.
    """

    def __init__(self, model, *, n_slots: int, max_len: int = 256,
                 min_len_bucket: int = 8,
                 batch_buckets: Optional[Sequence[int]] = None,
                 mesh=None, kv_layout: str = "ring", page_size: int = 8,
                 pool_pages: Optional[int] = None,
                 chunk_len: Optional[int] = None,
                 store: Optional[str] = None,
                 host_cache: Optional[int] = None,
                 stage_timeout: float = 120.0, device=None):
        if n_slots < 1:
            raise ValueError(f"ExpertHub needs n_slots >= 1, got {n_slots}")
        if not bankable_arch(model.cfg):
            raise ValueError(
                f"{model.cfg.family!r} capacity-dispatch MoE experts "
                "cannot share a slot bank (outputs depend on batch "
                "padding); serve them per-engine")
        _, devs = bank_positions(n_slots, mesh, device)
        where = leading_sharding(n_slots, "expert", mesh)
        self.device = devs[0]
        self.model = model
        self.n_slots = n_slots
        self.store = store
        self.stage_timeout = stage_timeout
        self.host_cache = host_cache
        # the params tree's shapes and dtypes (no storage): each slot gets
        # zero tensors of its own on its position's device, the tensors
        # every commit writes into and every captured step reads
        shapes = model.param_shapes()
        slots = [tree_map(lambda s, d=devs[where[i] if where else 0]:
                          torch.zeros(s.shape, dtype=s.dtype, device=d),
                          shapes)
                 for i in range(n_slots)]
        self.bank = BankedEngine(
            model, slots, max_len=max_len, min_len_bucket=min_len_bucket,
            batch_buckets=batch_buckets, mesh=mesh, kv_layout=kv_layout,
            page_size=page_size, pool_pages=pool_pages,
            chunk_len=chunk_len, device=device)
        core = self.bank.core
        paged = kv_layout == "paged"
        self.spec = ExpertSpec(
            arch=model.cfg.replace(name=""), max_len=self.bank.max_len,
            len_buckets=tuple(self.bank.len_buckets),
            batch_buckets=tuple(self.bank.batch_buckets),
            kv_layout=self.bank.kv_layout,
            page=core.page if paged else None,
            pool_pages=core.pool.n_pages if paged else None,
            chunk_len=core.chunk_len if paged else None)
        self._host_like = shapes          # the store's tree structure
        self.catalog: List[CatalogEntry] = []
        self._index: Dict[str, int] = {}
        self._slot_expert: List[Optional[int]] = [None] * n_slots
        self._wanted: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        # experts with a staging job in flight (insertion-ordered set)
        self._staging: Dict[int, None] = {}
        # failures recorded by the worker, re-raised by service()
        self._stage_errors: List[Tuple[int, BaseException]] = []
        # (event, pinned sources) of installs whose copies may still run
        self._in_flight: List[Tuple[Any, List[torch.Tensor]]] = []
        self._tick = 0
        # router hit counts (rebound by bind_popularity when a Router
        # fronts the hub; pre-routed schedulers feed it via note_hit)
        self.popularity: collections.Counter = collections.Counter()
        self.stats = HubStats()
        # -- concurrency plumbing (THREAD_CONTRACT) ----------------------
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._stage_q: "queue.Queue[Optional[Tuple[int, str, str]]]" = \
            queue.Queue()
        self._stage_thread: Optional[threading.Thread] = None
        self._closed = False
        self._thread_factory = threading.Thread
        # lifecycle tracer, bound before traffic; both threads only read
        # it, and the disabled NULL_TRACER's spans still measure
        self._tracer = NULL_TRACER

    def bind_tracer(self, tracer) -> None:
        """Install a lifecycle tracer (None restores NULL_TRACER). Call
        before traffic, from the scheduler thread."""
        self._tracer = tracer if tracer is not None else NULL_TRACER

    # -- catalog ---------------------------------------------------------
    def add_expert(self, name: str, params: Any = None, *,
                   cold: bool = False) -> int:
        """Register one expert. ``params`` (a tree of tensors on any
        device) stages it in host memory at once;
        ``cold=True`` writes them to the store instead and keeps no host
        copy; ``params=None`` points at an expert already in the
        store."""
        if name in self._index:
            raise ValueError(f"expert {name!r} already in the catalog")
        entry = CatalogEntry(name=name, store=self.store)
        if params is not None:
            if cold:
                if self.store is None:
                    raise ValueError("cold=True needs a store directory")
                # the store write happens before the lock: blocking I/O
                # never runs under _lock
                ckpt_io.save_expert(self.store, name, params)
                entry.on_disk = True
            else:
                entry.params = tree_map(lambda t: t.detach().cpu(), params)
                entry.state = "staged"
        elif self.store is None:
            raise ValueError(
                f"expert {name!r}: no params and no checkpoint store")
        else:
            entry.on_disk = True          # a checkpoint already there
        with self._lock:
            e = len(self.catalog)
            self.catalog.append(entry)
            self._index[name] = e
        return e

    def add_from_store(self, names: Optional[Sequence[str]] = None
                       ) -> List[int]:
        """Catalog every expert found in the store (or ``names``)."""
        if self.store is None:
            raise ValueError("hub has no checkpoint store")
        names = names if names is not None else \
            ckpt_io.list_experts(self.store)
        return [self.add_expert(n) for n in names]

    def build_registry(self) -> ExpertRegistry:
        """An ``ExpertRegistry`` over the catalog: every backend is a
        ``HubMember`` and every entry carries the hub's spec."""
        reg = ExpertRegistry()
        for e, c in enumerate(self.catalog):
            reg.add(c.name, HubMember(self, e), spec=self.spec)
        return reg

    def bind_popularity(self, counter: collections.Counter, *,
                        router=None) -> None:
        """Share the router's per-expert hit Counter as the eviction
        policy's popularity signal (the same object). It becomes state
        both threads read: pass the ``Router`` as ``router=`` so its own
        increments take the hub lock too (``Router.hits_lock``)."""
        with self._lock:
            counter.update(self.popularity)
            self.popularity = counter
        if router is not None:
            router.hits_lock = self._lock

    def note_hit(self, e: int, n: int = 1) -> None:
        """Record routing hits for the eviction policy: the one mutation
        point of the shared popularity Counter."""
        with self._lock:
            self.popularity[e] += n

    def __len__(self) -> int:
        with self._lock:
            return len(self.catalog)

    # -- residency -------------------------------------------------------
    def slot_of(self, e: int) -> Optional[int]:
        with self._lock:
            c = self.catalog[e]
            return c.slot if c.state == "resident" else None

    def expert_in(self, slot: int) -> Optional[int]:
        with self._lock:
            return self._slot_expert[slot]

    @property
    def resident_experts(self) -> List[int]:
        with self._lock:
            return [e for e in self._slot_expert if e is not None]

    @property
    def has_wanted(self) -> bool:
        with self._lock:
            return bool(self._wanted)

    def total_pins(self) -> int:
        """Sum of residency pins over the catalog (the scheduler's pin
        conservation check compares it with its in-flight rows)."""
        with self._lock:
            return sum(c.pins for c in self.catalog)

    def acquire(self, e: int) -> int:
        """Slot serving expert ``e`` (touching its LRU clock), or record
        the want and raise ``NotResident``."""
        with self._lock:
            c = self.catalog[e]
            if c.state == "resident":
                c.last_used = self._tick
                return c.slot
            self._want_locked(e)
            self.stats.resident_misses += 1
            c.misses += 1
            name = c.name
        raise NotResident(e, name)

    def want(self, e: int) -> None:
        with self._lock:
            self._want_locked(e)

    def _want_locked(self, e: int) -> None:
        c = self.catalog[e]
        if c.state == "resident" or e in self._wanted:
            return
        if c.state == "staged":
            # satisfiable from the host cache: no store read needed
            self.stats.stage_cache_hits += 1
        self._wanted[e] = None

    def pin(self, e: int, n: int = 1) -> None:
        """Admitted rows hold their expert resident until harvested."""
        with self._lock:
            c = self.catalog[e]
            if c.state != "resident":
                raise ValueError(f"pin of non-resident expert {c.name!r}")
            c.pins += n

    def unpin(self, e: int, n: int = 1) -> None:
        with self._lock:
            c = self.catalog[e]
            if c.pins < n:
                raise ValueError(f"unpin below zero for expert {c.name!r}")
            c.pins -= n

    # -- lifecycle rounds ------------------------------------------------
    def service(self, *, block: bool = False) -> int:
        """One lifecycle round: surface a staging failure, commit staged
        wanted experts into slots, kick staging for the rest. Returns
        commits made. ``block=True`` (nothing on the device to overlap
        with) waits on ``_cv`` for staging progress, at most
        ``stage_timeout`` seconds. A recorded staging failure re-raises
        here, on the scheduler thread, with its entry already back to
        cold (retryable)."""
        committed = 0
        try:
            with self._lock:
                self._tick += 1
                self._raise_stage_failure_locked()
                committed = self._commit_ready_locked()
                self._kick_staging_locked()
                if block and not committed:
                    if (self._wanted and self._staging
                            and not self._stage_errors):
                        if not self._cv.wait_for(
                                self._progress_locked,
                                timeout=self.stage_timeout):
                            raise RuntimeError(
                                "hub staging made no progress in "
                                f"{self.stage_timeout}s")
                    self._raise_stage_failure_locked()
                    committed += self._commit_ready_locked()
        finally:
            # the host-cache trim runs on every exit, the staging-failure
            # re-raise included
            with self._lock:
                self._trim_host_locked()
        return committed

    def _progress_locked(self) -> bool:
        """service(block=True)'s wake predicate: a failure to surface, a
        wanted expert staged, or nothing left in flight."""
        return (bool(self._stage_errors) or not self._staging
                or any(self.catalog[e].state == "staged"
                       for e in self._wanted))

    def _raise_stage_failure_locked(self) -> None:
        """Re-raise the oldest recorded staging failure (one a round)."""
        if self._stage_errors:
            _, exc = self._stage_errors.pop(0)
            raise exc

    def _trim_host_locked(self) -> None:
        """Enforce ``host_cache``: drop the host params of the least
        popular (then least recent) staged, unwanted, store-backed
        entries beyond the cap; they go back to cold. Entries without a
        store copy are never dropped."""
        if self.host_cache is None:
            return
        held = [e for e, c in enumerate(self.catalog)
                if c.state == "staged" and c.on_disk
                and e not in self._wanted]
        drop = len(held) - self.host_cache
        if drop <= 0:
            return
        held.sort(key=lambda e: (self.popularity[e],
                                 self.catalog[e].last_used))
        for e in held[:drop]:
            c = self.catalog[e]
            c.params = None
            c.state = "cold"

    def _commit_ready_locked(self) -> int:
        n = 0
        for e in list(self._wanted):
            c = self.catalog[e]
            if c.state == "resident":     # wanted twice
                self._wanted.pop(e, None)
                continue
            if c.params is None:
                continue                  # still cold / staging
            slot = self._grab_slot_locked()
            if slot is None:
                break                     # every slot busy: decode on
            self._commit_locked(e, slot)
            self._wanted.pop(e, None)
            n += 1
        return n

    def _kick_staging_locked(self) -> None:
        """Queue a staging job to the worker over ``_stage_q`` for every
        wanted cold expert."""
        for e in self._wanted:
            c = self.catalog[e]
            if c.state != "cold" or e in self._staging:
                continue
            c.state = "staging"
            self._staging[e] = None
            self.stats.stage_attempts += 1
            self._ensure_worker_locked()
            self._stage_q.put((e, c.name, c.store))

    def _ensure_worker_locked(self) -> None:
        if self._stage_thread is not None:
            return
        if self._closed:
            raise RuntimeError("ExpertHub is closed: no staging worker")
        t = self._thread_factory(target=self._stage_loop,
                                 name="hub-stage", daemon=True)
        t.start()
        self._stage_thread = t

    # -- staging worker --------------------------------------------------
    def _stage_loop(self) -> None:
        """Staging-worker entry point (thread ``stager``): jobs arrive by
        queue handoff; ``None`` is the shutdown sentinel."""
        while True:
            job = self._stage_q.get()
            if job is None:
                break
            self._stage_one(job)

    def _stage_one(self, job: Tuple[int, str, str]) -> None:
        """Stage one expert: store -> CPU tensors, then publish under the
        lock. No lock is held over the read and no CUDA call is made."""
        e, name, store = job
        sp = self._tracer.span("hub.stage", expert=e, expert_name=name)
        try:
            with sp:
                params = ckpt_io.load_expert(store, name,
                                             like=self._host_like)
        except Exception as exc:
            with self._lock:
                self._stage_fail_locked(e, exc)
                self._cv.notify_all()
            return
        with self._lock:
            self._stage_publish_locked(e, params, sp.ms)
            self._cv.notify_all()

    def _stage_publish_locked(self, e: int, params: Any,
                              ms: float) -> None:
        c = self.catalog[e]
        self._staging.pop(e, None)
        c.params = params             # payload before the publish
        c.state = "staged"
        self.stats.stage_count += 1
        self.stats.stage_ms += ms
        c.stage_ms += ms

    def _stage_fail_locked(self, e: int,
                           exc: BaseException) -> None:
        """A failure is loud but retryable: the entry returns to cold, the
        want drops (other experts' traffic keeps flowing) and the
        exception waits for service() to re-raise."""
        c = self.catalog[e]
        self._staging.pop(e, None)
        c.params = None
        c.state = "cold"
        self._wanted.pop(e, None)
        self.stats.stage_failures += 1
        self._stage_errors.append((e, exc))

    # -- shutdown --------------------------------------------------------
    def close(self, timeout: float = 10.0) -> None:
        """Join the staging worker (idempotent). A closed hub still serves
        residents but stages nothing."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            t, self._stage_thread = self._stage_thread, None
        if t is not None:
            self._stage_q.put(None)
            t.join(timeout)
            if t.is_alive():
                raise RuntimeError(
                    f"hub staging worker did not exit within {timeout}s")

    def __enter__(self) -> "ExpertHub":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- slot management (scheduler thread, under the hub lock) ----------
    def _slot_in_wave_locked(self, slot: int) -> bool:
        """Whether an active wave still carries rows for ``slot``. Pins
        alone do not gate eviction: a row's pin drops at its harvest, but
        its wave (and, paged, its pages) lives until every row retires;
        spec and paged waves carry the same row map."""
        return any(w.uids.get(slot) for w in self.bank.core._active)

    def _grab_slot_locked(self) -> Optional[int]:
        for s, owner in enumerate(self._slot_expert):
            if owner is None:
                return s
        victims = [e for e in self._slot_expert
                   if e is not None and self.catalog[e].pins == 0
                   and not self._slot_in_wave_locked(self.catalog[e].slot)]
        if not victims:
            return None
        # popularity-weighted LRU: fewest router hits first, oldest last
        # use breaking ties
        victim = min(victims, key=lambda e: (self.popularity[e],
                                             self.catalog[e].last_used))
        return self._evict_locked(victim)

    def _evict_locked(self, e: int) -> int:
        c = self.catalog[e]
        slot = c.slot
        core = self.bank.core
        if core.kv_layout == "paged":
            # the slot's cached prefixes describe the old expert's KV
            core.prefix_cache.invalidate(slot)
            used = core.pool.used_count(slot)
            if used:
                raise RuntimeError(
                    f"evicting {c.name!r} from slot {slot} with {used} "
                    "live page(s) — pin accounting broke")
        c.state = "staged"                # the host copy stays: a reload
        c.slot = -1                       # skips the store
        c.resident_s += self._tracer.now() - c.resident_since
        self._slot_expert[slot] = None
        self.stats.evictions += 1
        return slot

    def _install(self, slot: int, params: Any) -> int:
        """Copy host ``params`` into slot ``slot``'s tensors in place, on
        the current stream of the slot's device. On CUDA each source is
        pinned and copied without blocking, and the pinned copies are kept
        until an event recorded after the copies on that stream has
        completed. Returns bytes copied."""
        self._in_flight = [(ev, held) for ev, held in self._in_flight
                           if not ev.query()]
        dst, src = leaves(self.bank.params[slot]), leaves(params)
        if len(dst) != len(src):
            raise ValueError(f"expert params have {len(src)} leaves, the "
                             f"slot {len(dst)}")
        pinned, nbytes = [], 0
        for d, s in zip(dst, src):
            if d.shape != s.shape or d.dtype != s.dtype:
                raise ValueError(f"expert leaf {tuple(s.shape)} {s.dtype} "
                                 f"does not fit the slot's "
                                 f"{tuple(d.shape)} {d.dtype}")
            if d.is_cuda:
                s = s.pin_memory()
                pinned.append(s)
            d.copy_(s, non_blocking=d.is_cuda)
            nbytes += d.numel() * d.element_size()
        if pinned:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dst[0].device))
            self._in_flight.append((ev, pinned))
        return nbytes

    def _commit_locked(self, e: int, slot: int) -> None:
        """Host-staged params -> device slot, in place (``_install``):
        the bank's captured steps read the slot's tensors at fixed
        addresses, so nothing is captured again. Commit latency is the
        enqueue cost (the copies complete in stream order, before the
        next step that reads them). The slot is recorded before
        ``state`` flips to resident."""
        c = self.catalog[e]
        with self._tracer.enqueue_span("hub.commit", expert=e,
                                       slot=slot) as sp:
            nbytes = self._install(slot, c.params)
        self.stats.commit_ms += sp.ms
        self.stats.commit_count += 1
        self.stats.commit_bytes += nbytes
        self.stats.loads += 1
        c.commit_ms += sp.ms
        c.slot = slot
        c.last_used = self._tick
        c.state = "resident"
        c.resident_since = self._tracer.now()
        self._slot_expert[slot] = e

    # -- warmup ----------------------------------------------------------
    def warmup(self, max_batch: Optional[int] = None,
               commit: bool = True) -> None:
        """Run the bank's whole shape ladder once before traffic: one
        throwaway wave per (length bucket, batch bucket) up to
        ``max_batch``, three tokens each, so every decode bucket's step
        is captured (step 1 runs eagerly, step 2 captures) and every
        prefill shape has run. Tuple uids: the scheduler's orphan path
        drops any straggler. With ``commit=True`` the first ``n_slots``
        catalog experts are then faulted into their slots. Shapes do not
        depend on which expert a slot holds, so no later install makes a
        new capture."""
        bank = self.bank
        cap = bucket_for(min(max_batch or bank.batch_buckets[-1],
                             bank.batch_buckets[-1]), bank.batch_buckets)
        rng = np.random.default_rng(0)
        for Sb in bank.len_buckets:
            for Bb in bank.batch_buckets:
                if Bb > cap:
                    break
                uids = [("__warmup__", Sb, Bb, i) for i in range(Bb)]
                prompts = [rng.integers(0, 100, size=Sb)
                           for _ in range(Bb)]
                bank.admit({0: (uids, prompts, [3] * Bb)})
                while bank.n_active:
                    bank.tick()
                bank.poll()
        if commit:
            for e in range(min(self.n_slots, len(self))):
                self.want(e)
            while self.has_wanted:
                if not self.service(block=True):
                    break

    # -- bookkeeping -----------------------------------------------------
    def metrics_snapshot(self) -> Dict[str, Any]:
        """The hub's node in the metrics tree: HubStats plus a per-expert
        breakdown (router hits, state, pins, misses, stage / commit ms,
        resident seconds including the live tail)."""
        now = self._tracer.now()
        with self._lock:
            experts: Dict[str, Any] = {}
            for e, c in enumerate(self.catalog):
                live = (now - c.resident_since
                        if c.state == "resident" else 0.0)
                experts[c.name] = {
                    "hits": int(self.popularity[e]),
                    "state": c.state,
                    "pins": c.pins,
                    "misses": c.misses,
                    "stage_ms": c.stage_ms,
                    "commit_ms": c.commit_ms,
                    "resident_s": c.resident_s + live,
                }
            return {**self.stats.as_dict(),
                    "slots": self.n_slots,
                    "experts": experts}

    def check(self) -> None:
        """Invariant sweep: slot map and catalog agree, pins only on
        residents, wanted entries never resident, staged and resident
        entries hold params, and the HubStats conservation laws hold."""
        with self._lock:
            for s, e in enumerate(self._slot_expert):
                if e is not None:
                    c = self.catalog[e]
                    assert c.state == "resident" and c.slot == s, (s, c)
            for e, c in enumerate(self.catalog):
                if c.state == "resident":
                    assert self._slot_expert[c.slot] == e, (e, c)
                else:
                    assert c.slot == -1, (e, c)
                    assert c.pins == 0, \
                        f"pins on non-resident {c.name!r}"
                if c.state in ("staged", "resident"):
                    assert c.params is not None, \
                        f"{c.state} entry {c.name!r} published no params"
            assert all(self.catalog[e].state != "resident"
                       for e in self._wanted)
            st = self.stats
            assert st.loads == st.commit_count, \
                f"loads {st.loads} != commits {st.commit_count}"
            in_flight = len(self._staging)
            assert st.stage_attempts == (st.stage_count
                                         + st.stage_failures
                                         + in_flight), (
                f"stage conservation broke: {st.stage_attempts} "
                f"attempts vs {st.stage_count} published + "
                f"{st.stage_failures} failed + {in_flight} in flight")
