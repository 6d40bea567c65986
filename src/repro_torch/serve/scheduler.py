"""Admission queue + continuous micro-batching scheduler (Fig. 2 of the
paper as a serving system).

Life of a request:

  submit() -> Router.route (fingerprint LRU + the routing kernels,
              shard ids from the placement plan)
           -> per-expert FIFO queue, sub-bucketed by prompt-length bucket
  step()   -> the dispatch executor runs one round over all shards:
              the expert hub's lifecycle round (commit staged experts
              into slots, kick staging), then admission (per shard, pick
              one length bucket — fullest wins, with age-based promotion
              so sparse buckets can't starve — and admit one dispatch
              group: a banked shard's wave holds every member's
              micro-batch; a paged engine pulls the head row's
              prompt-prefix cohort into the same wave and requeues the
              rows when its page pool is exhausted; a hub shard parks the
              rows of a non-resident expert), then pending prefill chunks
              under the step's token budget, then decode (every shard
              with resident waves advances one token; one tick per bank),
              then engine harvest. With the default ``overlapped``
              executor every prefill and decode tick is *enqueued* before
              anything blocks; ``executor="serial"`` keeps the blocking
              per-tick reference behaviour.
           -> harvest: finished rows become Responses immediately,
              demuxed through the shard's expert list (a hub's through
              each row's routed expert)
  drain()  -> step() until all queues and engines are empty

Queues persist across calls, so requests submitted in *different*
``submit`` calls coalesce into the same micro-batch.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.matcher import ExpertMatcher
from ..core.registry import ExpertRegistry
from ..device import resolve_device
from ..obs.metrics import Counter, Histogram, MetricsRegistry
from ..obs.trace import NULL_TRACER
from .core import DispatchExecutor, get_executor
from .engine import ExpertEngine
from .hub import ExpertHub, HubMember, NotResident
from .kvcache import PagePoolExhausted
from .placement import BankMember, PlacementPlan, Shard
from .router import PrefixLRU, Router


@dataclasses.dataclass
class Request:
    uid: int
    features: np.ndarray            # (784,) matcher fingerprint
    prompt: np.ndarray              # (S,) int32 tokens
    max_new_tokens: int = 8
    expert: Optional[int] = None    # pre-routed: skip the matcher (the
    #                                 paper's repeat clients know their
    #                                 expert; also the hub's long tail)


@dataclasses.dataclass
class Response:
    uid: int
    expert: str
    fine_class: int
    tokens: np.ndarray
    coarse_scores: Optional[np.ndarray] = None
    shard: int = -1                 # placement shard that served the row


#: the CUDA caching allocator's counters whose per-step deltas a traced
#: ``sched.step`` carries: cache flushes (and the syncs they hide) show
#: as retries, all-stream syncs and device allocs / frees
ALLOC_COUNTERS = ("num_alloc_retries", "num_sync_all_streams",
                  "num_device_alloc", "num_device_free")


@dataclasses.dataclass
class SchedulerConfig:
    max_batch: int = 16             # micro-batch row cap (per expert)
    max_queue: int = 4096           # admission queue cap (backpressure)
    promote_after: int = 4          # rounds a waiting bucket may be
    #                                 skipped before it wins admission
    check_every: int = 0            # >0: run check_invariants() every N
    #                                 steps (PagePool.check on every
    #                                 paged shard, the hub's state
    #                                 machine and pin conservation)
    prefill_tokens_per_step: int = 0
    #                                 per-shard prompt-token budget for
    #                                 pending prefill chunks each step
    #                                 (0 = unbounded); at least one chunk
    #                                 always dispatches
    speculate_k: Optional[int] = None
    #                                 None takes each engine as it was
    #                                 built; an int asserts every tickable
    #                                 shard engine was built with exactly
    #                                 that speculate_k (engines own their
    #                                 verify steps)


@dataclasses.dataclass(frozen=True)
class SchedulerStats:
    """Immutable snapshot of the scheduler's counters; ``as_dict()`` is
    the shape the metrics registry snapshots."""
    submitted: int = 0
    rejected: int = 0
    batches: int = 0
    ticks: int = 0
    responses: int = 0
    promotions: int = 0
    orphaned: int = 0
    kv_stalls: int = 0
    resident_stalls: int = 0
    invariant_checks: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _Pending:
    req: Request
    fine: int
    scores: np.ndarray
    shard: int = -1
    seq: int = 0                    # submit order, for age promotion
    prefix_key: bytes = b""         # prompt-prefix cohort key (PrefixLRU)
    expert: int = -1                # routed expert (hub demux + unpin)
    # lifecycle accounting (tracer clock, seconds): queue time is
    # submit -> admit minus the stalled share; ``stall_since`` is open
    # while the row is parked on NotResident / PagePoolExhausted
    # backpressure
    trace: int = 0                  # trace id (0 when tracing is off)
    t_submit: float = 0.0
    t_admit: float = 0.0
    stalled_s: float = 0.0
    stall_since: Optional[float] = None


class Scheduler:
    """Routes, queues, batches and ticks a fleet of expert shards: one
    engine per expert, banks from a ``PlacementPlan``, or an
    ``ExpertHub``'s slot bank over its whole catalog."""

    def __init__(self, router: Optional[Router],
                 registry: ExpertRegistry,
                 config: Optional[SchedulerConfig] = None,
                 placement: Optional[PlacementPlan] = None,
                 executor: "str | DispatchExecutor" = "overlapped",
                 hub: Optional[ExpertHub] = None, tracer=None):
        self.router = router
        self.registry = registry
        self.config = config or SchedulerConfig()
        self.hub = hub
        self.executor = get_executor(executor)
        if hub is not None:
            if placement is not None:
                raise ValueError("hub and placement are exclusive: the "
                                 "hub owns its own slot bank")
            if len(hub) != len(registry):
                raise ValueError(
                    f"hub catalog ({len(hub)} experts) does not match "
                    f"the registry ({len(registry)}); build the "
                    "registry via hub.build_registry()")
            for e in range(len(registry)):
                be = registry[e].backend
                if not (isinstance(be, HubMember) and be.hub is hub
                        and be.expert == e):
                    # a same-length foreign registry would serve through
                    # the hub's slots under the wrong expert names
                    raise ValueError(
                        f"registry entry {e} ({registry[e].name!r}) is "
                        "not this hub's HubMember; build the registry "
                        "via hub.build_registry()")
            # one shard over the whole catalog: every wave is served by
            # the hub's slot bank, groups keyed by slot
            self.shards = [Shard(sid=0,
                                 experts=tuple(range(len(registry))),
                                 bank=hub.bank)]
        elif placement is not None:
            # the plan must describe THIS registry: a stale plan would
            # serve with another registry's experts' params
            missing = set(range(len(registry))) - set(placement.shard_of)
            if missing:
                raise ValueError(
                    f"placement plan does not cover experts "
                    f"{sorted(missing)} (registry grown after "
                    f"plan_placement?); re-plan on this registry")
            for shard in placement.shards:
                if not shard.banked:
                    continue
                for local, e in enumerate(shard.experts):
                    be = registry[e].backend if e < len(registry) else None
                    if not (isinstance(be, BankMember)
                            and be.bank is shard.bank
                            and be.local == local):
                        raise ValueError(
                            f"placement plan does not match registry at "
                            f"expert {e}; re-plan with plan_placement "
                            f"on this registry")
            self.shards = list(placement.shards)
        else:  # every expert is its own dispatch group
            for e in range(len(registry)):
                if isinstance(registry[e].backend, BankMember):
                    raise ValueError(
                        f"expert {registry[e].name!r} is bank-placed "
                        "(plan_placement rebound its backend to a "
                        "BankMember); pass that PlacementPlan via "
                        "placement=")
            self.shards = [Shard(sid=e, experts=(e,))
                           for e in range(len(registry))]
        self._shard_of = {e: s.sid for s in self.shards for e in s.experts}
        if self.config.speculate_k is not None:
            want = int(self.config.speculate_k)
            for shard in self.shards:
                eng = self._shard_engine(shard)
                if eng is not None and eng.core.speculate_k != want:
                    raise ValueError(
                        f"SchedulerConfig.speculate_k={want} but shard "
                        f"{shard.sid}'s engine was built with speculate_k="
                        f"{eng.core.speculate_k}; rebuild its engine with "
                        "the matching speculate_k")
        # queues[expert][len_bucket] -> FIFO of _Pending
        self.queues: Dict[int, Dict[int, collections.deque]] = \
            collections.defaultdict(lambda: collections.defaultdict(
                collections.deque))
        self.n_queued = 0
        self._seq = 0
        self._skips: Dict[Tuple[int, int], int] = \
            collections.defaultdict(int)   # (shard, bucket) skip rounds
        self._counters: Dict[str, Counter] = {
            f.name: Counter() for f in dataclasses.fields(SchedulerStats)}
        self._steps = 0
        self._step_waves = self._step_rows = self._step_replays = 0
        self._alloc_dev: Optional[torch.device] = None
        self._alloc_prev: Optional[Dict[str, int]] = None
        self._done: List[Response] = []
        self._meta: Dict[int, _Pending] = {}   # uid -> routing info
        # prompt-prefix cohort detection, keyed at the page granularity of
        # the first paged engine (8 when every shard rings)
        page = next((self._shard_engine(s).core.page for s in self.shards
                     if self._paged_shard(s)), 8)
        self.prefix_lru = PrefixLRU(page=page)
        self._h_queue = Histogram()
        self._h_stalled = Histogram()
        self.tracer = NULL_TRACER
        self.bind_tracer(tracer)
        self.obs = self._build_metrics()

    @property
    def stats(self) -> SchedulerStats:
        """Frozen point-in-time snapshot of the scheduler counters."""
        return SchedulerStats(**{k: c.value
                                 for k, c in self._counters.items()})

    def bind_tracer(self, tracer) -> None:
        """Install a lifecycle tracer here, on every engine core and on
        the hub (None restores the disabled NULL_TRACER)."""
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._alloc_dev = self._alloc_prev = None
        for shard in self.shards:
            eng = self._shard_engine(shard)
            if eng is not None:
                eng.core.bind_tracer(self.tracer, engine=shard.sid)
                if self._alloc_dev is None and eng.device.type == "cuda":
                    self._alloc_dev = eng.device
        if self.hub is not None:
            self.hub.bind_tracer(self.tracer)
        if self.tracer.enabled:
            self._alloc_deltas()      # the first step's baseline

    def _alloc_deltas(self) -> Dict[str, int]:
        """The allocator counters' change since the last call (one
        ``memory_stats`` read; nothing without a card or before a
        baseline)."""
        if self._alloc_dev is None:
            return {}
        st = torch.cuda.memory_stats(self._alloc_dev)
        now = {k: int(st.get(k, 0)) for k in ALLOC_COUNTERS}
        prev, self._alloc_prev = self._alloc_prev, now
        return {} if prev is None else {k: now[k] - prev[k]
                                        for k in ALLOC_COUNTERS}

    def _build_metrics(self) -> MetricsRegistry:
        """The snapshot tree: scheduler counters + queue and stall
        latency, every shard engine's ``EngineStats`` (and its draft's
        identity where it speculates), every paged shard's page pool
        counters, the router and the hub."""
        obs = MetricsRegistry()
        obs.register("scheduler", lambda: self.stats.as_dict())
        obs.register("scheduler/latency/queue_ms", self._h_queue)
        obs.register("scheduler/latency/stalled_ms", self._h_stalled)
        obs.register("executor", lambda: {"name": self.executor.name})
        for shard in self.shards:
            eng = self._shard_engine(shard)
            if eng is not None:
                obs.register(f"engines/shard{shard.sid}",
                             (lambda e=eng: e.stats.as_dict()))
                if eng.core.pool is not None:
                    obs.register(f"kv/shard{shard.sid}",
                                 eng.core.pool.telemetry)
                if eng.core.draft is not None:
                    obs.register(f"engines/shard{shard.sid}/draft",
                                 eng.core.draft.describe())
        if self.router is not None:
            obs.register("router", self._router_metrics)
        if self.hub is not None:
            obs.register("hub", self.hub.metrics_snapshot)
        return obs

    def _router_metrics(self) -> Dict[str, Any]:
        r = self.router
        return {**r.stats, "expert_hits": dict(r.expert_hits),
                "prefix_lru": dict(self.prefix_lru.stats)}

    def speculative_stats(self) -> Dict[str, Any]:
        """Speculative-decoding counters summed over every tickable
        shard."""
        drafted = accepted = verifies = fallback = 0
        for shard in self.shards:
            eng = self._shard_engine(shard)
            if eng is None:
                continue
            st = eng.stats
            drafted += st.tokens_drafted
            accepted += st.tokens_accepted
            verifies += st.verify_steps
            fallback += st.spec_fallback_waves
        return {"tokens_drafted": drafted, "tokens_accepted": accepted,
                "verify_steps": verifies, "spec_fallback_waves": fallback,
                "acceptance_rate": accepted / drafted if drafted else 0.0}

    # -- admission -------------------------------------------------------
    def submit(self, requests: Sequence[Request]) -> int:
        """Route and enqueue; returns how many were admitted — always a
        prefix of ``requests``, so callers can resubmit the tail later.
        uids must be unique among in-flight requests. Requests carrying
        ``expert=`` are pre-routed: they skip the matcher (and are the
        only kind a router-less hub scheduler takes) but still feed the
        popularity counter the hub's eviction reads."""
        if not requests:
            return 0
        batch_seen = set()
        for r in requests:
            if r.uid in self._meta or r.uid in batch_seen:
                raise ValueError(f"duplicate in-flight uid {r.uid}")
            batch_seen.add(r.uid)
        room = max(self.config.max_queue - self.n_queued, 0)
        self._counters["rejected"].inc(
            len(requests) - min(len(requests), room))
        requests = requests[:room]
        if not requests:
            return 0
        miss = [i for i, r in enumerate(requests) if r.expert is None]
        if miss and self.router is None:
            raise ValueError(
                "scheduler has no router: every request must be "
                "pre-routed (Request.expert set)")
        routed = None
        if miss:
            with self.tracer.span("route", rows=len(miss),
                                  uids=[requests[i].uid for i in miss]):
                routed = self.router.route(np.stack(
                    [requests[i].features for i in miss]))
        routed_at = {i: j for j, i in enumerate(miss)}
        top_k = routed.coarse.shape[1] if routed is not None else 1
        admitted = 0
        for i, r in enumerate(requests):
            if r.expert is not None:
                e, fine = int(r.expert), 0
                if not 0 <= e < len(self.registry):
                    raise ValueError(f"pre-routed expert {e} out of "
                                     f"range [0, {len(self.registry)})")
                scores = np.zeros(top_k, np.float32)
                sid = self._shard_of.get(e, -1)
                # pre-routed hits go through the hub's locked mutation
                # point: the shared Counter is read by its eviction
                if self.hub is not None:
                    self.hub.note_hit(e)
                elif self.router is not None:
                    self.router.expert_hits[e] += 1
            else:
                j = routed_at[i]
                e = int(routed.coarse[j, 0])
                fine = int(routed.fine[j])
                scores = routed.coarse_score[j]
                sid = (int(routed.shard[j]) if routed.shard is not None
                       else self._shard_of.get(e, -1))
            engine = self.registry[e].backend
            sb = (engine.pad_shape(1, len(r.prompt))[1]
                  if hasattr(engine, "pad_shape") else len(r.prompt))
            self._seq += 1
            p = _Pending(r, fine, scores, shard=sid, seq=self._seq,
                         prefix_key=self.prefix_lru.observe(r.prompt),
                         expert=e, t_submit=self.tracer.now())
            if self.tracer.enabled:
                p.trace = self.tracer.next_id()
                self.tracer.bind_uid(r.uid, p.trace)
                self.tracer.event("request.submit", uid=r.uid,
                                  trace=p.trace, expert=e, shard=sid,
                                  prompt_len=len(r.prompt),
                                  max_new=int(r.max_new_tokens))
            self.queues[e][sb].append(p)
            self._meta[r.uid] = p
            self.n_queued += 1
            admitted += 1
        self._counters["submitted"].inc(admitted)
        return admitted

    # -- one scheduling round -------------------------------------------
    def step(self) -> List[Response]:
        """One round (``sched.step``, its phases children of it); the
        tracer then folds the device ranges that have completed."""
        tr = self.tracer
        self._step_waves = self._step_rows = self._step_replays = 0
        with tr.enqueue_span("sched.step", step=self._steps) as sp:
            self.executor.run_step(self)
            with tr.enqueue_span("sched.emit"):
                self._harvest()
                out, self._done = self._done, []
            self._counters["responses"].inc(len(out))
            if tr.enabled:
                sp.set(waves_ticked=self._step_waves,
                       replays=self._step_replays,
                       rows_admitted=self._step_rows, responses=len(out),
                       **self._alloc_deltas())
                tr.collect()
        self._steps += 1
        if (self.config.check_every
                and self._steps % self.config.check_every == 0):
            self.check_invariants()
        return out

    def drain(self) -> List[Response]:
        out: List[Response] = []
        while self.has_work:
            out.extend(self.step())
        return out

    @property
    def has_work(self) -> bool:
        if self.n_queued:
            return True
        # has_pending, not n_active: finished-but-unpolled rows count
        return any(eng is not None and eng.has_pending
                   for eng in map(self._shard_engine, self.shards))

    def check_invariants(self) -> None:
        """Under real traffic: page-pool refcount books balance on every
        paged shard (``PagePool.check``), the hub's catalog / slot state
        machine is legal (``ExpertHub.check``), and residency pins
        conserve — every pin is held by exactly one admitted, unharvested
        row. Enabled every N steps via ``SchedulerConfig.check_every``."""
        for shard in self.shards:
            if self._paged_shard(shard):
                self._shard_engine(shard).core.pool.check()
        if self.hub is not None:
            self.hub.check()
            pins = self.hub.total_pins()
            in_flight = len(self._meta) - self.n_queued
            assert pins == in_flight, (
                f"pin conservation broke: hub holds {pins} pins but "
                f"{in_flight} rows are admitted and unharvested")
        self._counters["invariant_checks"].inc()

    def close(self) -> None:
        """Shut down background machinery (the hub's staging worker);
        idempotent, safe without a hub."""
        if self.hub is not None:
            self.hub.close()

    # -- internals -------------------------------------------------------
    def _shard_engine(self, shard: Shard):
        """The tickable engine behind a shard (a bank or an
        ExpertEngine); None for stub/legacy backends that complete at
        admission."""
        if shard.banked:
            return shard.bank
        engine = self.registry[shard.experts[0]].backend
        return engine if isinstance(engine, ExpertEngine) else None

    def _paged_shard(self, shard: Shard) -> bool:
        eng = self._shard_engine(shard)
        return eng is not None and eng.kv_layout == "paged"

    def _pick_bucket(self, shard: Shard) -> Optional[int]:
        """Length bucket this shard admits this round: the fullest bucket
        wins unless a non-empty bucket has been skipped ``promote_after``
        rounds in a row — then the starving bucket with the oldest head
        wins."""
        counts: Dict[int, int] = collections.defaultdict(int)
        oldest: Dict[int, int] = {}
        for e in shard.experts:
            for sb, q in self.queues[e].items():
                if q:
                    counts[sb] += len(q)
                    oldest[sb] = min(oldest.get(sb, q[0].seq), q[0].seq)
        # prune drained buckets' counters (legacy backends key queues by
        # raw prompt length, which would grow _skips without bound)
        for key in [k for k in self._skips if k[0] == shard.sid
                    and k[1] not in counts]:
            del self._skips[key]
        if not counts:
            return None
        starving = [sb for sb in counts
                    if self._skips[(shard.sid, sb)]
                    >= self.config.promote_after]
        if starving:
            sb = min(starving, key=lambda b: oldest[b])
            self._counters["promotions"].inc()
        else:
            sb = max(counts, key=lambda b: (counts[b], -oldest[b]))
        for other in counts:
            if other != sb:
                self._skips[(shard.sid, other)] += 1
        self._skips.pop((shard.sid, sb), None)
        return sb

    def _pop(self, e: int, sb: int, cap: int,
             prefix_group: bool = False) -> List[_Pending]:
        """Take up to ``cap`` rows from one bucket queue.

        Plain FIFO normally; with ``prefix_group`` (paged shards) the
        head's prompt-prefix cohort is pulled forward so prefix-sharing
        rows land in the same wave, which is what lets the paged engine
        deduplicate their prefill and share pages. Other rows keep their
        relative order and fill any remaining capacity.
        """
        q = self.queues[e][sb]
        if prefix_group and len(q) > 1 and cap > 1:
            key = q[0].prefix_key
            idxs = [i for i, p in enumerate(q)
                    if p.prefix_key == key][:cap]
            if len(idxs) < cap:
                fill = [i for i, p in enumerate(q)
                        if p.prefix_key != key][:cap - len(idxs)]
                idxs = sorted(idxs + fill)
            picked = set(idxs)
            take = [q[i] for i in idxs]
            rest = [q[i] for i in range(len(q)) if i not in picked]
            q.clear()
            q.extend(rest)
        else:
            take = [q.popleft() for _ in range(min(len(q), cap))]
        self.n_queued -= len(take)
        if not q:
            del self.queues[e][sb]
        return take

    def _requeue(self, e: int, sb: int, take: List[_Pending]) -> None:
        """Put popped rows back at the queue front (order preserved) —
        the page pool could not host their wave this round."""
        q = self.queues[e][sb]
        for p in reversed(take):
            q.appendleft(p)
        self.n_queued += len(take)

    def _note_stall(self, event: str, e: int, sb: int) -> None:
        """Open the stall clock on every parked row in queue (e, sb) that
        isn't already stalled, and emit one ``event`` (``hub.park`` or
        ``kv.requeue``) covering exactly those rows."""
        q = self.queues[e].get(sb)
        if not q:
            return
        t = self.tracer.now()
        fresh = [p for p in q if p.stall_since is None]
        for p in fresh:
            p.stall_since = t
        if fresh and self.tracer.enabled:
            self.tracer.event(event, expert=e, rows=len(fresh),
                              uids=[p.req.uid for p in fresh],
                              traces=[p.trace for p in fresh])

    def _mark_admitted(self, takes: Sequence[List[_Pending]], sid: int,
                       sb: int) -> None:
        """Close stall clocks and stamp admission time on every row of a
        successfully admitted dispatch group."""
        t = self.tracer.now()
        rows = [p for take in takes for p in take]
        for p in rows:
            if p.stall_since is not None:
                p.stalled_s += t - p.stall_since
                p.stall_since = None
            p.t_admit = t
        self._step_rows += len(rows)
        if rows and self.tracer.enabled:
            self.tracer.event("request.admit", shard=sid, bucket=sb,
                              uids=[p.req.uid for p in rows],
                              traces=[p.trace for p in rows])

    def _finish_row(self, p: _Pending) -> None:
        """Close the row's lifecycle accounting at response emission:
        fold any open stall and split the wait into the queue / stalled
        histograms (milliseconds)."""
        t = self.tracer.now()
        if p.stall_since is not None:
            p.stalled_s += t - p.stall_since
            p.stall_since = None
        admit = p.t_admit if p.t_admit else t
        queue_s = max(admit - p.t_submit - p.stalled_s, 0.0)
        self._h_queue.observe(queue_s * 1e3)
        self._h_stalled.observe(p.stalled_s * 1e3)
        if self.tracer.enabled:
            first = self.tracer.first_token_s(p.req.uid)
            self.tracer.event(
                "request.finish", uid=p.req.uid, trace=p.trace,
                expert=p.expert, queue_ms=queue_s * 1e3,
                stalled_ms=p.stalled_s * 1e3,
                total_ms=(t - p.t_submit) * 1e3,
                first_token_ms=(None if first is None
                                else (first - p.t_submit) * 1e3))
            self.tracer.release_uid(p.req.uid)

    def _service_hub(self) -> None:
        """Drive the expert hub's lifecycle one round (no-op without a
        hub): commit staged wanted experts into slots and kick staging.
        Runs at the head of every executor step, so installs are enqueued
        before this step's prefills and decode ticks and staging I/O
        overlaps device work. With nothing active on the device the hub
        waits on staging instead of spinning the drain loop."""
        if self.hub is None:
            return
        idle = not any(eng is not None and eng.n_active
                       for eng in map(self._shard_engine, self.shards))
        self.hub.service(block=idle)

    def _admit_batches(self, *, defer: bool = False) -> None:
        """Issue one dispatch group per shard. With ``defer`` the
        prefills are only enqueued."""
        for shard in self.shards:
            sb = self._pick_bucket(shard)
            if sb is None:
                continue
            if shard.banked:
                self._admit_banked(shard, sb, defer=defer)
            else:
                self._admit_single(shard.experts[0], sb, defer=defer)

    def _admit_banked(self, shard: Shard, sb: int, *,
                      defer: bool = False) -> None:
        """One dispatch group: every member's micro-batch from the chosen
        bucket rides one bank wave, keyed by the member's local index,
        or over the hub's bank by its slot. A non-resident hub expert's
        rows park in their queue (``NotResident``) while the hub stages
        and commits it; a paged bank whose pool cannot host the wave
        requeues the rows."""
        hub, bank = self.hub, shard.bank
        paged = self._paged_shard(shard)
        cap = min(self.config.max_batch, bank.batch_buckets[-1])
        groups, popped = {}, {}
        stalled = 0
        for local, e in enumerate(shard.experts):
            if not self.queues[e].get(sb):
                continue
            key = local
            if hub is not None:
                try:
                    key = hub.acquire(e)
                except NotResident:
                    stalled += 1    # rows stay parked in their queue
                    self._note_stall("hub.park", e, sb)
                    continue
            take = self._pop(e, sb, cap, prefix_group=paged)
            if not take:
                continue
            if hub is not None:
                hub.pin(e, len(take))
            popped[e] = take
            groups[key] = ([p.req.uid for p in take],
                           [p.req.prompt for p in take],
                           [p.req.max_new_tokens for p in take])
        if stalled:
            self._counters["resident_stalls"].inc(stalled)
        if not groups:
            return
        try:
            bank.admit(groups, defer=defer)
        except PagePoolExhausted:
            # unwind pops and pins on both exits: the fatal re-raise must
            # not strand rows out of their queues or leave pins that make
            # the experts unevictable for good
            for e, take in popped.items():
                self._requeue(e, sb, take)
                if hub is not None:
                    hub.unpin(e, len(take))
            if not bank.n_active:
                raise            # pool too small for even one wave
            self._counters["kv_stalls"].inc()
            for e in popped:
                self._note_stall("kv.requeue", e, sb)
            return
        self._counters["batches"].inc()
        self._mark_admitted(list(popped.values()), shard.sid, sb)

    def _admit_single(self, e: int, sb: int, *,
                      defer: bool = False) -> None:
        engine = self.registry[e].backend
        name = self.registry[e].name
        cap = self.config.max_batch
        paged = isinstance(engine, ExpertEngine) and \
            engine.kv_layout == "paged"
        if isinstance(engine, ExpertEngine):
            cap = min(cap, engine.batch_buckets[-1])
        take = self._pop(e, sb, cap, prefix_group=paged)
        if not take:
            return
        if isinstance(engine, ExpertEngine):
            try:
                engine.admit([p.req.uid for p in take],
                             [p.req.prompt for p in take],
                             [p.req.max_new_tokens for p in take],
                             defer=defer)
            except PagePoolExhausted:
                if not engine.n_active:
                    raise      # pool too small for even one wave
                self._requeue(e, sb, take)
                self._note_stall("kv.requeue", e, sb)
                self._counters["kv_stalls"].inc()
                return
            self._counters["batches"].inc()
            self._mark_admitted([take], self._shard_of.get(e, -1), sb)
        elif engine is None:
            self._counters["batches"].inc()
            for p in take:
                self._meta.pop(p.req.uid, None)
                self._done.append(self._response(
                    p, name, np.zeros(p.req.max_new_tokens, np.int32)))
                self._finish_row(p)
        else:
            # legacy blocking engines: one padded batch call
            self._counters["batches"].inc()
            m = max(len(p.req.prompt) for p in take)
            toks = np.zeros((len(take), m), np.int32)
            for i, p in enumerate(take):
                toks[i, :len(p.req.prompt)] = p.req.prompt
            gen = np.asarray(engine.generate(
                toks, max(p.req.max_new_tokens for p in take)))
            for i, p in enumerate(take):
                self._meta.pop(p.req.uid, None)
                self._done.append(self._response(
                    p, name, gen[i, :p.req.max_new_tokens]))
                self._finish_row(p)

    def _prefill_chunks(self) -> None:
        """Issue pending prefill chunks of partially prefilled waves,
        bounded per shard by ``SchedulerConfig.prefill_tokens_per_step``
        (0 = drain). Runs between admission and decode ticks: a long
        prompt admitted with deferred chunks spends at most the budget
        per step, and the decode ticks that follow run every step. A wave
        becomes decode-eligible once its last chunk lands."""
        budget = self.config.prefill_tokens_per_step
        for shard in self.shards:
            eng = self._shard_engine(shard)
            if eng is not None and eng.core.has_pending_chunks:
                eng.core.prefill_step(budget)

    def _tick_engines(self, *, defer: bool = False) -> None:
        """Advance every shard's resident waves one token."""
        for shard in self.shards:
            eng = self._shard_engine(shard)
            if eng is not None and eng.n_active:
                r0 = eng.core.stats.decode_replays
                self._step_waves += eng.tick(defer=defer)
                self._step_replays += eng.core.stats.decode_replays - r0
                self._counters["ticks"].inc()

    def _harvest_engines(self) -> None:
        """One batched device-to-host copy per wave (at most): emit
        finished rows into each engine's poll buffer."""
        for shard in self.shards:
            eng = self._shard_engine(shard)
            if eng is not None:
                eng.harvest()

    def _harvest(self) -> None:
        for shard in self.shards:
            eng = self._shard_engine(shard)
            if eng is None:
                continue
            for item in eng.poll():
                if shard.banked:
                    local, uid, toks = item
                else:
                    uid, toks = item
                    local = 0
                if uid not in self._meta and isinstance(uid, tuple):
                    # a private uid namespace (generate(), hub warmup):
                    # rows of a call that raised mid-flight surface here
                    # with no owner
                    self._counters["orphaned"].inc()
                    continue
                p = self._meta.pop(uid)
                if self.hub is not None:
                    # hub waves key groups by slot, whose owner changes:
                    # demux through the row's routed expert and release
                    # its residency pin
                    name = self.registry[p.expert].name
                    self.hub.unpin(p.expert)
                else:
                    name = self.registry[shard.experts[local]].name
                self._done.append(self._response(
                    p, name, toks[:p.req.max_new_tokens]))
                self._finish_row(p)

    def _response(self, p: _Pending, name: str,
                  tokens: np.ndarray) -> Response:
        return Response(uid=p.req.uid, expert=name, fine_class=p.fine,
                        tokens=tokens, coarse_scores=p.scores,
                        shard=p.shard)


class RoutedServer:
    """ExpertMatcher in front of a fleet of expert shards.

    ``serve`` is submit-then-drain, returning responses in request order;
    incremental users call ``submit``/``step`` directly. ``executor``
    (``"overlapped"`` — the default — or ``"serial"``, the blocking
    reference) picks how each step drives its shards; both give identical
    tokens. ``prefill_tokens_per_step`` bounds the chunked-prefill tokens
    each paged shard issues per step; ``check_every`` runs the invariant
    checks every N steps; ``speculate_k``, where given, asserts every
    engine was built with it (``SchedulerConfig.speculate_k``).

    ``placement`` (from ``plan_placement``) serves banked shards instead
    of one engine per expert. ``hub`` (an ``ExpertHub`` whose
    ``build_registry()`` made ``registry``) serves a catalog larger than
    its device slots: non-resident experts park their rows while their
    checkpoints stage, and the router's hits drive eviction; with a hub
    ``matcher=None`` is allowed when every request is pre-routed
    (``Request.expert``). Runs on ``cuda`` unless ``device="cpu"``; the
    matcher, the engines, banks and hub must live there. ``close()``
    joins the hub's staging worker.
    """

    def __init__(self, matcher: Optional[ExpertMatcher],
                 registry: ExpertRegistry,
                 *, max_batch: int = 16, route_cache_size: int = 4096,
                 use_fine_kernel: bool = True,
                 placement: Optional[PlacementPlan] = None,
                 executor: "str | DispatchExecutor" = "overlapped",
                 hub: Optional[ExpertHub] = None, check_every: int = 0,
                 prefill_tokens_per_step: int = 0,
                 speculate_k: Optional[int] = None, tracer=None,
                 device=None):
        if matcher is None and hub is None:
            raise ValueError("matcher=None requires a hub serving "
                             "pre-routed requests")
        self.device = resolve_device(device)
        if matcher is not None:
            if len(registry) != matcher.n_experts:
                raise ValueError(f"registry holds {len(registry)} experts, "
                                 f"the matcher's bank {matcher.n_experts}")
            if matcher.device.type != self.device.type:
                raise ValueError(f"matcher lives on {matcher.device}, the "
                                 f"server runs on {self.device}")
        for e in range(len(registry)):
            be = registry[e].backend
            dev = getattr(be, "device", None)
            if isinstance(be, (ExpertEngine, BankMember, HubMember)) and \
                    dev.type != self.device.type:
                raise ValueError(f"expert {registry[e].name!r} runs on "
                                 f"{dev}, the server on {self.device}")
        self.matcher = matcher
        self.registry = registry
        self.placement = placement
        self.hub = hub
        self.router = None if matcher is None else Router(
            matcher, cache_size=route_cache_size,
            use_fine_kernel=use_fine_kernel,
            shard_of=placement.shard_of if placement else None)
        if hub is not None and self.router is not None:
            # routing feeds residency: the eviction reads the very Counter
            # route() increments, so the router's increments take the hub
            # lock from here on (hits_lock)
            hub.bind_popularity(self.router.expert_hits,
                                router=self.router)
        self.scheduler = Scheduler(
            self.router, registry,
            SchedulerConfig(max_batch=max_batch, check_every=check_every,
                            prefill_tokens_per_step=prefill_tokens_per_step,
                            speculate_k=speculate_k),
            placement=placement, executor=executor, hub=hub,
            tracer=tracer)
        #: the unified metrics registry — ``obs.snapshot()`` is the whole
        #: server's state as one nested dict
        self.obs = self.scheduler.obs

    def bind_tracer(self, tracer) -> None:
        self.scheduler.bind_tracer(tracer)

    def snapshot(self) -> Dict[str, Any]:
        return self.obs.snapshot()

    def close(self) -> None:
        """Join background threads (the hub's staging worker);
        idempotent."""
        self.scheduler.close()

    def __enter__(self) -> "RoutedServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def submit(self, requests: Sequence[Request]) -> int:
        return self.scheduler.submit(requests)

    def step(self) -> List[Response]:
        return self.scheduler.step()

    def serve(self, requests: Sequence[Request]) -> List[Response]:
        if not requests:
            return []
        got: Dict[int, Response] = {}
        todo = list(requests)
        while todo or self.scheduler.has_work:
            if todo:
                todo = todo[self.scheduler.submit(todo):]
            for r in self.scheduler.step():
                got[r.uid] = r
        return [got[r.uid] for r in requests]

    @property
    def stats(self) -> Dict:
        engines = {self.registry[e].name: self.registry[e].backend.stats
                   for e in range(len(self.registry))
                   if isinstance(self.registry[e].backend, ExpertEngine)}
        banks = {}
        for shard in self.scheduler.shards:
            if not shard.banked:
                continue
            if self.hub is not None:
                label = "hub(%d experts/%d slots)" % (
                    len(self.registry), self.hub.n_slots)
            else:
                label = "bank%d(%s)" % (shard.sid, ",".join(
                    self.registry[e].name for e in shard.experts))
            banks[label] = shard.bank.stats
        out = {"scheduler": self.scheduler.stats,
               "router": self.router.stats if self.router else {},
               "engines": engines, "banks": banks,
               "executor": self.scheduler.executor.name}
        if self.hub is not None:
            out["hub"] = self.hub.stats
        return out
