"""Serving subsystem: router -> scheduler -> expert engines (ring or
paged KV layout; one engine per expert, banks of homogeneous experts, or
an expert hub's slot bank over a larger catalog).

  * ``Router`` — ExpertMatcher scoring through the routing kernels, with
    bounded row buckets and a client-fingerprint LRU.
  * ``Scheduler`` — per-expert admission queues with length-bucketed
    continuous micro-batching.
  * ``EngineCore`` / ``ExpertEngine`` — resident waves, device-side token
    state, one batched harvest copy per wave; ``kv_layout="paged"`` adds
    the page pool with prefix sharing, copy-on-write and chunked prefill.
  * ``PagePool`` / ``PrefixCache`` — the paged layout's host-side
    allocator and shared-prefix index (``kvcache``).
  * ``DraftModel`` and its three drafts (``mlp``, ``table``,
    ``always-wrong``) — the proposers of speculative decoding
    (``ExpertEngine(speculate_k=k, draft=...)``).
  * ``plan_placement`` / ``BankedEngine`` — homogeneous experts grouped
    into one engine core, one captured step per batch bucket for all.
  * ``ExpertHub`` — a catalog of experts in a checkpoint store, staged by
    a worker thread and installed in place into a fixed bank of slots.
  * ``DispatchExecutor`` (``serial`` / ``overlapped``) — whether a step
    blocks per decode tick or enqueues all shards' work first.
"""
from .core import (DispatchExecutor, EngineCore, EngineStats,
                   OverlappedExecutor, SerialExecutor, bucket_for,
                   get_executor, make_buckets)
from .draft import (AlwaysWrongDraft, BigramTableDraft, DraftModel,
                    MLPBaselineDraft, build_draft)
from .engine import ExpertEngine
from .hub import CatalogEntry, ExpertHub, HubMember, HubStats, NotResident
from .kvcache import PagePool, PagePoolExhausted, PrefixCache, hash_chain
from .placement import (BankedEngine, BankMember, PlacementPlan, Shard,
                        plan_placement)
from .router import PrefixLRU, Router, RouteResult
from .scheduler import (Request, Response, RoutedServer, Scheduler,
                        SchedulerConfig, SchedulerStats)

__all__ = [
    "AlwaysWrongDraft", "BigramTableDraft", "DraftModel", "MLPBaselineDraft",
    "build_draft", "DispatchExecutor", "EngineCore", "EngineStats", "ExpertEngine",
    "BankedEngine", "BankMember", "CatalogEntry", "ExpertHub", "HubMember",
    "HubStats", "NotResident", "PlacementPlan", "plan_placement",
    "OverlappedExecutor", "PagePool", "PagePoolExhausted", "PrefixCache",
    "PrefixLRU", "Request", "Response",
    "RouteResult", "RoutedServer", "Router", "Scheduler",
    "SchedulerConfig", "SchedulerStats", "SerialExecutor", "Shard",
    "bucket_for", "get_executor", "hash_chain", "make_buckets",
]
