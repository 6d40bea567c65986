"""Serving subsystem: router -> scheduler -> expert engines (ring KV
layout, one engine per expert).

  * ``Router`` — ExpertMatcher scoring through the routing kernels, with
    bounded row buckets and a client-fingerprint LRU.
  * ``Scheduler`` — per-expert admission queues with length-bucketed
    continuous micro-batching.
  * ``EngineCore`` / ``ExpertEngine`` — resident waves, device-side token
    state, one batched harvest copy per wave.
  * ``DispatchExecutor`` (``serial`` / ``overlapped``) — whether a step
    blocks per decode tick or enqueues all shards' work first.
"""
from .core import (DispatchExecutor, EngineCore, EngineStats,
                   OverlappedExecutor, SerialExecutor, bucket_for,
                   get_executor, make_buckets)
from .engine import ExpertEngine
from .router import PrefixLRU, Router, RouteResult
from .scheduler import (Request, Response, RoutedServer, Scheduler,
                        SchedulerConfig, SchedulerStats, Shard)

__all__ = [
    "DispatchExecutor", "EngineCore", "EngineStats", "ExpertEngine",
    "OverlappedExecutor", "PrefixLRU", "Request", "Response",
    "RouteResult", "RoutedServer", "Router", "Scheduler",
    "SchedulerConfig", "SchedulerStats", "SerialExecutor", "Shard",
    "bucket_for", "get_executor", "make_buckets",
]
