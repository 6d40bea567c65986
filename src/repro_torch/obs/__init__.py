"""repro_torch.obs — zero-dependency tracing + metrics for the port's
serving path (own copies of the reference package's pure-stdlib modules).

``trace``
    Request-lifecycle spans: a :class:`Tracer` mints per-request trace
    ids at ``Scheduler.submit``; each scheduler step is a ``sched.step``
    span with its phases as children; device work uses
    ``begin_device``/``end_device`` pairs that close only at the engine's
    existing harvest sync point, and ``device_range`` CUDA-event ranges
    folded once their events have completed, so tracing adds no host
    blocks.

``metrics``
    ``Counter`` / ``Gauge`` / ``Histogram`` plus the
    :class:`MetricsRegistry` snapshot tree the scheduler builds.
"""
from .metrics import (DEFAULT_MS_BUCKETS, Counter, Gauge, Histogram,
                      MetricsRegistry)
from .trace import NULL_TRACER, Tracer

__all__ = [
    "Counter",
    "DEFAULT_MS_BUCKETS",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_TRACER",
    "Tracer",
]
