"""Unified metrics: Counter / Gauge / Histogram + the snapshot registry.

The hot-path rule: **no numpy**. ``Histogram.observe`` is a ``bisect``
into a fixed tuple of bucket bounds — scheduler latency accounting runs
once per request, on the serving thread, and must never pay an array
allocation. Bucket bounds are declared as literals (rule O003) so a
reviewer can read the resolution straight off the call site and no
runtime computation can silently produce degenerate buckets.

The :class:`MetricsRegistry` is the one snapshot tree. Producers
register under a slash path (``engines/shard0``, ``hub``, ``kv/...``)
either a metric instance or a zero-argument provider (a callable
returning a dict/scalar, or an object with ``as_dict``) — providers are
pulled lazily at ``snapshot()`` so registration costs nothing on the
hot path and the tree always reflects live state.

Naming convention (see docs/architecture.md "Observability"):
top-level groups are ``scheduler``, ``engines/<shard>``, ``kv/<shard>``,
``hub``, ``router``, ``executor``; leaves are snake_case counters in
base units (``*_ms`` for milliseconds, ``*_s`` for seconds).
"""
from __future__ import annotations

from bisect import bisect_left
from typing import Any, Callable, Dict, List, Tuple, Union

#: Default latency buckets, milliseconds — log-spaced from 50µs to 5s.
#: A literal on purpose (rule O003): bucket resolution is part of the
#: observability contract, not a runtime computation.
DEFAULT_MS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                      25.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
                      2500.0, 5000.0)


class Counter:
    """Monotonic counter."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self, value: float = 0.0) -> None:
        self.value = value

    def set(self, value: float) -> None:
        self.value = value


class Histogram:
    """Fixed-bucket histogram (cumulative-style bounds, +inf implicit).

    ``buckets`` must be an ascending sequence of numeric literals
    (O003). ``observe`` is one ``bisect`` + two adds — pure Python, no
    numpy, safe on the serving thread.
    """

    __slots__ = ("buckets", "counts", "count", "sum", "max")

    def __init__(self, buckets: Tuple[float, ...] = DEFAULT_MS_BUCKETS):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(b2 <= b1 for b1, b2 in
                             zip(bounds, bounds[1:])):
            raise ValueError(
                f"histogram buckets must be non-empty ascending, "
                f"got {buckets!r}")
        self.buckets = bounds
        self.counts = [0] * (len(bounds) + 1)   # last = overflow
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def observe(self, value: float) -> None:
        self.counts[bisect_left(self.buckets, value)] += 1
        self.count += 1
        self.sum += value
        if value > self.max:
            self.max = value

    def percentile(self, q: float) -> float:
        """Upper-bound estimate: the smallest bucket bound whose
        cumulative count covers the ``q`` quantile (the overflow bucket
        reports the true max). 0.0 on an empty histogram."""
        if self.count == 0:
            return 0.0
        need = q * self.count
        seen = 0
        for bound, n in zip(self.buckets, self.counts):
            seen += n
            if seen >= need:
                return bound
        return self.max

    def snapshot(self) -> Dict[str, float]:
        mean = self.sum / self.count if self.count else 0.0
        return {"count": self.count, "sum": self.sum, "mean": mean,
                "p50": self.percentile(0.50),
                "p95": self.percentile(0.95),
                "p99": self.percentile(0.99),
                "max": self.max}


Provider = Union[Counter, Gauge, Histogram, Callable[[], Any]]


def _resolve(provider: Any) -> Any:
    if isinstance(provider, (Counter, Gauge)):
        return provider.value
    if isinstance(provider, Histogram):
        return provider.snapshot()
    if callable(provider):
        return _resolve(provider())
    if hasattr(provider, "as_dict"):
        return _resolve(provider.as_dict())
    if isinstance(provider, dict):
        return {k: _resolve(v) for k, v in provider.items()}
    return provider


class MetricsRegistry:
    """The snapshot tree: slash-path → provider, resolved lazily.

    Re-registering a path replaces the provider (servers rebind after
    reconfiguration); registering under a path that already has leaves
    merges at snapshot time, later registrations winning on key clashes.
    """

    def __init__(self) -> None:
        self._providers: List[Tuple[Tuple[str, ...], Provider]] = []

    def register(self, path: str, provider: Provider) -> None:
        if not path:
            raise ValueError("metrics path must be non-empty")
        key = tuple(path.split("/"))
        self._providers = [(k, p) for k, p in self._providers
                           if k != key]
        self._providers.append((key, provider))

    def snapshot(self) -> Dict[str, Any]:
        """Resolve every provider into one nested dict."""
        tree: Dict[str, Any] = {}
        for key, provider in self._providers:
            node = tree
            for part in key[:-1]:
                node = node.setdefault(part, {})
                if not isinstance(node, dict):
                    raise TypeError(
                        f"metrics path {'/'.join(key)} descends through "
                        f"a leaf")
            resolved = _resolve(provider)
            leaf = key[-1]
            if isinstance(resolved, dict) and isinstance(
                    node.get(leaf), dict):
                node[leaf].update(resolved)
            else:
                node[leaf] = resolved
        return tree
