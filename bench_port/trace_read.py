"""Reads one ``torch.profiler`` trace into what the per-layer metrics and
the result's ``breakdown`` need: the traced window, the device's busy
time, device time by operation name, the kernels that graph replays ran,
and the device's idle gaps by what the host was doing (the innermost
host operation running when the gap opened, with its input shapes).

Device work is every kernel, copy and memset the trace records. A
kernel belongs to a graph replay when its CUPTI correlation id is that
of a ``cudaGraphLaunch`` call.
"""
from __future__ import annotations

import bisect
from typing import Any, Dict, List, Tuple

MIN_GAP_NS = 2_000          # idle gaps shorter than this are not named


def union_ns(iv: List[Tuple[int, int]], lo: int, hi: int) -> int:
    """Length of the union of intervals ``iv`` clipped to [lo, hi]."""
    total, cur_a, cur_b = 0, None, None
    for a, b in sorted(iv):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def gaps_ns(iv: List[Tuple[int, int]], lo: int, hi: int
            ) -> List[Tuple[int, int]]:
    """The stretches of [lo, hi] that no interval of ``iv`` covers."""
    out, t = [], lo
    for a, b in sorted(iv):
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def read_profile(results) -> Dict[str, Any]:
    """The numbers the readers take from one profile's raw results (see
    module doc)."""
    import torch
    events = list(results.events())
    cuda = torch.autograd.DeviceType.CUDA
    dev, host, launches = [], [], set()
    for e in events:
        a = int(e.start_ns())
        b = a + int(e.duration_ns())
        name = e.name()
        if e.device_type() == cuda:
            kind = "kernel" if not name.startswith(("Memcpy", "Memset")) \
                else "copy"
            dev.append((a, b, name, int(e.correlation_id()), kind))
        else:
            shapes = [list(x) for x in (e.shapes() or []) if x]
            host.append((a, b, f"{name} {shapes}" if shapes else name))
            if "GraphLaunch" in name:
                launches.add(int(e.correlation_id()))
    if not host:
        return {"busy_s": 0.0, "window_s": 0.0, "by_name": {},
                "graph_kernel_s": 0.0, "graph_launches": 0,
                "graph_kernels": 0, "idle_by_host": {}}
    lo = min(a for a, _, _ in host)
    hi = max(b for _, b, _ in host)
    iv = [(a, b) for a, b, _, _, _ in dev]
    by_name: Dict[str, List[float]] = {}
    g_s, g_n = 0.0, 0
    for a, b, name, c, kind in dev:
        t = by_name.setdefault(name, [0.0, 0])
        t[0] += (b - a) / 1e9
        t[1] += 1
        if kind == "kernel" and c in launches:
            g_s += (b - a) / 1e9
            g_n += 1
    host.sort()
    starts = [a for a, _, _ in host]
    idle: Dict[str, float] = {}
    for a, b in gaps_ns(iv, lo, hi):
        if b - a < MIN_GAP_NS:
            continue
        i = bisect.bisect_right(starts, a) - 1
        name = "(none)"
        lim = i - 500
        while i >= max(lim, 0):
            if host[i][1] >= a:
                name = host[i][2]
                break
            i -= 1
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e9
    return {"busy_s": union_ns(iv, lo, hi) / 1e9, "window_s": (hi - lo) / 1e9,
            "by_name": by_name, "graph_kernel_s": g_s,
            "graph_launches": len(launches), "graph_kernels": g_n,
            "idle_by_host": idle}


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without its parameter list, return type and
    anonymous namespaces, cut to ``width`` characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name[:width]


def top(d: Dict[str, Any], n: int = 10) -> List[List[Any]]:
    """The ``n`` largest [name, seconds] of a name -> seconds (or [seconds,
    count]) map, names shortened (``short_name``)."""
    items = [(k, v[0] if isinstance(v, list) else v) for k, v in d.items()]
    return [[short_name(k), v]
            for k, v in sorted(items, key=lambda kv: -kv[1])[:n]]
