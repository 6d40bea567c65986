"""What the readers of the program's own spans and device ranges share
(``repro_torch.obs.trace``): the tracer's records of one name over the
measured window, put on the host's clock through ``ctx.tracer_offset``,
less every record that overlaps the stretch a traced run profiles, so
that the profiler's cost does not reach them. A program that records no
such span gives an empty list, and its reader None."""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

Interval = Tuple[float, float, Dict[str, Any]]


def _stretch(ctx) -> Optional[Tuple[float, float]]:
    t = ctx.window.traced
    if not t or t.get("host_t0") is None or t.get("host_t1") is None:
        return None
    return t["host_t0"], t["host_t1"]


def window_records(ctx, name: str, cat: Optional[str] = None
                   ) -> List[Interval]:
    """(start, end, record) on the host's clock of every record ``name``
    (of category ``cat``) that meets the window, from its open to the
    harvest of its last job, and does not meet the profiled stretch."""
    w = ctx.window
    if ctx.records is None or w.finish is None:
        return []
    lo, hi = w.start, w.finish
    cut = _stretch(ctx)
    out = []
    for r in ctx.records:
        if r["name"] != name or (cat is not None and r["cat"] != cat):
            continue
        a = r["ts"] / 1e6 + ctx.tracer_offset
        b = a + r["dur"] / 1e6
        if b <= lo or a >= hi:
            continue
        if cut is not None and a < cut[1] and b > cut[0]:
            continue
        out.append((a, b, r))
    return out


def open_seconds(ctx) -> float:
    """The window's seconds outside the profiled stretch."""
    w = ctx.window
    s = w.finish - w.start
    cut = _stretch(ctx)
    if cut is not None:
        s -= max(0.0, min(cut[1], w.finish) - max(cut[0], w.start))
    return s


def share_pct(ctx, name: str, cat: str) -> Optional[float]:
    """The time the records ``name`` cover, clipped to the window, over
    the window's seconds outside the profiled stretch, in %."""
    recs = window_records(ctx, name, cat)
    if not recs:
        return None
    w = ctx.window
    busy = sum(min(b, w.finish) - max(a, w.start) for a, b, _ in recs)
    return 100.0 * busy / open_seconds(ctx)
