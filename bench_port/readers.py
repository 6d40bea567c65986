"""What the metric readers (``metrics/<name>.py``) share. A reader gets one
``Context`` and returns a number, or None where its run gives it nothing
to read (the harness then leaves the metric out of the result line)."""
from __future__ import annotations

import bisect
import dataclasses
from typing import Any, Dict, List, Optional, Tuple


from . import counts
from .check import length_bucket


@dataclasses.dataclass
class Context:
    cell: str
    cfg: Dict[str, Any]
    arch: Any
    mix: Dict[str, Any]
    seconds: float
    setup_s: float
    window: Any                       # driver.Window
    records: Optional[List[Dict[str, Any]]] = None   # tracer records
    tracer_offset: float = 0.0        # host clock - tracer ts (seconds)


def span_s(ctx: Context) -> Optional[float]:
    """Seconds from the window's open to the harvest of the last response
    of its jobs (None where one never came)."""
    w = ctx.window
    return None if w.finish is None else w.finish - w.start


def served(ctx: Context) -> List[Any]:
    """The records of the window's jobs whose response came back."""
    return [r for r in ctx.window.records.values() if r.tokens is not None]


def engine_delta(ctx: Context, key: str) -> int:
    w = ctx.window
    return sum(w.stats1[n][key] - w.stats0[n][key] for n in w.stats1)


def rows_per_replay(ctx: Context) -> Optional[float]:
    steps = engine_delta(ctx, "decode_steps")
    if not steps:
        return None
    return (engine_delta(ctx, "tokens_generated")
            - engine_delta(ctx, "rows_served")) / steps


def traced(ctx: Context) -> Optional[Dict[str, Any]]:
    t = ctx.window.traced
    return t if t and t.get("window_s") else None


def device_idle_pct(ctx: Context) -> Optional[float]:
    t = traced(ctx)
    if t is None or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def kernel_time(ctx: Context, *needles: str) -> Tuple[float, int]:
    """(device seconds, launches) of the traced kernels whose name holds
    every one of ``needles``."""
    t = traced(ctx)
    s, n = 0.0, 0
    for name, (sec, cnt) in (t["by_name"].items() if t else []):
        if all(k in name for k in needles):
            s += sec
            n += cnt
    return s, n


def ticks_agree(ctx: Context, ticks, launches: int) -> bool:
    """Whether the decode steps rebuilt from the tracer (``wave_ticks``)
    are the ones the engines counted over the traced steps, and the trace
    holds launches of the kernel. The count is checked against the
    program's counter, not against the trace's kernel records: at a few
    hundred thousand kernels a second the profiler drops some records
    (2-6% in the batch cells' stretches), so the trace's launches are a
    sample, which a reader takes the mean of."""
    t = traced(ctx)
    return bool(ticks) and bool(launches) and t is not None \
        and len(ticks) == t["decode_steps"]


def _step_of(ctx: Context, t_host: float) -> int:
    starts = [s for s, _ in ctx.window.steps]
    return bisect.bisect_right(starts, t_host) - 1


def wave_ticks(ctx: Context) -> Optional[List[Tuple[int, int, int]]]:
    """(batch bucket, real rows, live cache slots) of every decode step a
    wave took in the traced steps, rebuilt from the tracer's
    ``wave.prefill`` spans and ``wave.chunk`` events: a wave becomes
    decode-eligible in the step that admits it (or that dispatches its
    last prefill chunk) and then steps once every scheduler step until
    its longest row has its tokens; at its j-th step it has Sb + j + 1
    live slots."""
    t = traced(ctx)
    if t is None or ctx.records is None:
        return None
    k0, k1 = t["first_step"], t["last_step"]
    by_uid = {r.spec.uid: r.spec for r in ctx.window.records.values()}
    waves: Dict[int, Dict[str, Any]] = {}
    recs = [(r["name"], r["args"], r["ts"] / 1e6 + ctx.tracer_offset)
            for r in ctx.records]
    for name, a, at in recs:
        if name == "wave.prefill":
            new = [by_uid[u].max_new for u in a.get("uids", [])
                   if u in by_uid]
            if new:
                waves[a["wave"]] = {"Bb": a["Bb"], "Sb": a["Sb"],
                                    "rows": a["rows"], "steps": max(new) - 1,
                                    "start": _step_of(ctx, at),
                                    "chunked": a.get("chunks", 0) > 0}
    # a chunked wave decodes from the step that dispatches its last chunk
    # (its span is recorded later, at the harvest that closes it)
    for name, a, at in recs:
        w = waves.get(a.get("wave")) if name == "wave.chunk" else None
        if w is not None and a.get("remaining") == 0:
            w["start"] = _step_of(ctx, at)
            w["chunked"] = False
    out = []
    for w in waves.values():
        if w["chunked"]:
            continue
        for j in range(w["steps"]):
            if k0 <= w["start"] + j <= k1:
                out.append((w["Bb"], w["rows"], w["Sb"] + j + 1))
    return out


def useful_flops(ctx: Context) -> float:
    """The model work of every request of the window's jobs
    (``counts.request_flops``: real prompt tokens and decode steps)."""
    fl = ctx.cfg["fleet"]
    lo, hi = int(fl.get("min_len_bucket", 8)), int(fl["max_len"])
    total = 0.0
    for r in served(ctx):
        p = len(r.spec.prompt)
        total += counts.request_flops(ctx.arch, p, length_bucket(p, lo, hi),
                                      len(r.tokens))
    return total
