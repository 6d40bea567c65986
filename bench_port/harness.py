"""One run of one cell: build the fleet, warm it up, measure the window,
read the cell's metrics, free the program's state, judge what it served
against the plain references, and assemble the result line.

Everything a cell names is found by name under the benchmark's
directory: ``BENCHMARK.json``'s entry gives the configuration file,
``traffic/<mix>.json`` the mix, ``limits/<cell>.json`` the comparison's
limits and ``metrics/<metric>.py`` each metric's reader.
"""
from __future__ import annotations

import gc
import importlib.util
import statistics
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from . import check, driver, fleet as fleet_mod
from .driver import GRACE_S
from .loadgen import Traffic
from . import readers
from .readers import Context
from .trace_read import top

HERE = Path(__file__).resolve().parent
#: top-level modules that must not be loaded in the process that reports
BANNED = ("jax", "jaxlib", "flax", "repro")


class CellSpec:
    """What BENCHMARK.json and the files it names say about one cell."""

    def __init__(self, bench: Dict[str, Any], cell: str, root: Path):
        cells = {w["name"]: w for w in bench["workloads"]}
        if cell not in cells:
            raise KeyError(f"no workload {cell!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.cell = cells[cell]
        self.name = cell
        confs = {c["name"]: c for c in bench["configs"]}
        cfg_entry = confs[self.cell["config"]]
        self.cfg = json.loads((root / cfg_entry["file"]).read_text())
        self.mix = json.loads(
            (HERE / "traffic" / f"{self.cell['traffic']}.json").read_text())
        self.limits = json.loads(
            (HERE / "limits" / f"{cell}.json").read_text())["limits"]
        self.chips = int(self.cell["chips"])
        e2e = [m for m in bench["end_to_end"]
               if cell in m.get("workloads", [cell])]
        moved = {m["name"] for m in e2e}
        self.end_to_end = e2e
        self.per_layer = [m for m in bench["per_layer"]
                          if (cell in m["workloads"] if "workloads" in m
                              else m["moves"] in moved)]


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_port.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _warm_profiler(device) -> None:
    """Start and stop the profiler once, so that its first start (CUPTI's
    set-up) lands in set-up and not in the traced window."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        torch.zeros(1, device=device).add_(1)
        if device.type == "cuda":
            torch.cuda.synchronize()


def check_no_wrap(cfg, mix) -> None:
    """The reference runs a plain causal forward: refuse a mix whose
    longest prompt, padded to its length bucket, and longest answer
    would wrap a KV cache of ``max_len`` slots (a recurrent state has no
    slots to wrap)."""
    if cfg["family"] == "rwkv":
        return
    fl = cfg["fleet"]
    sb = check.length_bucket(int(mix["prompt_tokens"]["max"]),
                             int(fl.get("min_len_bucket", 8)),
                             int(fl["max_len"]))
    if sb + int(mix["new_tokens"]["max"]) > int(fl["max_len"]):
        raise ValueError(f"{cfg['name']} x {mix['name']}: a prompt padded "
                         f"to {sb} plus {mix['new_tokens']['max']} new "
                         f"tokens wraps the {fl['max_len']}-slot cache")


def step_times(win, seconds: float) -> str:
    """The scheduler steps' host seconds over the window (median, the
    longest), and those that start in the stretch a traced run profiles
    (``driver.stretch``): traced or not, so that a stretch slowed by
    tracing shows against the untraced runs."""
    d = [b - a for a, b in win.steps]
    if not d:
        return "none"
    lead, length = driver.stretch(seconds)
    lo, hi = win.start + lead, win.start + lead + length
    inside = [b - a for a, b in win.steps if lo <= a < hi]
    return (f"{len(d)}, median {statistics.median(d):.4f} s, longest "
            f"{max(d):.4f} s; {len(inside)} start {lead:g}-{lead + length:g} s"
            f" into the window, median "
            f"{statistics.median(inside) if inside else float('nan'):.4f} s,"
            f" sum {sum(inside):.4f} s")


def run_cell(spec: CellSpec, seed: int, seconds: float, trace: bool,
             device, t_start: float, *, control: bool = False,
             log=print) -> Dict[str, Any]:
    """One run; returns the result line's dict (and, with ``control``,
    the controls' readings under ``control``)."""
    dev = torch.device(device)
    check_no_wrap(spec.cfg, spec.mix)
    fl = fleet_mod.build(spec.cfg, seed, dev)
    traffic = Traffic(spec.mix, fl.names, fl.arch.vocab_size, seed)
    warmed = driver.warm(fl, traffic)
    if trace:
        _warm_profiler(dev)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.2f} s: {warmed['graphs_captured']} decode graphs "
        f"captured")
    win = driver.run_window(fl, traffic, seconds, trace, dev)
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else 0
    ctx = Context(spec.name, spec.cfg, fl.arch, spec.mix, seconds, setup_s,
                  win, win.tracer.records() if win.tracer else None,
                  win.tracer_offset)
    wanted = spec.per_layer if trace else spec.end_to_end
    metrics = {}
    for m in wanted:
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    done = [r for r in win.records.values() if r.done is not None]
    right = sum(r.expert == fl.names[r.spec.expert] for r in done)
    span = (f"{win.finish - win.start:.3f} s" if win.finish is not None
            else f"unfinished {GRACE_S:.0f} s past the close")
    log(f"window {seconds} s: {win.jobs} jobs of {len(win.records)} "
        f"requests, the last harvested after {span}; {len(done)} harvested; "
        f"routed to the dataset's expert {right} of {len(done)}; decode "
        f"graphs captured in the window {win.captured_in_window}")
    log("steps: " + step_times(win, seconds))
    t = win.traced
    if trace and t:
        log(f"traced {t['window_s']:.3f} s over steps {t['first_step']}-"
            f"{t['last_step']}: busy {t['busy_s']:.3f} s, "
            f"{t['graph_launches']} graph launches running "
            f"{t['graph_kernels']} kernels in {t['graph_kernel_s']:.3f} s; "
            f"{t['decode_steps']} decode steps counted, "
            f"{len(readers.wave_ticks(ctx) or [])} rebuilt from the tracer; "
            f"decode kernels traced: paged attention "
            f"{readers.kernel_time(ctx, 'decode_attention_kernel', 'PagedAddr')[1]}"
            f", wkv_step {readers.kernel_time(ctx, 'wkv_step_kernel')[1]}")
    fl.free_program()
    del ctx
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    verdict = check.judge(fl, win, spec.limits, seed, dev, control=control)
    log(f"reference check {time.perf_counter() - t0:.2f} s over "
        f"{verdict['sampled_requests']} requests, {verdict['sampled_tokens']} "
        f"served tokens")
    if win.captured_in_window:
        verdict["correct"] = False
        log("a decode graph was captured inside the window")
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": spec.chips, "memory_peak_bytes": peak}
    out: Dict[str, Any] = {"correct": bool(verdict["correct"]),
                           "attempted": verdict["attempted"],
                           "failed": verdict["failed"],
                           "metrics": metrics, "device": device_info}
    t = win.traced
    if trace and t:
        device_info["busy_s"] = t["busy_s"]
        device_info["window_s"] = t["window_s"]
        out["breakdown"] = {"device_ops": top(t["by_name"]),
                            "idle_gaps": top(t["idle_by_host"])}
    if control:
        out["control"] = verdict["control"]
    log("not compared: " + ", ".join(
        f"{k} {v!r}" for k, v in verdict["values"].items()
        if k not in spec.limits))
    out["readings"] = verdict["readings"]
    out["values"] = verdict["values"]
    return out
