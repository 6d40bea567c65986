"""Readings that the comparison's limits are set from: the program's and
the controls' (``check.judge(control=True)``), seed by seed, several
seeds in one process.

    python3 bench_port/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 10

Each seed is a whole run of the cell (``harness.run_cell``) with the
controls read beside the reference: the router in bfloat16, the model's
weights rounded to float8 e4m3. One JSON line a seed on standard
output, then one line with the largest program reading and the smallest
control reading of each number. The benchmark's own runs never run the
controls.
"""
import os
import sys
import time

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
from bench_port import run as _run  # noqa: E402,F401  (paths and caches)

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    from bench_port import harness
    bench = json.loads(Path(_run.ROOT, "BENCHMARK.json").read_text())
    spec = harness.CellSpec(bench, args.workload, Path(_run.ROOT))
    prog, ctl = {}, {}
    for seed in [int(s) for s in args.seeds.split(",")]:
        res = harness.run_cell(spec, seed, args.seconds, False, args.device,
                               time.perf_counter(), control=True,
                               log=_run.log)
        line = {"seed": seed, "correct": res["correct"],
                "failed": res["failed"], "attempted": res["attempted"],
                "readings": res["values"],
                "control": res["control"], "metrics": res["metrics"],
                "memory_peak_bytes": res["device"]["memory_peak_bytes"]}
        print(json.dumps(line), flush=True)
        for k, v in line["readings"].items():
            prog[k] = max(prog.get(k, 0.0), v)
        for k, v in line["control"].items():
            ctl[k] = min(ctl.get(k, float("inf")), v)
        del res
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    print(json.dumps({"program_max": prog, "control_min": ctl}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
