"""The port's benchmark: one run of one cell.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

builds the cell's fleet of ``repro_torch`` experts behind
``repro_torch.serve.RoutedServer`` on the card, warms it up, serves the
cell's traffic for ``--seconds``, judges what it served against the
plain references, and prints the result as the last line of standard
output (one JSON object); the compared numbers and their limits are the
last lines of standard error. With ``--trace 1`` the metrics are the
cell's per-layer ones, read from the tracer and a profiler trace of part
of the window.

Exits with 3, printing no result, without enough CUDA devices for the
cell; with 4 where a module of JAX or of the JAX package is loaded.
Kernel builds and caches stay inside the checkout (``build/``).
"""
import os
import sys
import time

T_START = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root (for ``bench_port``) and the port's source
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path.pop(0)
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, "build", "bench_port", sub)

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        log(f"no src/repro_torch under {ROOT}: the program under test is "
            "missing")
        return 2
    import torch
    from bench_port import harness
    bench = json.loads(Path(ROOT, "BENCHMARK.json").read_text())
    spec = harness.CellSpec(bench, args.workload, Path(ROOT))
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec.chips:
        log(f"{args.workload} needs {spec.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    res = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START, log=log)
    found = harness.banned_modules()
    if found:
        log(f"modules of JAX or the JAX package are loaded: {found}")
        return 4
    res["device"]["power_limit_w"] = harness.power_limit_w()
    readings = res.pop("readings")
    res.pop("values")
    res["limits"] = {r.name: {"value": r.value, "limit": r.limit}
                     for r in readings}
    print(json.dumps(res), flush=True)
    for r in readings:
        log(f"{r.name} {r.value!r} limit {r.limit!r} "
            f"{'ok' if r.ok else 'FAILED'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
