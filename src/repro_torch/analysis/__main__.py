"""CLI for the port's contract checkers.

    python -m repro_torch.analysis --all --fail-on-violation --device cpu
    python -m repro_torch.analysis lint obs kernels races
    python -m repro_torch.analysis graphs            # on the card
    python -m repro_torch.analysis --emit-baseline lint

Every pass runs in this process: the port needs no forced device count
and no child process. ``graphs`` builds its engines, and ``sanitizer``
its fuzzed hubs, on the card unless ``--device cpu`` is given; both
raise when there is no card (they never fall back to the CPU). Exit status with ``--fail-on-violation``: 0 when
every error-severity finding is covered by ``baseline.toml``, 1
otherwise (the report prints a ready-to-paste baseline stanza per
unbaselined error; ``--emit-baseline`` prints *only* those stanzas).
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from . import Violation, apply_baseline, format_report, load_baseline

PASSES = ("lint", "obs", "graphs", "kernels", "races", "sanitizer")


def run_pass(name: str, device: Optional[str] = None) -> List[Violation]:
    """One pass's findings (``device`` is read by ``graphs`` and
    ``sanitizer``, the passes that build hubs)."""
    if name == "lint":
        from . import lint
        return lint.run()
    if name == "obs":
        from . import obs_lint
        return obs_lint.run()
    if name == "graphs":
        from . import graph_contracts
        return graph_contracts.run(device)
    if name == "kernels":
        from . import kernel_check
        return kernel_check.run()
    if name == "races":
        from . import races
        return races.run()
    if name == "sanitizer":
        from . import sanitizer
        return sanitizer.run(device=device)
    raise ValueError(f"unknown pass {name!r}; expected one of {PASSES}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="contract checkers for the port's serving stack")
    ap.add_argument("passes", nargs="*", choices=(*PASSES, []),
                    help=f"passes to run (default: all of {PASSES})")
    ap.add_argument("--all", action="store_true",
                    help="run every pass (same as naming none)")
    ap.add_argument("--fail-on-violation", action="store_true",
                    help="exit 1 if any unbaselined error remains")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore baseline.toml (show every finding)")
    ap.add_argument("--emit-baseline", action="store_true",
                    help="print only ready-to-paste baseline stanzas "
                         "for the unbaselined errors, nothing else")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="where the graphs and sanitizer passes build "
                         "their hubs (default: the card)")
    args = ap.parse_args(argv)

    passes = list(args.passes) or list(PASSES)
    if args.all:
        passes = list(PASSES)
    violations: List[Violation] = []
    for p in passes:
        violations += run_pass(p, args.device)

    entries = [] if args.no_baseline else load_baseline()
    active, suppressed = apply_baseline(violations, entries)
    if args.emit_baseline:
        for v in active:
            if v.severity == "error":
                print(v.stanza())
                print()
        return 0
    print(f"repro_torch.analysis: {' '.join(passes)} — "
          f"{len(active)} active finding(s), {len(suppressed)} baselined")
    print(format_report(active, suppressed))
    errors = [v for v in active if v.severity == "error"]
    if args.fail_on_violation and errors:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
