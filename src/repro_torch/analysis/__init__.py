"""Contract checkers for the port's serving stack: the counterpart of
``repro.analysis``, restated over CUDA graphs and hand-written kernels.

Six cooperating passes, each runnable on its own
(``python -m repro_torch.analysis <pass>``) and as tier-1 tests:

  * ``lint``  — AST lint of ``src/repro_torch`` and ``chip_smoke.py``
    (no torch import): host syncs and Python control flow on tensor
    values inside captured decode and verify bodies, the graph ladder
    read around ``EngineStats``, unsynced device timing, unpaired
    resource lifecycles, prefill shapes off the bucket ladders. Rules
    L001..L006.
  * ``obs``   — the tracing / metrics contract, sharing ``lint``'s
    vocabularies: no tracer call inside a captured body, device spans
    closed at a torch sync, literal histogram buckets. Rules O001..O003.
  * ``graphs`` — builds the serving engines (a ring hub, a chunked paged
    hub, a speculating engine on a wrap-risk grid) and checks the
    promises the reference reads off compiled HLO: caches written in
    place, a device-pure decode / verify tick, bank params on their
    mesh positions, the step-graph count equal to the declared ladder.
    Rules H001..H004. On the card unless ``--device cpu``.
  * ``kernels`` — every kernel wrapper run with a recorder in place of
    the built CUDA library, at every shape the port's engines, matcher
    and trainers reach: cluster size, block and grid, dynamic shared
    memory against the limits read from the ``.cu`` sources, and the
    16-byte path. Rules K001..K004.
  * ``races`` — static lockset analysis of the expert hub's threading
    contract (``THREAD_CONTRACT`` in ``serve/hub.py``). Rules R001..R004.
  * ``sanitizer`` — the deterministic schedule fuzzer over the hub's two
    threads, with its planted lost update. Rules S001..S002.

Intentional exceptions live in ``baseline.toml`` beside this file — one
``[[baseline]]`` stanza per suppressed finding, each with a written
reason. An unbaselined error fails ``--fail-on-violation``; the report
prints the stanza to paste if a finding is intentional.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))
BASELINE_PATH = os.path.join(os.path.dirname(__file__), "baseline.toml")
BASELINE_REL = "src/repro_torch/analysis/baseline.toml"


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding. ``func`` (enclosing def / kernel case) rather than the
    line number is the baseline key, so baselines survive unrelated edits
    to the file."""
    rule: str                    # "L001" .. "S002"
    path: str                    # repo-relative file
    line: int
    func: str                    # enclosing qualname or "<module>"
    msg: str
    severity: str = "error"      # "error" | "warning"

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.func)

    def format(self) -> str:
        sev = "" if self.severity == "error" else " (warning)"
        return (f"{self.rule}{sev} {self.path}:{self.line} "
                f"[{self.func}] {self.msg}")

    def stanza(self, reason: str = "<why this is intentional>") -> str:
        return ("[[baseline]]\n"
                f'rule = "{self.rule}"\n'
                f'file = "{self.path}"\n'
                f'func = "{self.func}"\n'
                f'reason = "{reason}"')


# ---------------------------------------------------------------------------
# baseline.toml — a tiny TOML-subset reader (no dependency for four
# string keys). Supported grammar: comments, blank lines,
# ``[[baseline]]`` array-of-tables headers, and ``key = "string"`` pairs.
# ---------------------------------------------------------------------------

_KV = re.compile(r'^([A-Za-z_][\w-]*)\s*=\s*"((?:[^"\\]|\\.)*)"\s*(?:#.*)?$')


def load_baseline(path: Optional[str] = None) -> List[Dict[str, str]]:
    path = path or BASELINE_PATH
    if not os.path.exists(path):
        return []
    entries: List[Dict[str, str]] = []
    cur: Optional[Dict[str, str]] = None
    with open(path, encoding="utf-8") as fh:
        for n, raw in enumerate(fh, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if line == "[[baseline]]":
                cur = {}
                entries.append(cur)
                continue
            m = _KV.match(line)
            if m and cur is not None:
                cur[m.group(1)] = m.group(2).replace('\\"', '"')
                continue
            raise ValueError(
                f"{path}:{n}: unsupported baseline syntax {line!r} "
                "(expected [[baseline]] or key = \"value\")")
    for e in entries:
        missing = {"rule", "file", "func", "reason"} - set(e)
        if missing or not e.get("reason", "").strip():
            raise ValueError(
                f"{path}: baseline entry {e} missing "
                f"{sorted(missing) or ['reason']} (every suppression "
                "needs a written justification)")
    return entries


def apply_baseline(violations: Sequence[Violation],
                   entries: Iterable[Dict[str, str]]
                   ) -> Tuple[List[Violation], List[Violation]]:
    """Split findings into (active, suppressed)."""
    keys = {(e["rule"], e["file"], e["func"]) for e in entries}
    active = [v for v in violations if v.key() not in keys]
    suppressed = [v for v in violations if v.key() in keys]
    return active, suppressed


def format_report(violations: Sequence[Violation],
                  suppressed: Sequence[Violation] = (),
                  *, show_stanzas: bool = True) -> str:
    lines: List[str] = []
    errors = [v for v in violations if v.severity == "error"]
    warns = [v for v in violations if v.severity != "error"]
    for v in errors + warns:
        lines.append(v.format())
    if suppressed:
        lines.append(f"({len(suppressed)} finding(s) suppressed by "
                     "baseline.toml)")
    if errors and show_stanzas:
        lines.append("")
        lines.append(f"To suppress an intentional finding, add to "
                     f"{BASELINE_REL}:")
        for v in errors:
            lines.append("")
            lines.append(v.stanza())
    if not violations:
        lines.append("clean")
    return "\n".join(lines)
