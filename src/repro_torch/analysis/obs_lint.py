"""Observability contract lint (rules O001-O003): the port's tracer
(``repro_torch.obs``) held to the reference's contract.

The tracer could reintroduce the timing faults L004 catches, plus one of
its own: a tracer call inside a captured decode or verify body runs once,
at capture, and never on replay — silently wrong spans, as a tracer call
baked into a jit trace is in the reference. These rules keep the
observability layer honest, statically:

O001  a tracer call (``span`` / ``event`` / ``begin_device`` /
      ``device_range`` / ``collect`` / ...) or a
      metric update (``inc`` / ``observe`` / ``set`` on a ``Counter`` /
      ``Histogram`` / ``Gauge``) inside a captured body (``lint``'s
      reach set from ``DecodeGraph._body`` / ``VerifyGraph._body``).

O002  sync-safe device spans, two clauses. (a) a ``with tracer.span()``
      body that launches device work without a torch sync times the
      enqueue, not the work — use ``begin_device`` / ``end_device``
      closed at a sync, or ``enqueue_span`` when enqueue latency is the
      *intended* measurement (the hub's slot install). (b) an
      ``end_device`` call in a function with no torch sync: the span
      would close before the device work finished.

O003  ``Histogram(...)`` bucket bounds must be literals (an inline
      tuple/list of numbers, or an ALL_CAPS constant): computed buckets
      can silently degenerate (empty, unsorted, wrong unit) and make
      every recorded percentile a lie.

Pure AST; shares the device / sync vocabularies and the captured-body
reach set with ``lint``, so the two gates cannot drift.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set

from . import REPO_ROOT, Violation
from .lint import (_Parents, _call_name, _dotted, _in_package, _last_attr,
                   _walk_skip_fns, captured_functions, classify,
                   read_sources)

#: The Tracer API surface — any of these on a tracer-named receiver is
#: "a tracing call" for O001.
_TRACER_METHODS = {"span", "enqueue_span", "event", "begin_device",
                   "end_device", "next_id", "bind_uid", "trace_of",
                   "release_uid", "now", "device_range", "collect",
                   "anchor", "first_token", "first_token_s"}
#: metric updates, on a receiver whose name says it is a metric
_METRIC_METHODS = {"inc", "observe", "set"}
_METRIC_HINTS = ("counter", "histogram", "gauge", "metric", "hist")


def _is_tracer_call(node: ast.AST, methods: Set[str]) -> bool:
    """``<something named *tracer*>.<method>(...)``."""
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in methods):
        return False
    recv = _dotted(node.func.value)
    return recv is not None and "tracer" in recv.lower()


def _is_metric_call(node: ast.AST) -> bool:
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _METRIC_METHODS):
        return False
    recv = (_dotted(node.func.value) or "").lower()
    return any(h in recv for h in _METRIC_HINTS)


# ---------------------------------------------------------------------------
# O001 — no tracing inside captured bodies
# ---------------------------------------------------------------------------


def _check_captured_tracing(trees: Dict[str, ast.Module],
                            parents: Dict[str, _Parents]
                            ) -> List[Violation]:
    out: List[Violation] = []
    captured = captured_functions(
        {p: t for p, t in trees.items() if _in_package(p)})
    for (path, _qual), fn in sorted(captured.items(), key=lambda kv: kv[0]):
        for node in ast.walk(fn):
            if _is_tracer_call(node, _TRACER_METHODS) or \
                    _is_metric_call(node):
                out.append(Violation(
                    "O001", path, node.lineno,
                    parents[path].qualname(node),
                    f"{_dotted(node.func)}() inside a captured body — it "
                    "runs once, at capture, and never on replay: the "
                    "span or count is silently wrong"))
    return out


# ---------------------------------------------------------------------------
# O002 — device spans end at sync sites
# ---------------------------------------------------------------------------


def _check_span_sync(tree: ast.AST, parents: _Parents,
                     path: str) -> List[Violation]:
    out: List[Violation] = []
    # (a) `with tracer.span(...)` wrapping unsynced device work.
    # `enqueue_span` is exempt by name: it declares enqueue semantics.
    for node in ast.walk(tree):
        if not isinstance(node, ast.With):
            continue
        for item in node.items:
            if not _is_tracer_call(item.context_expr, {"span"}):
                continue
            device, synced = classify(_walk_skip_fns(node.body))
            if device is not None and not synced:
                out.append(Violation(
                    "O002", path, device.lineno,
                    parents.qualname(device),
                    f"span wraps device work "
                    f"({_call_name(device) or '?'}) with no torch sync — "
                    "the span measures the enqueue, not the work; use "
                    "begin_device/end_device closed at a sync, or "
                    "enqueue_span if enqueue latency is the intended "
                    "measurement"))
    # (b) end_device outside a sync-bearing function.
    for node in ast.walk(tree):
        if not _is_tracer_call(node, {"end_device"}):
            continue
        fn = parents.enclosing_function(node)
        body = fn.body if fn is not None else []
        body = body if isinstance(body, list) else [body]
        _dev, synced = classify(_walk_skip_fns(body))
        if not synced:
            out.append(Violation(
                "O002", path, node.lineno, parents.qualname(node),
                "end_device() in a function with no torch sync — the "
                "device span would close before the work completed; "
                "close handles only where the host has waited (the "
                "engine's _materialize / _materialize_spec)"))
    return out


# ---------------------------------------------------------------------------
# O003 — histogram buckets are literals
# ---------------------------------------------------------------------------


def _is_literal_seq(node: ast.AST) -> bool:
    return isinstance(node, (ast.Tuple, ast.List)) and bool(node.elts) \
        and all(isinstance(e, ast.Constant)
                and isinstance(e.value, (int, float)) for e in node.elts)


def _module_literals(tree: ast.AST) -> Set[str]:
    """Module-level names bound to literal tuples/lists of numbers."""
    names: Set[str] = set()
    for stmt in getattr(tree, "body", []):
        if isinstance(stmt, ast.Assign) and _is_literal_seq(stmt.value):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
    return names


def _check_bucket_literals(tree: ast.AST, parents: _Parents,
                           path: str) -> List[Violation]:
    out: List[Violation] = []
    literal_names = _module_literals(tree)
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and _last_attr(_call_name(node)) == "Histogram"):
            continue
        arg: Optional[ast.AST] = node.args[0] if node.args else None
        for kw in node.keywords:
            if kw.arg == "buckets":
                arg = kw.value
        if arg is None or _is_literal_seq(arg):
            continue             # the library default is itself literal
        name = _dotted(arg)
        if name is not None:
            last = _last_attr(name)
            if last.isupper() or last in literal_names:
                continue         # ALL_CAPS constant / module literal
        out.append(Violation(
            "O003", path, node.lineno, parents.qualname(node),
            f"Histogram buckets {ast.unparse(arg)} are computed, not "
            "literal — declare bounds inline or as an ALL_CAPS constant "
            "so resolution is reviewable and cannot silently degenerate"))
    return out


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def lint_sources(sources: Dict[str, str]) -> List[Violation]:
    """Check ``{repo-relative path: source}`` as one unit."""
    trees = {p: ast.parse(s, filename=p) for p, s in sources.items()}
    parents = {p: _Parents(t) for p, t in trees.items()}
    out = _check_captured_tracing(trees, parents)
    for path, tree in trees.items():
        out.extend(_check_span_sync(tree, parents[path], path))
        out.extend(_check_bucket_literals(tree, parents[path], path))
    return out


def lint_source(src: str, path: str) -> List[Violation]:
    return lint_sources({path: src})


def run(paths: Optional[Sequence[str]] = None,
        root: str = REPO_ROOT) -> List[Violation]:
    return lint_sources(read_sources(paths, root))
