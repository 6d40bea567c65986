"""Static lockset / race analysis over the port's serving threads (rules
R001-R004): the reference's ``repro.analysis.races``, kept as the port's
own copy and pointed at the port's unit.

The expert hub makes the serving stack concurrent: a staging worker
thread reads checkpoints into CPU tensors while the scheduler thread
decodes, and they share the catalog entry state machines, the
wanted/staging books, the popularity ``Counter`` and the ``HubStats``
counters. This pass checks the code against the contract the code itself
declares — the ``THREAD_CONTRACT`` literal in ``serve/hub.py`` — instead
of trusting comments:

  * Parse the analysis unit (``DEFAULT_UNIT``: hub, scheduler, kvcache)
    into an AST function table and extract ``THREAD_CONTRACT`` via
    ``ast.literal_eval`` (a missing or non-literal contract is itself
    R001: unchecked concurrency).
  * Build a name-based call graph (method-name call edges plus
    property-access edges) and walk each thread's **reach set** from its
    declared entry points.
  * For every function, record attribute accesses with a *receiver
    kind* — ``self``, catalog-entry (receivers derived from
    ``self.catalog[...]``, including loop/comprehension targets over
    the catalog), ``stats`` (receivers ending ``.stats``) — the lexical
    lock state at the access (``with self._lock:`` nesting, or the
    ``*_locked``-suffix convention: such helpers assume the lock and
    the checker verifies every call site), plus calls, lock
    acquisitions and ordered field writes.

Rules:

  R001  unguarded shared state — a lock-guarded field / catalog-entry
        field / stats counter accessed without the designated lock in a
        thread-reachable function; a ``*_locked`` helper called without
        the lock held; a single-writer field reachable from a thread
        that does not own it; a mutable attribute both threads touch
        that the contract does not cover at all; a contract entry point
        that no longer exists (drift).
  R002  lock-order hazards — re-acquiring a held (non-reentrant) lock,
        directly or transitively through calls, or acquiring two locks
        in inconsistent (A,B)/(B,A) order across the unit.
  R003  blocking work under a lock — checkpoint I/O, device
        synchronisation, joins, sleeps held under the designated lock
        stall every thread that needs it. Condition waits on the
        designated lock are exempt (they release it).
  R004  unsafe publication — a state write publishing ``staged`` /
        ``resident`` ordered before its payload fields (params, slot)
        are written, so another thread could observe a
        half-constructed entry.

The dynamic half of the gate — the deterministic schedule fuzzer that
runs real interleavings of the same contract — is
``repro_torch.analysis.sanitizer`` (S001-S002).
"""
from __future__ import annotations

import ast
import os
from typing import Any, Dict, List, Optional, Set, Tuple

from . import REPO_ROOT, Violation

# the three files whose threads actually interleave: the hub (both
# threads), the scheduler driving it, and the kv bookkeeping the
# scheduler owns single-writer. router.py participates only through
# Router.hits_lock, which bind_popularity points at the hub lock.
DEFAULT_UNIT = (
    "src/repro_torch/serve/hub.py",
    "src/repro_torch/serve/scheduler.py",
    "src/repro_torch/serve/kvcache.py",
)

CONTRACT_NAME = "THREAD_CONTRACT"


class _Access:
    __slots__ = ("attr", "kind", "line", "write", "locked")

    def __init__(self, attr, kind, line, write, locked):
        self.attr, self.kind, self.line = attr, kind, line
        self.write, self.locked = write, locked


class _Call:
    __slots__ = ("name", "line", "locked", "recv_name", "recv_const",
                 "held")

    def __init__(self, name, line, locked, recv_name, recv_const, held):
        self.name, self.line, self.locked = name, line, locked
        self.recv_name, self.recv_const = recv_name, recv_const
        self.held = held


class _Acquire:
    __slots__ = ("lock", "line", "held")

    def __init__(self, lock, line, held):
        self.lock, self.line, self.held = lock, line, held


class _Func:
    def __init__(self, qual: str, short: str, path: str, line: int,
                 assumed_locked: bool):
        self.qual = qual
        self.short = short
        self.path = path
        self.line = line
        self.assumed_locked = assumed_locked
        self.accesses: List[_Access] = []
        self.calls: List[_Call] = []
        self.acquires: List[_Acquire] = []
        # receiver key -> ordered [(attr, value_kind, line)]; value_kind
        # is the constant value for Constant assigns, else "<expr>"
        self.entry_writes: Dict[str, List[Tuple[str, Any, int]]] = {}
        self.refs: Set[str] = set()      # names for call-graph edges
        self.threads: Set[str] = set()   # filled by reachability


def _alias_scan(fn: ast.AST) -> Dict[str, str]:
    """Local receiver typing: names bound from ``self.catalog[...]``
    (or iteration over the catalog) are catalog entries; names bound
    from ``*.stats`` are stats objects."""
    aliases: Dict[str, str] = {}

    def from_value(node) -> Optional[str]:
        if isinstance(node, ast.Subscript) and \
                isinstance(node.value, ast.Attribute) and \
                node.value.attr == "catalog":
            return "entry"
        if isinstance(node, ast.Attribute) and node.attr == "stats":
            return "stats"
        return None

    def entry_iter_target(target, it) -> None:
        # ``for e, c in enumerate(self.catalog)`` / ``for c in
        # self.catalog`` (and the comprehension equivalents)
        wrapped = (isinstance(it, ast.Call)
                   and isinstance(it.func, ast.Name)
                   and it.func.id == "enumerate")
        inner = it.args[0] if wrapped and it.args else it
        if not (isinstance(inner, ast.Attribute)
                and inner.attr == "catalog"):
            return
        if wrapped and isinstance(target, ast.Tuple) and \
                len(target.elts) == 2 and \
                isinstance(target.elts[1], ast.Name):
            aliases[target.elts[1].id] = "entry"
        elif not wrapped and isinstance(target, ast.Name):
            aliases[target.id] = "entry"

    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            kind = from_value(node.value)
            if kind:
                aliases[node.targets[0].id] = kind
        elif isinstance(node, ast.For):
            entry_iter_target(node.target, node.iter)
        elif isinstance(node, ast.comprehension):
            entry_iter_target(node.target, node.iter)
    return aliases


class _FuncVisitor(ast.NodeVisitor):
    def __init__(self, info: _Func, aliases: Dict[str, str],
                 lock_aliases: Set[str], canon: str):
        self.info = info
        self.aliases = aliases
        self.lock_aliases = lock_aliases
        self.canon = canon
        self.locks: List[str] = []

    # -- lock state ------------------------------------------------------
    def _is_locked(self) -> bool:
        return self.info.assumed_locked or bool(self.locks)

    def _held(self) -> Tuple[str, ...]:
        held = tuple(self.locks)
        if self.info.assumed_locked:
            held = (self.canon,) + held
        return held

    def _lock_name(self, expr) -> Optional[str]:
        name = None
        if isinstance(expr, ast.Attribute):
            name = expr.attr
        elif isinstance(expr, ast.Name):
            name = expr.id
        if name is None:
            return None
        if name in self.lock_aliases:
            return self.canon
        if "lock" in name.lower():
            return name
        return None

    def visit_With(self, node: ast.With) -> None:
        acquired = []
        for item in node.items:
            lock = self._lock_name(item.context_expr)
            if lock is not None:
                self.info.acquires.append(
                    _Acquire(lock, node.lineno, self._held()))
                acquired.append(lock)
            self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        self.locks.extend(acquired)
        for stmt in node.body:
            self.visit(stmt)
        if acquired:
            del self.locks[-len(acquired):]

    # -- receivers -------------------------------------------------------
    def _recv_kind(self, node) -> str:
        if isinstance(node, ast.Name):
            if node.id == "self":
                return "self"
            return self.aliases.get(node.id, "other")
        if isinstance(node, ast.Attribute):
            return "stats" if node.attr == "stats" else "other"
        if isinstance(node, ast.Subscript):
            if isinstance(node.value, ast.Attribute) and \
                    node.value.attr == "catalog":
                return "entry"
        return "other"

    def visit_Attribute(self, node: ast.Attribute) -> None:
        self.info.refs.add(node.attr)
        self.info.accesses.append(_Access(
            node.attr, self._recv_kind(node.value), node.lineno,
            isinstance(node.ctx, (ast.Store, ast.Del)),
            self._is_locked()))
        self.visit(node.value)

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        name, recv_name, recv_const = None, None, False
        if isinstance(fn, ast.Attribute):
            name = fn.attr
            recv_const = isinstance(fn.value, ast.Constant)
            if isinstance(fn.value, ast.Attribute):
                recv_name = fn.value.attr
            elif isinstance(fn.value, ast.Name):
                recv_name = fn.value.id
        elif isinstance(fn, ast.Name):
            name = fn.id
        if name is not None:
            self.info.refs.add(name)
            self.info.calls.append(_Call(
                name, node.lineno, self._is_locked(), recv_name,
                recv_const, self._held()))
        self.generic_visit(node)

    # -- ordered writes (R004) -------------------------------------------
    def _record_write(self, target, value) -> None:
        if not isinstance(target, ast.Attribute):
            return
        if self._recv_kind(target.value) != "entry":
            return
        key = ast.unparse(target.value)
        val: Any = "<expr>"
        if isinstance(value, ast.Constant):
            val = value.value
        self.info.entry_writes.setdefault(key, []).append(
            (target.attr, val, target.lineno))

    def visit_Assign(self, node: ast.Assign) -> None:
        for target in node.targets:
            if isinstance(target, ast.Tuple) and \
                    isinstance(node.value, ast.Tuple) and \
                    len(target.elts) == len(node.value.elts):
                for t, v in zip(target.elts, node.value.elts):
                    self._record_write(t, v)
            else:
                self._record_write(target, node.value)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_write(node.target, node)
        self.generic_visit(node)


def _collect(path: str, tree: ast.Module
             ) -> List[Tuple[str, str, ast.AST]]:
    """(qualname, short name, def node) for every module-level function
    and method. Nested defs/lambdas stay part of their parent — they
    execute in its thread context."""
    out: List[Tuple[str, str, ast.AST]] = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append((node.name, node.name, node))
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    out.append((f"{node.name}.{sub.name}", sub.name,
                                sub))
    return [(qual, short, node) for qual, short, node in out]


def _build_funcs(sources: Dict[str, str], lock_aliases: Set[str],
                 canon: str) -> Tuple[List[_Func], List[Violation]]:
    funcs: List[_Func] = []
    errors: List[Violation] = []
    for path, src in sources.items():
        try:
            tree = ast.parse(src)
        except SyntaxError as exc:
            errors.append(Violation(
                "R001", path, exc.lineno or 1, "<module>",
                f"unit file failed to parse: {exc.msg}"))
            continue
        for qual, short, node in _collect(path, tree):
            info = _Func(qual, short, path, node.lineno,
                         short.endswith("_locked"))
            vis = _FuncVisitor(info, _alias_scan(node), lock_aliases,
                               canon)
            for stmt in node.body:
                vis.visit(stmt)
            funcs.append(info)
    return funcs, errors


def _find_contract(sources: Dict[str, str]
                   ) -> Tuple[Optional[dict], Optional[str], int]:
    for path, src in sources.items():
        try:
            tree = ast.parse(src)
        except SyntaxError:
            continue
        for node in tree.body:
            if isinstance(node, ast.Assign) and \
                    any(isinstance(t, ast.Name)
                        and t.id == CONTRACT_NAME
                        for t in node.targets):
                try:
                    return (ast.literal_eval(node.value), path,
                            node.lineno)
                except (ValueError, SyntaxError):
                    return (None, path, node.lineno)
    return None, None, 0


def _reach(funcs: List[_Func], contract: dict) -> List[Violation]:
    """Per-thread BFS over name-based call/property edges; marks each
    function with the threads that can reach it."""
    vs: List[Violation] = []
    by_short: Dict[str, List[_Func]] = {}
    by_qual: Dict[str, _Func] = {}
    for f in funcs:
        by_short.setdefault(f.short, []).append(f)
        by_qual[f.qual] = f
    first = funcs[0] if funcs else None
    for thread, entries in contract.get("threads", {}).items():
        work: List[_Func] = []
        for qual in entries:
            f = by_qual.get(qual)
            if f is None:
                vs.append(Violation(
                    "R001",
                    first.path if first else "<unit>", 1, "<contract>",
                    f"THREAD_CONTRACT thread {thread!r} names entry "
                    f"point {qual!r} which no longer exists — contract "
                    "drift"))
                continue
            work.append(f)
        seen: Set[str] = set()
        while work:
            f = work.pop()
            if f.qual in seen:
                continue
            seen.add(f.qual)
            f.threads.add(thread)
            for name in f.refs:
                for g in by_short.get(name, ()):
                    if g.qual not in seen:
                        work.append(g)
    return vs


def analyze_unit(sources: Dict[str, str]) -> List[Violation]:
    """Run R001-R004 over ``{repo-relative path: source}``."""
    vs: List[Violation] = []
    contract, cpath, cline = _find_contract(sources)
    first = next(iter(sources), "<unit>")
    if cpath is None:
        return [Violation(
            "R001", first, 1, "<module>",
            f"no {CONTRACT_NAME} literal found in the unit — the "
            "threading contract must be declared where the threads "
            "live (serve/hub.py)")]
    if contract is None:
        return [Violation(
            "R001", cpath, cline, "<module>",
            f"{CONTRACT_NAME} must be a pure literal "
            "(ast.literal_eval-able) so the checker can read it")]

    canon = contract.get("lock", "_lock")
    lock_aliases = set(contract.get("lock_aliases", [canon])) | {canon}
    guarded = contract.get("lock_guarded", {})
    fields = set(guarded.get("fields", []))
    entry_fields = set(guarded.get("entry_fields", []))
    stats_fields = set(guarded.get("stats_fields", []))
    handoffs = set(contract.get("queue_handoffs", []))
    single = contract.get("single_writer", {})
    owner_of = {fld: t for t, fl in single.items() for fld in fl}
    blocking = set(contract.get("blocking_calls", []))
    publish = contract.get("publish_order", {})

    funcs, errs = _build_funcs(sources, lock_aliases, canon)
    vs.extend(errs)
    vs.extend(_reach(funcs, contract))
    by_short: Dict[str, List[_Func]] = {}
    for f in funcs:
        by_short.setdefault(f.short, []).append(f)

    covered = (fields | entry_fields | stats_fields | handoffs
               | lock_aliases | set(owner_of))
    # attr -> {thread: [reads?, writes?]} for the contract-coverage rule
    shared_seen: Dict[str, Dict[str, List[bool]]] = {}

    for f in funcs:
        reachable = bool(f.threads)
        if reachable and f.short != "__init__":
            for acc in f.accesses:
                if acc.attr in handoffs or acc.attr in lock_aliases:
                    continue
                is_guarded = (
                    (acc.kind in ("self", "other")
                     and acc.attr in fields)
                    or (acc.kind == "entry"
                        and acc.attr in entry_fields)
                    or (acc.kind == "stats"
                        and acc.attr in stats_fields))
                if is_guarded and not acc.locked:
                    # R001: unguarded shared state
                    vs.append(Violation(
                        "R001", f.path, acc.line, f.qual,
                        f"access to lock-guarded {acc.attr!r} without "
                        f"holding {canon!r} (thread(s): "
                        f"{','.join(sorted(f.threads))}) — wrap in "
                        f"`with self.{canon}:` or move into a "
                        "*_locked helper"))
                owner = owner_of.get(acc.attr)
                if owner is not None and \
                        acc.kind in ("self", "other") and \
                        any(t != owner for t in f.threads):
                    others = sorted(t for t in f.threads if t != owner)
                    vs.append(Violation(
                        "R001", f.path, acc.line, f.qual,
                        f"single-writer field {acc.attr!r} (owner "
                        f"thread {owner!r}) is reachable from thread(s)"
                        f" {','.join(others)} — route through a locked "
                        "accessor or a queue handoff"))
                if acc.attr not in covered:
                    rec = shared_seen.setdefault(acc.attr, {})
                    for t in f.threads:
                        slot = rec.setdefault(t, [False, False])
                        slot[0] = slot[0] or not acc.write
                        slot[1] = slot[1] or acc.write
            for call in f.calls:
                if call.name.endswith("_locked") and \
                        call.name in by_short and not call.locked:
                    vs.append(Violation(
                        "R001", f.path, call.line, f.qual,
                        f"{call.name}() assumes {canon!r} is held "
                        "(the *_locked convention) but the call site "
                        "holds no lock"))

        # R003 applies to every function — blocking under a lock is a
        # latency/deadlock bug regardless of which thread runs it
        for call in f.calls:
            if call.name in blocking and call.locked:
                if call.recv_const or call.recv_name in lock_aliases:
                    continue  # str.join / cv.wait release or don't hold
                vs.append(Violation(
                    "R003", f.path, call.line, f.qual,
                    f"blocking call {call.name}() while holding "
                    f"{canon!r} — stage outside the lock and publish "
                    "the result under it"))

    # -- R002: same-lock re-acquire + inconsistent acquisition order ----
    # transitive acquire sets propagate over CALL edges only — an
    # attribute reference like ``target=self._stage_loop`` hands the
    # function to another thread, whose acquisitions don't nest inside
    # the referencing frame's locks
    trans: Dict[str, Set[str]] = {
        f.qual: {a.lock for a in f.acquires} for f in funcs}
    changed = True
    while changed:
        changed = False
        for f in funcs:
            cur = trans[f.qual]
            for call in f.calls:
                for g in by_short.get(call.name, ()):
                    extra = trans[g.qual] - cur
                    if extra:
                        cur |= extra
                        changed = True
    order: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
    for f in funcs:
        for acq in f.acquires:
            for h in acq.held:
                if h == acq.lock:
                    vs.append(Violation(
                        "R002", f.path, acq.line, f.qual,
                        f"re-acquiring {acq.lock!r} while already "
                        "holding it — threading.Lock is not reentrant; "
                        "use a *_locked helper instead"))
                else:
                    order.setdefault((h, acq.lock),
                                     (f.path, acq.line, f.qual))
        for call in f.calls:
            if not call.held:
                continue
            for g in by_short.get(call.name, ()):
                for m in trans[g.qual]:
                    for h in call.held:
                        if h == m:
                            vs.append(Violation(
                                "R002", f.path, call.line, f.qual,
                                f"calls {call.name}() which acquires "
                                f"{m!r} while {m!r} is already held — "
                                "transitive self-deadlock"))
                        else:
                            order.setdefault(
                                (h, m), (f.path, call.line, f.qual))
    for (a, b), (path, line, qual) in order.items():
        if (b, a) in order and a < b:
            opath, oline, oqual = order[(b, a)]
            vs.append(Violation(
                "R002", path, line, qual,
                f"inconsistent lock order: {a!r} then {b!r} here, but "
                f"{b!r} then {a!r} in {oqual} ({opath}:{oline}) — "
                "pick one global order"))

    # -- R004: publication order of partially constructed entries --------
    state_rules = publish.get("state", {})
    for f in funcs:
        for recv, writes in f.entry_writes.items():
            for i, (attr, val, line) in enumerate(writes):
                if attr != "state" or val not in state_rules:
                    continue
                payload = state_rules[val]
                for p in payload:
                    later = [ln for (a2, _, ln) in writes[i + 1:]
                             if a2 == p]
                    if later:
                        vs.append(Violation(
                            "R004", f.path, line, f.qual,
                            f"{recv}.state = {val!r} published before "
                            f"its payload write {recv}.{p} (line "
                            f"{later[0]}) — another thread can observe "
                            "a half-constructed entry; write the "
                            "payload first"))
                    before = [v2 for (a2, v2, _) in writes[:i]
                              if a2 == p]
                    if before and before[-1] is None:
                        vs.append(Violation(
                            "R004", f.path, line, f.qual,
                            f"{recv}.state = {val!r} published after "
                            f"{recv}.{p} was cleared to None — the "
                            f"{val!r} state promises a live {p}"))

    # -- R001 (coverage): shared mutable attrs the contract misses ------
    for attr, rec in sorted(shared_seen.items()):
        if len(rec) < 2 or not any(w for _, w in rec.values()):
            continue
        threads = ",".join(sorted(rec))
        f = next((f for f in funcs
                  for a in f.accesses if a.attr == attr), None)
        line = next((a.line for a in f.accesses if a.attr == attr), 1) \
            if f else 1
        vs.append(Violation(
            "R001", f.path if f else "<unit>", line,
            f.qual if f else "<unit>",
            f"attribute {attr!r} is accessed by threads {threads} "
            "(with at least one write) but appears in no "
            "THREAD_CONTRACT category — declare it lock_guarded, "
            "single_writer, or a queue handoff"))

    vs.sort(key=lambda v: (v.path, v.line, v.rule))
    return vs


def run(root: str = REPO_ROOT,
        unit: Tuple[str, ...] = DEFAULT_UNIT) -> List[Violation]:
    sources: Dict[str, str] = {}
    for rel in unit:
        full = os.path.join(root, rel)
        with open(full, "r", encoding="utf-8") as fh:
            sources[rel] = fh.read()
    return analyze_unit(sources)
