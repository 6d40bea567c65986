"""AST lint pass: the port's serving-stack hazards (rules L001-L006).

Pure stdlib (``ast``): importable and runnable without torch. The
reference's rules read jit-traced code; the port's counterpart of a
traced function is a *captured body*: a decode or verify step that
``torch.cuda.graph`` records once and replays for every later step
(``serve/graphs.py``). A host side effect in such a body runs at capture
and never on replay; a host sync inside it makes the capture raise on the
card, while the CPU, which runs the same body eagerly, never notices.

Captured bodies
---------------
``DecodeGraph._body`` and ``VerifyGraph._body``, and every function of
``src/repro_torch/`` reachable from them by name, the way ``races``
works out each thread's reach set: ``self.f(...)`` reaches the methods
``f`` of the caller's file, ``x.f(...)`` every method or function ``f``
(not the builtin containers' methods, nor calls on an outside module
such as ``torch``), and ``f(...)`` or ``f`` passed as an argument
(``tree_map(f, ...)``) the module-level functions ``f``. Name edges
over-approximate: a helper that shares a name with a captured function
is checked as captured.

Rules
-----
L001  host sync inside a captured body: ``.item()``, ``.cpu()``,
      ``.tolist()`` / ``.numpy()`` of a tensor value, ``int()`` /
      ``float()`` / ``bool()`` of a tensor value, ``torch.cuda.
      synchronize`` or any ``.synchronize()``, ``np.asarray`` /
      ``np.array`` of a tensor value, a copy to the CPU (``.to("cpu")``),
      or a host-to-device copy of host data (``torch.tensor``,
      ``torch.as_tensor``, ``torch.from_numpy``: pageable, so it syncs).
L002  Python control flow (``if`` / ``while`` / ``assert`` / a
      conditional expression / a comprehension filter) on a tensor
      value, or a data-dependent-shape op (``nonzero``, ``argwhere``,
      ``masked_select``, ``unique``, ``bincount``, one-argument
      ``torch.where``, a boolean-mask index) inside a captured body: the
      first syncs, the second syncs and sizes an output no replay can
      resize.
L003  the step-graph ladder (``EngineCore._graphs`` /
      ``_verify_graphs``) read anywhere but ``serve/core.py``, whose
      ``EngineStats`` (``decode_compiles``, ``verify_compiles``,
      ``decode_graphs``) and ``EngineCore.step_graphs()`` are the
      readers: the counterpart of jit's private ``_cache_size``.
L004  a ``time.perf_counter()`` / ``time.time()`` region that launches
      CUDA work (a ``torch`` op, a kernel wrapper, a repo method that
      steps the device) with no torch sync before its closing read
      (``torch.cuda.synchronize``, ``Event.synchronize`` /
      ``elapsed_time``, ``.item()``, ``.cpu()``): launches are
      asynchronous, so the timer measures the enqueue, not the work.
L005  unpaired resource lifecycle in the serving clients: an acquire
      (``PagePool.alloc`` / ``retain``, hub ``pin``, prefix-cache
      ``adopt_prefix``) with no matching release anywhere in the same
      function while later statements can raise. ``kvcache.py`` keeps
      these invariants internally (its property tests hold it), so the
      rule reads the client modules only.
L006  a prefill or suffix prefill (``_prefill``, ``_paged_prefill``,
      ``_paged_suffix``) whose token array's shape, or whose chunk
      index, does not come from the ladders: ``bucket_for`` /
      ``pad_shape`` results, ``chunk_len`` / ``max_len`` /
      ``n_experts``, ladder elements, integer constants. A raw length
      keys a new shape for every prompt: the unbounded ladder that H004
      exists to catch. Derivation is tracked by name across the file
      (``Sb`` blessed by one ``bucket_for`` assignment stays blessed),
      and through dict literals by key (``{"toks": toks_k}`` blesses
      ``d["toks"]``).

Taint model (L001/L002): inside a captured function, positional
parameters are tensor values unless annotated with a type that names
neither ``Tensor`` nor ``Any`` (``self`` / ``cls`` aside); keyword-only
parameters and ``self`` attributes are host values. Results of ``torch`` ops and of
methods on tensor values are tensor values; ``.shape`` / ``.dtype`` /
``.device``, ``.size()`` / ``.dim()`` / ``.numel()`` and ``len()`` escape
the taint. Nested functions and lambdas run where they are defined, so
they are checked with their parent's taint.

L001/L002 are an early warning on the CPU, by name and so
over-approximate. The authoritative check is H002
(``graph_contracts``), which records the aten ops of the real decode and
verify bodies, and on the card captures them under
``torch.cuda.set_sync_debug_mode("error")``.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from . import REPO_ROOT, Violation

PACKAGE = "src/repro_torch"
EXTRA_FILES = ("chip_smoke.py",)

# -- captured bodies ---------------------------------------------------------
CAPTURE_ROOTS = ("DecodeGraph._body", "VerifyGraph._body")
_UNTAINT_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda",
                  "requires_grad", "placements", "device_mesh", "dim",
                  "mesh_dim_names"}
# host-valued helpers: Python's, and the sharding metadata queries
_UNTAINT_CALLS = {"len", "isinstance", "type", "getattr", "hasattr",
                  "range", "enumerate", "zip", "id", "callable", "is_fake",
                  "shard_dims", "shard_index", "axis_size", "current_mesh",
                  "mesh_shape", "placements"}
_UNTAINT_METHODS = {"size", "dim", "numel", "stride", "element_size",
                    "is_contiguous", "data_ptr", "get_device",
                    "is_floating_point", "storage_offset", "nelement",
                    "is_partial", "is_shard", "is_replicate"}
# torch-rooted calls whose result is not a tensor
_TORCH_HOST = {"device", "Size", "finfo", "iinfo", "is_tensor",
               "get_default_dtype", "is_available", "device_count",
               "current_device", "get_device_name", "is_floating_point",
               "promote_types", "result_type", "get_device_properties"}

_HOST_CAST_CALLS = {"int", "float", "bool", "complex"}
_SYNC_ALWAYS = {"item", "cpu"}              # any receiver
_SYNC_TAINTED = {"tolist", "numpy"}         # on a tensor value
_NP_ROOTS = {"np", "numpy", "onp"}
_H2D_CALLS = {"tensor", "as_tensor", "from_numpy"}
_DYNAMIC_SHAPE = {"nonzero", "argwhere", "masked_select", "unique",
                  "unique_consecutive", "bincount"}
_BOOL_CALLS = {"isnan", "isinf", "isfinite", "logical_and", "logical_or",
               "logical_not", "logical_xor", "eq", "ne", "lt", "le", "gt",
               "ge", "bool", "isin"}

# -- L004: device work and syncs ----------------------------------------------
# repo methods that step the device (the reference's hints, and the
# port's graph replay, capture body and kernel wrappers)
_DEVICE_HINTS = {"step", "tick", "admit", "admit_wave", "harvest",
                 "prefill", "decode", "generate", "warmup", "drain",
                 "run_step", "service", "dispatch", "install", "apply",
                 "replay", "body", "verify", "expert_score",
                 "expert_score_folded", "cosine_scores", "cosine_fine",
                 "decode_attention", "paged_decode_attention", "wkv_step"}
# torch calls that build, configure or query and launch nothing
_NON_DISPATCH = {"device", "Generator", "no_grad", "inference_mode",
                 "enable_grad", "set_grad_enabled", "manual_seed",
                 "get_device_properties", "is_available", "device_count",
                 "current_device", "set_device", "get_device_name",
                 "Event", "Stream", "stream", "current_stream", "finfo",
                 "iinfo", "Size", "is_tensor", "get_default_dtype",
                 "set_printoptions", "graph", "CUDAGraph",
                 "graph_pool_handle", "set_sync_debug_mode",
                 "get_sync_debug_mode", "reset_peak_memory_stats",
                 "max_memory_allocated", "memory_allocated",
                 "empty_cache", "record", "synchronize"}
# torch syncs, and ``EngineCore._fetch``: the engine's one host wait
# (its copies land in a pinned buffer, then it waits on their events)
_SYNC_CALLS = {"synchronize", "elapsed_time", "item", "cpu", "tolist",
               "numpy", "_fetch"}
_TIME_FNS = {"time", "perf_counter", "monotonic", "process_time"}

# -- L005 pairing table and client scope ----------------------------------------
_ACQUIRE_RELEASE = {"alloc": {"release"},
                    "retain": {"release"},
                    "pin": {"unpin"},
                    "adopt_prefix": {"release"}}
_LIFECYCLE_FILES = tuple(f"{PACKAGE}/serve/{n}.py" for n in
                         ("core", "scheduler", "hub", "engine", "router",
                          "placement"))
_SAFE_CALLS = {"append", "pop", "extend", "add", "update", "get",
               "items", "keys", "values", "setdefault", "sort",
               "join", "copy", "len", "int", "str", "list", "dict",
               "tuple", "set", "zip", "range", "enumerate", "sorted",
               "min", "max", "sum", "abs", "isinstance", "format"}

# -- L003 ---------------------------------------------------------------------
_LADDER_ATTRS = {"_graphs", "_verify_graphs"}
_LADDER_HOME = f"{PACKAGE}/serve/core.py"


def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize' for Attribute/Name chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _call_name(call: ast.Call) -> Optional[str]:
    return _dotted(call.func)


def _last_attr(name: Optional[str]) -> str:
    return name.rsplit(".", 1)[-1] if name else ""


def _method(call: ast.AST) -> str:
    """The called name of ``f(...)`` or ``<anything>.f(...)``."""
    if not isinstance(call, ast.Call):
        return ""
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    if isinstance(call.func, ast.Name):
        return call.func.id
    return ""


def _torch_rooted(name: Optional[str]) -> bool:
    return bool(name) and name.split(".")[0] in ("torch", "F")


class _Parents:
    def __init__(self, tree: ast.AST) -> None:
        self.parent: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parent[child] = node

    def qualname(self, node: ast.AST) -> str:
        names: List[str] = []
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                names.append(cur.name)
            elif isinstance(cur, ast.Lambda):
                names.append("<lambda>")
            cur = self.parent.get(cur)
        return ".".join(reversed(names)) or "<module>"

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self.parent.get(node)
        while cur is not None and not isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            cur = self.parent.get(cur)
        return cur


def _walk_skip_fns(stmts: Sequence[ast.stmt]) -> List[ast.AST]:
    """All nodes under ``stmts``, not descending into nested ``def``
    bodies (a nested def's body doesn't run in this region). Lambdas are
    descended into: they are passed inline to eagerly applied helpers
    (``tree_map(lambda x: ..., t)``), so their bodies do run here."""
    out: List[ast.AST] = []

    def visit(n: ast.AST) -> None:
        out.append(n)
        for c in ast.iter_child_nodes(n):
            if not isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(c)

    for s in stmts:
        visit(s)
    return out


# ---------------------------------------------------------------------------
# captured-body discovery: name reachability from the step bodies
# ---------------------------------------------------------------------------


# methods of Python's own containers and primitives: a call on another
# receiver with one of these names is taken as the builtin, not as a
# repo method that shares the name
_BUILTIN_METHODS = {"get", "add", "pop", "append", "extend", "update",
                    "clear", "items", "keys", "values", "setdefault",
                    "copy", "remove", "discard", "index", "count", "sort",
                    "join", "split", "replace", "format", "put", "close",
                    "notify_all", "notify", "wait", "popleft",
                    "appendleft", "startswith", "endswith", "strip"}


def _external_modules(tree: ast.Module) -> Set[str]:
    """Names a file binds to modules outside the package (``import
    numpy as np``, ``import torch.nn.functional as F``, ``from torch
    import distributed as dist``)."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if not a.name.startswith("repro_torch"):
                    out.add(a.asname or a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and \
                not (node.module or "").startswith("repro_torch"):
            for a in node.names:
                out.add(a.asname or a.name)
    return out


class _Fn:
    __slots__ = ("path", "qual", "short", "cls", "node", "refs")

    def __init__(self, path, qual, short, cls, node, external=()):
        self.path, self.qual, self.short = path, qual, short
        self.cls, self.node = cls, node
        # (kind, name): "self" a call on self, "attr" a call on another
        # receiver, "name" a bare call or a function passed by name
        self.refs: Set[Tuple[str, str]] = set()
        for n in ast.walk(node):
            if not isinstance(n, ast.Call):
                continue
            if isinstance(n.func, ast.Attribute):
                recv = n.func.value
                if isinstance(recv, ast.Name) and recv.id == "self":
                    self.refs.add(("self", n.func.attr))
                elif n.func.attr not in _BUILTIN_METHODS and not (
                        (_dotted(recv) or "").split(".")[0] in external):
                    self.refs.add(("attr", n.func.attr))
            elif isinstance(n.func, ast.Name):
                self.refs.add(("name", n.func.id))
            for a in list(n.args) + [k.value for k in n.keywords]:
                if isinstance(a, ast.Name):
                    self.refs.add(("name", a.id))
                elif isinstance(a, ast.Attribute) and isinstance(
                        a.value, ast.Name) and a.value.id == "self":
                    self.refs.add(("self", a.attr))


def _function_table(trees: Dict[str, ast.Module]) -> List[_Fn]:
    """Every module-level function and method; nested defs and lambdas
    stay part of their parent (they run where it runs)."""
    out: List[_Fn] = []
    for path, tree in trees.items():
        ext = _external_modules(tree)
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append(_Fn(path, node.name, node.name, None, node, ext))
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        out.append(_Fn(path, f"{node.name}.{sub.name}",
                                       sub.name, node.name, sub, ext))
    return out


def captured_functions(trees: Dict[str, ast.Module]
                       ) -> Dict[Tuple[str, str], ast.AST]:
    """(path, qualname) -> def node of every function reachable by name
    from a ``CAPTURE_ROOTS`` body in ``trees``. A call on ``self`` reaches
    the methods of that name in the caller's file (its class and the
    classes beside it; anywhere when the file has none), a call on
    another receiver every method or function of that name, and a bare
    call or a function passed by name the module-level functions of
    that name."""
    funcs = _function_table(trees)
    methods: Dict[str, List[_Fn]] = {}
    functions: Dict[str, List[_Fn]] = {}
    for f in funcs:
        (methods if f.cls else functions).setdefault(f.short, []).append(f)

    def targets(f: _Fn, kind: str, name: str) -> List[_Fn]:
        if kind == "name":
            return functions.get(name, [])
        if kind == "self":
            local = [g for g in methods.get(name, []) if g.path == f.path]
            return local or methods.get(name, [])
        return methods.get(name, []) + functions.get(name, [])

    work = [f for f in funcs if f.qual in CAPTURE_ROOTS]
    seen: Dict[Tuple[str, str], ast.AST] = {}
    while work:
        f = work.pop()
        key = (f.path, f.qual)
        if key in seen:
            continue
        seen[key] = f.node
        for kind, name in f.refs:
            for g in targets(f, kind, name):
                if (g.path, g.qual) not in seen:
                    work.append(g)
    return seen


# ---------------------------------------------------------------------------
# taint inside one captured function (L001/L002)
# ---------------------------------------------------------------------------


def _static_param(a: ast.arg) -> bool:
    if a.arg in ("self", "cls"):
        return True
    if a.annotation is not None:
        ann = ast.unparse(a.annotation)
        return "Tensor" not in ann and "Any" not in ann
    return False


class _Taint:
    def __init__(self, fn: ast.AST, inherited: Iterable[str] = ()) -> None:
        self.tainted: Set[str] = set(inherited)
        self.bools: Set[str] = set()
        args = fn.args
        for a in list(args.posonlyargs) + list(args.args):
            if not _static_param(a):
                self.tainted.add(a.arg)
            else:
                self.tainted.discard(a.arg)
        if args.vararg:
            self.tainted.add(args.vararg.arg)

    def expr(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in _UNTAINT_ATTRS:
                return False
            return self.expr(node.value)
        if isinstance(node, ast.Subscript):
            return self.expr(node.value)
        if isinstance(node, ast.Call):
            name = _call_name(node)
            last = _method(node)
            if isinstance(node.func, ast.Name) and last in _UNTAINT_CALLS:
                return False
            if isinstance(node.func, ast.Attribute):
                if last in _UNTAINT_METHODS:
                    return False
                if _torch_rooted(name):
                    return last not in _TORCH_HOST
                if self.expr(node.func.value):
                    return True
            return any(self.expr(a) for a in node.args) or any(
                self.expr(kw.value) for kw in node.keywords)
        if isinstance(node, ast.BinOp):
            return self.expr(node.left) or self.expr(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.expr(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.expr(v) for v in node.values)
        if isinstance(node, ast.Compare):
            # identity, and membership of a key in a dict, read no value
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            if isinstance(node.left, ast.Constant) and isinstance(
                    node.left.value, str) and all(
                    isinstance(op, (ast.In, ast.NotIn)) for op in node.ops):
                return False
            return self.expr(node.left) or any(
                self.expr(c) for c in node.comparators)
        if isinstance(node, ast.IfExp):
            return (self.expr(node.body) or self.expr(node.orelse)
                    or self.expr(node.test))
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.expr(e) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self.expr(node.value)
        return False

    def is_bool(self, node: ast.AST) -> bool:
        """A boolean tensor: a comparison or negation of a tensor value,
        a name bound to one, or a predicate op on one."""
        if isinstance(node, ast.Name):
            return node.id in self.bools
        if isinstance(node, ast.Compare):
            return self.expr(node)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op,
                                                        ast.Invert):
            return self.expr(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.is_bool(node.left) or self.is_bool(node.right)
        if isinstance(node, ast.Call) and _method(node) in _BOOL_CALLS:
            return self.expr(node)
        return False

    def assign(self, stmt: ast.AST) -> None:
        if isinstance(stmt, ast.Assign):
            val = self.expr(stmt.value)
            boolean = self.is_bool(stmt.value)
            for t in stmt.targets:
                self._mark(t, val)
                if boolean and isinstance(t, ast.Name):
                    self.bools.add(t.id)
        elif isinstance(stmt, ast.AugAssign):
            if self.expr(stmt.value) or self.expr(stmt.target):
                self._mark(stmt.target, True)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self._mark(stmt.target, self.expr(stmt.value))
        elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.comprehension)):
            self._mark(stmt.target, self.expr(stmt.iter))

    def _mark(self, target: ast.AST, val: bool) -> None:
        if not val:
            return
        if isinstance(target, ast.Name):
            self.tainted.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._mark(e, True)


def _own_nodes(fn: ast.AST) -> List[ast.AST]:
    """``fn``'s nodes, not descending into nested defs or lambdas (each
    is checked on its own, with ``fn``'s taint)."""
    out: List[ast.AST] = []
    body = fn.body if isinstance(fn.body, list) else [fn.body]

    def visit(n: ast.AST) -> None:
        out.append(n)
        for c in ast.iter_child_nodes(n):
            if not isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                visit(c)

    for s in body:
        visit(s)
    return out


def _nested(fn: ast.AST) -> List[ast.AST]:
    """The defs and lambdas directly nested in ``fn``."""
    out: List[ast.AST] = []
    for n in _own_nodes(fn):
        for c in ast.iter_child_nodes(n):
            if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                out.append(c)
    return out


def _to_cpu(call: ast.Call) -> bool:
    if _method(call) != "to":
        return False
    vals = list(call.args) + [k.value for k in call.keywords
                              if k.arg == "device"]
    for v in vals:
        if isinstance(v, ast.Constant) and v.value == "cpu":
            return True
        if isinstance(v, ast.Call) and _last_attr(_call_name(v)) == \
                "device" and v.args and isinstance(v.args[0], ast.Constant) \
                and v.args[0].value == "cpu":
            return True
    return False


def _check_captured_fn(fn: ast.AST, parents: _Parents, path: str,
                       inherited: Iterable[str] = ()) -> List[Violation]:
    out: List[Violation] = []
    taint = _Taint(fn, inherited)
    qual = parents.qualname(fn)
    nodes = _own_nodes(fn)
    # two forward passes so loop-carried assignments settle
    for _ in range(2):
        for node in nodes:
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                                 ast.For, ast.AsyncFor, ast.comprehension)):
                taint.assign(node)

    def v(rule: str, node: ast.AST, msg: str) -> None:
        out.append(Violation(rule, path, node.lineno, qual, msg))

    for node in nodes:
        if isinstance(node, ast.Call):
            name = _call_name(node) or ""
            last = _method(node)
            tainted_arg = any(taint.expr(a) for a in node.args)
            is_meth = isinstance(node.func, ast.Attribute)
            if isinstance(node.func, ast.Name) and \
                    last in _HOST_CAST_CALLS and tainted_arg:
                v("L001", node, f"{last}() of a tensor value syncs the "
                  "host inside a captured body")
            elif is_meth and last in _SYNC_ALWAYS:
                v("L001", node, f".{last}() inside a captured body syncs "
                  "the host (the capture raises on the card)")
            elif is_meth and last in _SYNC_TAINTED and \
                    taint.expr(node.func.value):
                v("L001", node, f".{last}() of a tensor value inside a "
                  "captured body syncs the host")
            elif last == "synchronize":
                v("L001", node, f"{name or last}() inside a captured body")
            elif name.split(".")[0] in _NP_ROOTS and last in (
                    "asarray", "array") and tainted_arg:
                v("L001", node, f"{name}() copies a tensor value to the "
                  "host inside a captured body")
            elif _to_cpu(node):
                v("L001", node, "a copy to the CPU inside a captured body")
            elif _torch_rooted(name) and last in _H2D_CALLS:
                v("L001", node, f"{name}() inside a captured body copies "
                  "host data to the device (pageable: a sync, and a "
                  "capture records no host read)")
            elif last in _DYNAMIC_SHAPE:
                v("L002", node, f"{last}() sizes its output by the data "
                  "(a sync, and a shape no replay can change)")
            elif last == "where" and _torch_rooted(name) and \
                    len(node.args) == 1 and not node.keywords:
                v("L002", node, "one-argument torch.where is nonzero: a "
                  "data-dependent shape")
        elif isinstance(node, (ast.If, ast.While, ast.IfExp)) and \
                taint.expr(node.test):
            v("L002", node, "Python branch on a tensor value (use "
              "torch.where / masked arithmetic)")
        elif isinstance(node, ast.Assert) and taint.expr(node.test):
            v("L002", node, "assert on a tensor value (a sync; check "
              "shapes, not values)")
        elif isinstance(node, ast.comprehension) and any(
                taint.expr(c) for c in node.ifs):
            v("L002", node.ifs[0], "comprehension filter on a tensor "
              "value")
        elif isinstance(node, ast.Subscript):
            idx = node.slice
            elts = idx.elts if isinstance(idx, ast.Tuple) else [idx]
            if any(taint.is_bool(e) for e in elts):
                v("L002", node, "boolean-mask index: a data-dependent "
                  "shape (use torch.where)")
    for sub in _nested(fn):
        out.extend(_check_captured_fn(sub, parents, path, taint.tainted))
    return out


# ---------------------------------------------------------------------------
# L004 — unsynced device timing
# ---------------------------------------------------------------------------


def _is_time_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = _call_name(node) or ""
    return (name.startswith("time.") and _last_attr(name) in _TIME_FNS) \
        or name in ("perf_counter", "monotonic")


def classify(nodes: Sequence[ast.AST]) -> Tuple[Optional[ast.Call], bool]:
    """(first call that launches device work, any torch sync present):
    the vocabularies L004 and O002 share."""
    device: Optional[ast.Call] = None
    synced = False
    for node in nodes:
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node) or ""
        last = _method(node)
        if last in _SYNC_CALLS:
            synced = True
        elif (_torch_rooted(name) and last not in _NON_DISPATCH) or \
                last.lstrip("_") in _DEVICE_HINTS:
            device = device or node
    return device, synced


def _check_timing(fn_body: Sequence[ast.stmt], qual: str, path: str
                  ) -> List[Violation]:
    out: List[Violation] = []
    starts: Dict[str, int] = {}
    spans: List[Tuple[str, int, int]] = []
    nodes = _walk_skip_fns(fn_body)
    for node in nodes:
        if isinstance(node, ast.Assign) and _is_time_call(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    starts[t.id] = node.lineno
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub):
            if _is_time_call(node.left) and isinstance(
                    node.right, ast.Name) and node.right.id in starts:
                spans.append((node.right.id, starts[node.right.id],
                              node.lineno))
    for var, lo, hi in spans:
        region = [n for n in nodes if lo < getattr(n, "lineno", -1) <= hi]
        device, synced = classify(region)
        if device is not None and not synced:
            out.append(Violation(
                "L004", path, device.lineno, qual,
                f"timed region ({var}: lines {lo}..{hi}) launches device "
                f"work ({_call_name(device) or _method(device)}) with no "
                "torch sync before its closing read — it measures the "
                "enqueue, not the work"))
    return out


# ---------------------------------------------------------------------------
# L005 — lifecycle pairing
# ---------------------------------------------------------------------------


def _stmts_after(node: ast.AST, parents: _Parents,
                 fn: ast.AST) -> List[ast.stmt]:
    """Statements that can still run after ``node`` succeeded, walking
    out through enclosing blocks up to ``fn``. Handlers of an enclosing
    ``try`` count only when a later try-body statement can raise after
    the acquire; ``finally`` and ``else`` always run."""
    cur: Optional[ast.AST] = node
    while cur is not None and not isinstance(cur, ast.stmt):
        cur = parents.parent.get(cur)
    out: List[ast.stmt] = []
    while cur is not None and cur is not fn:
        block = parents.parent.get(cur)
        if block is None:
            break
        hit = False
        for field in ("body", "orelse", "finalbody"):
            seq = getattr(block, field, None)
            if isinstance(seq, list) and cur in seq:
                hit = True
                idx = seq.index(cur)
                out.extend(seq[idx + 1:])
                if isinstance(block, ast.Try) and field == "body":
                    if idx + 1 < len(seq):
                        for h in block.handlers:
                            out.extend(h.body)
                    out.extend(block.orelse)
                    out.extend(block.finalbody)
        if not hit and isinstance(block, ast.ExceptHandler) and \
                cur in block.body:
            out.extend(block.body[block.body.index(cur) + 1:])
        if block is fn:
            break
        cur = block if isinstance(
            block, (ast.stmt, ast.excepthandler)) else None
    return out


def _check_lifecycles(fn: ast.AST, parents: _Parents, path: str
                      ) -> List[Violation]:
    out: List[Violation] = []
    qual = parents.qualname(fn)
    all_calls = [n for s in fn.body for n in ast.walk(s)
                 if isinstance(n, ast.Call)]
    released = {_method(c) for c in all_calls}
    for call in all_calls:
        attr = _method(call)
        if attr not in _ACQUIRE_RELEASE or not isinstance(
                call.func, ast.Attribute):
            continue
        partners = _ACQUIRE_RELEASE[attr]
        if partners & released:
            continue                      # paired somewhere in the fn
        risky = None
        for stmt in _stmts_after(call, parents, fn):
            for n in ast.walk(stmt):
                if isinstance(n, ast.Call):
                    last = _method(n)
                    if last not in _SAFE_CALLS and last not in partners:
                        risky = n
                        break
            if risky is not None:
                break
        if risky is not None:
            out.append(Violation(
                "L005", path, call.lineno, qual,
                f"{attr}() with no matching "
                f"{'/'.join(sorted(partners))} in this function, and a "
                f"later call ({_call_name(risky) or '?'}:{risky.lineno})"
                " can raise — the exception path leaks the reference"))
    return out


# ---------------------------------------------------------------------------
# L006 — prefill shapes come from the bucket ladders
# ---------------------------------------------------------------------------

# call -> positions of (token-array args, chunk-index args)
_BUCKET_FNS = {"_prefill": ((0,), ()), "_paged_prefill": ((0,), ()),
               "_paged_suffix": ((1,), (0,))}
_BUCKET_SOURCES = {"bucket_for", "pad_shape", "make_buckets"}
_BUCKET_ATTRS = {"chunk_len", "max_len", "len_buckets", "batch_buckets",
                 "page", "speculate_k", "n_experts", "n_logical", "trash"}
_BUCKET_CALLS = {"range", "min", "max", "len", "sum", "sorted", "tuple",
                 "list", "int"}
_ARRAY_CALLS = {"zeros", "full", "empty", "ones"}


class _Ladder:
    """Names, array names and dict keys bound (anywhere in the file) to
    ladder-derived values; propagated until nothing changes."""

    def __init__(self, tree: ast.AST) -> None:
        self.names: Set[str] = set()
        self.arrays: Set[str] = set()
        self.keys: Set[str] = set()
        bad_keys: Set[str] = set()
        for _ in range(3):
            for node in ast.walk(tree):
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        self._bind(t, node.value)
                elif isinstance(node, ast.AnnAssign) and node.value:
                    self._bind(node.target, node.value)
                elif isinstance(node, (ast.For, ast.AsyncFor,
                                       ast.comprehension)) and \
                        self.ok(node.iter):
                    self._mark(node.target)
                elif isinstance(node, ast.Dict):
                    for k, val in zip(node.keys, node.values):
                        if isinstance(k, ast.Constant) and isinstance(
                                k.value, str):
                            if self.ok(val) or self.array(val):
                                self.keys.add(k.value)
                            else:
                                bad_keys.add(k.value)
        self.keys -= bad_keys

    def _mark(self, target: ast.AST) -> None:
        if isinstance(target, ast.Name):
            self.names.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._mark(e)

    def _bind(self, target: ast.AST, value: ast.AST) -> None:
        if isinstance(target, ast.Name) and self.array(value):
            self.arrays.add(target.id)
        elif self.ok(value):
            self._mark(target)

    def ok(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Constant):
            return isinstance(node.value, int)
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Attribute):
            return node.attr in _BUCKET_ATTRS
        if isinstance(node, ast.Subscript):
            if isinstance(node.slice, ast.Constant) and \
                    isinstance(node.slice.value, str):
                return node.slice.value in self.keys
            return self.ok(node.value)
        if isinstance(node, ast.BinOp):
            return self.ok(node.left) and self.ok(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.ok(node.operand)
        if isinstance(node, ast.Call):
            last = _method(node)
            if last in _BUCKET_SOURCES:
                return True
            if last in _BUCKET_CALLS:
                return all(self.ok(a) for a in node.args)
            return False
        if isinstance(node, (ast.Tuple, ast.List)):
            return all(self.ok(e) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return self.ok(node.body) and self.ok(node.orelse)
        return False

    def array(self, node: ast.AST) -> bool:
        """An array whose shape is ladder-derived: ``np.zeros((E, Bb,
        Sb))``-style, a name bound to one, or a descriptor's entry."""
        if isinstance(node, ast.Name):
            return node.id in self.arrays
        if isinstance(node, ast.Subscript) and isinstance(
                node.slice, ast.Constant) and isinstance(node.slice.value,
                                                         str):
            return node.slice.value in self.keys
        if isinstance(node, ast.Call) and _method(node) in _ARRAY_CALLS \
                and (_call_name(node) or "").split(".")[0] in _NP_ROOTS \
                and node.args:
            return self.ok(node.args[0])
        return False


def _check_bucket_shapes(tree: ast.AST, parents: _Parents,
                         path: str) -> List[Violation]:
    """L006: every ``_prefill(toks)`` / ``_paged_prefill(toks, stbl)`` /
    ``_paged_suffix(k, toks, ...)`` call site passes a token array of
    ladder shape and a ladder chunk index."""
    out: List[Violation] = []
    ladder = _Ladder(tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not isinstance(
                node.func, ast.Attribute):
            continue
        spec = _BUCKET_FNS.get(node.func.attr)
        if spec is None:
            continue
        arrays, ints = spec
        bad = [node.args[i] for i in arrays
               if i < len(node.args) and not ladder.array(node.args[i])]
        bad += [node.args[i] for i in ints
                if i < len(node.args) and not ladder.ok(node.args[i])]
        for arg in bad:
            out.append(Violation(
                "L006", path, node.lineno, parents.qualname(node),
                f"{node.func.attr}() argument {ast.unparse(arg)} is not "
                "derived from the bucket ladders (bucket_for / pad_shape "
                "/ chunk_len / len_buckets): every distinct value keys "
                "a new prefill shape, breaking the bounded ladder"))
    return out


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def default_paths(root: str = REPO_ROOT) -> List[str]:
    out: List[str] = []
    for dirpath, _dirs, files in os.walk(os.path.join(root, PACKAGE)):
        for f in sorted(files):
            if f.endswith(".py"):
                out.append(os.path.join(dirpath, f))
    for f in EXTRA_FILES:
        if os.path.exists(os.path.join(root, f)):
            out.append(os.path.join(root, f))
    return sorted(out)


def read_sources(paths: Optional[Sequence[str]] = None,
                 root: str = REPO_ROOT) -> Dict[str, str]:
    """{repo-relative path: source} of ``paths`` (default: the package
    and ``chip_smoke.py``)."""
    out: Dict[str, str] = {}
    for p in (paths or default_paths(root)):
        rel = os.path.relpath(p, root) if os.path.isabs(p) else p
        with open(os.path.join(root, rel), encoding="utf-8") as fh:
            out[rel.replace(os.sep, "/")] = fh.read()
    return out


def _in_package(path: str) -> bool:
    return path.startswith(PACKAGE + "/")


def lint_sources(sources: Dict[str, str]) -> List[Violation]:
    """Lint ``{repo-relative path: source}`` as one unit: captured bodies
    are worked out over its package files (paths under
    ``src/repro_torch/``)."""
    trees = {p: ast.parse(s, filename=p) for p, s in sources.items()}
    parents = {p: _Parents(t) for p, t in trees.items()}
    out: List[Violation] = []
    captured = captured_functions(
        {p: t for p, t in trees.items() if _in_package(p)})
    for (path, _qual), node in sorted(captured.items(),
                                      key=lambda kv: kv[0]):
        out.extend(_check_captured_fn(node, parents[path], path))
    for path, tree in trees.items():
        par = parents[path]
        # L003 — the graph ladder read outside its home
        if path != _LADDER_HOME:
            for node in ast.walk(tree):
                if isinstance(node, ast.Attribute) and \
                        node.attr in _LADDER_ATTRS:
                    out.append(Violation(
                        "L003", path, node.lineno, par.qualname(node),
                        f"{node.attr} read outside serve/core.py: read the "
                        "ladder through EngineStats (decode_compiles / "
                        "verify_compiles / decode_graphs) or "
                        "EngineCore.step_graphs()"))
        # L004 — unsynced timing, per function and at module level
        fns = [n for n in ast.walk(tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for fn in fns:
            out.extend(_check_timing(fn.body, par.qualname(fn), path))
        out.extend(_check_timing(
            [s for s in tree.body
             if not isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef))], "<module>", path))
        # L005 — lifecycle pairing in the client modules
        if path in _LIFECYCLE_FILES:
            for fn in fns:
                out.extend(_check_lifecycles(fn, par, path))
        # L006 — prefill shapes come from the bucket ladders
        out.extend(_check_bucket_shapes(tree, par, path))
    return out


def lint_source(src: str, path: str) -> List[Violation]:
    """Lint one file's source on its own (its captured bodies are those
    it defines). ``path`` is the repo-relative name used in reports."""
    return lint_sources({path: src})


def run(paths: Optional[Sequence[str]] = None,
        root: str = REPO_ROOT) -> List[Violation]:
    return lint_sources(read_sources(paths, root))
