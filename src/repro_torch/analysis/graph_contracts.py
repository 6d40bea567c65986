"""Graph contract gate (rules H001-H004): the promises the reference's
``hlo_contracts`` reads off compiled HLO, checked over the port's step
graphs and eager steps.

The serving invariants — caches written in place, a decode tick with no
host round trip, bank params on their mesh positions, a bounded ladder
of step graphs — are silent in Python: a model that rebinds a cache leaf
leaves a captured graph reading the old buffer, a host sync inside a
decode body only shows when the card captures it, a misplaced slot just
runs slower. This pass builds the reference's engine set — a ring hub
and a chunked paged hub, each a bank over a 2-position ``ExpertMesh``,
and a speculating engine on a wrap-risk admission grid — and a
constant-state engine whose rows share replays (``RowSlots``), drives
each through its whole ladder, and checks:

  H001  written in place: every cache leaf keeps its
        ``untyped_storage().data_ptr()`` across prefill, decode, verify,
        copy-on-write copies and hub slot installs — the ring graphs'
        static state and buffers from step to step, the paged pools
        (which hold the prefills' writes), the draft state, and the slot
        bank (whose tensors hold the installed expert after a commit).
  H002  a device-pure tick: a ``TorchDispatchMode`` records the aten ops
        of every decode and verify body and flags
        ``aten._local_scalar_dense``, ``nonzero``, ``masked_select``,
        ``unique*``, ``bincount`` and any copy to the CPU of a device
        tensor. On the card each capture also runs under
        ``torch.cuda.set_sync_debug_mode("error")``.
  H003  bank placements: every param leaf, pool and step graph of a bank
        built on a mesh sits on the position ``leading_sharding`` names.
  H004  graph count: after a full warm-up, ``EngineStats`` equals
        ``executable_bounds()`` exactly (prefill shapes, suffix shapes,
        decode and verify graphs), installs capture nothing, every graph
        stepped at least twice (a graph captures at its second step) and
        on the card holds its capture; the spec grid fills both the
        verify ladder and its gate-blocked decode fallback; row-slot
        installs, packing and group swaps make no graph and keep the
        slab's storage.

Runs on the card unless ``device="cpu"``; without a card it raises (no
fallback to the CPU). The engines serve ``smollm_135m``, the main
path's serving config (the row-slot engine ``rwkv6_7b``): reduced for
the CPU gate, at full width and depth for ``chip_smoke.py``'s
``contracts`` phase (``reduced=False``).
"""
from __future__ import annotations

import collections
import contextlib
from typing import Any, Dict, Iterator, List, Tuple

from . import Violation

ARCH = "smollm_135m"
SLOT_ARCH = "rwkv6_7b"
CORE = "src/repro_torch/serve/core.py"
GRAPHS = "src/repro_torch/serve/graphs.py"
HUB = "src/repro_torch/serve/hub.py"

#: aten ops that sync the host or size an output by the data
_IMPURE = {"_local_scalar_dense", "nonzero", "masked_select", "unique",
           "_unique", "_unique2", "unique_dim", "unique_consecutive",
           "unique_dim_consecutive", "bincount", "argwhere", "item"}
_COPIES = {"_to_copy", "copy_", "to", "_copy_from", "copy"}
#: the static buffers of a step graph (``serve/graphs.py``)
_BUFFERS = ("tok", "out", "pos", "t", "table", "cap")


def _leaves(tree) -> List[Any]:
    from ..tree import leaves
    return leaves(tree) if tree is not None else []


def _ptrs(tree) -> List[int]:
    return [t.untyped_storage().data_ptr() for t in _leaves(tree)]


# ---------------------------------------------------------------------------
# H001 / H002 instrumentation of the step graphs
# ---------------------------------------------------------------------------


class _OpLog:
    """A ``TorchDispatchMode`` factory recording, per body kind, the
    impure aten ops a body ran."""

    def __init__(self):
        self.found: Dict[str, collections.Counter] = collections.defaultdict(
            collections.Counter)
        self.bodies: collections.Counter = collections.Counter()

    def mode(self, kind: str):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode
        found = self.found[kind]

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                name = func.overloadpacket.__name__
                if name in _IMPURE:
                    found[f"aten.{name}"] += 1
                elif name in _COPIES:
                    srcs = [a for a in list(args) + list(kwargs.values())
                            if isinstance(a, torch.Tensor)]
                    outs = out if isinstance(out, (tuple, list)) else [out]
                    if any(isinstance(o, torch.Tensor)
                           and o.device.type == "cpu" for o in outs) and \
                            any(a.device.type != "cpu" for a in srcs):
                        found[f"aten.{name} to the CPU"] += 1
                return out

        return Mode()


@contextlib.contextmanager
def instrument_steps() -> Iterator[Tuple[_OpLog, List[str]]]:
    """While inside: every decode / verify body runs under an ``_OpLog``
    mode (and, while a CUDA capture is running, under sync debug mode
    "error"), and every step checks that its graph's static state and
    buffers keep their storage. Yields (op log, H001 messages)."""
    import torch

    from ..serve.graphs import DecodeGraph, VerifyGraph, _StepGraph

    log, moved = _OpLog(), []
    # id -> (graph, its addresses after its first step): the graph is
    # held so that no other object takes its id while this runs
    seen: Dict[int, Tuple[Any, Dict[str, int]]] = {}
    bodies = {DecodeGraph: ("decode", DecodeGraph._body),
              VerifyGraph: ("verify", VerifyGraph._body)}
    run = _StepGraph._run

    def wrap(kind, body):
        def _body(self):
            log.bodies[kind] += 1
            with log.mode(kind):
                if self.dev.type == "cuda" and \
                        torch.cuda.is_current_stream_capturing():
                    prev = torch.cuda.get_sync_debug_mode()
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        body(self)
                    finally:
                        torch.cuda.set_sync_debug_mode(prev)
                else:
                    body(self)
        return _body

    def addresses(g) -> Dict[str, int]:
        out = {}
        for name in _BUFFERS:
            t = getattr(g, name, None)
            if isinstance(t, torch.Tensor):
                out[name] = t.untyped_storage().data_ptr()
        for i, p in enumerate(_ptrs(g.state)):
            out[f"state[{i}]"] = p
        return out

    def checked_run(self):
        before = addresses(self)
        run(self)
        after = addresses(self)
        first = seen.setdefault(id(self), (self, after))[1]
        label = f"{type(self).__name__}[Bb={self.Bb},p={self.p}]"
        for name, ptr in after.items():
            if before.get(name, ptr) != ptr or first.get(name, ptr) != ptr:
                moved.append(f"{label} {name} moved to new storage")

    try:
        for cls, (kind, body) in bodies.items():
            cls._body = wrap(kind, body)
        _StepGraph._run = checked_run
        yield log, moved
    finally:
        for cls, (kind, body) in bodies.items():
            cls._body = body
        _StepGraph._run = run


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------


def _bounds(core, label: str, path: str = CORE) -> List[Violation]:
    """H004: the ladder counts equal the declared bounds exactly."""
    out = []
    st, b = core.stats, core.executable_bounds()
    got = {"prefill": st.prefill_compiles, "suffix": st.suffix_compiles,
           "decode": st.decode_compiles, "verify": st.verify_compiles}
    for fam, n in got.items():
        if n != b[fam]:
            out.append(Violation(
                "H004", path, 0, f"{label}.{fam}_ladder",
                f"{fam} {'graphs' if fam in ('decode', 'verify') else 'shapes'}"
                f" after the full warm-up: {n}, executable_bounds() "
                f"declares {b[fam]}"))
    # a graph captures at its second step: the warm-up must step every
    # graph twice, and on the card every such graph holds its capture
    for kind, key, g in core.step_graphs():
        if g.steps < 2:
            out.append(Violation(
                "H004", GRAPHS, 0, f"{label}.{kind}_warmup",
                f"{kind} graph {key} of position {g.p} stepped "
                f"{g.steps} time(s) in the warm-up: its capture is "
                "unchecked"))
        elif g.capture and g.graph is None:
            out.append(Violation(
                "H004", GRAPHS, 0, f"{label}.captures",
                f"{kind} graph {key} of position {g.p} stepped {g.steps} "
                "times and holds no capture"))
    return out


def _placement(core, mesh, label: str) -> List[Violation]:
    """H003: params, pools and step graphs on their mesh positions."""
    from ..sharding import leading_sharding

    out = []

    def v(msg):
        out.append(Violation("H003", CORE, 0, label, msg))

    n = len(mesh.devices)
    where = leading_sharding(core.n_experts, "expert", mesh)
    if where is None or len(core.devices) != n:
        v(f"a bank of {core.n_experts} on a mesh of {n} has no placement "
          f"({len(core.devices)} positions)")
        return out
    for e, params in enumerate(core.params):
        want = core.devices[where[e]]
        bad = [t for t in _leaves(params) if t.device != want]
        if bad:
            v(f"member {e}: {len(bad)} param leaves on {bad[0].device}, "
              f"leading_sharding names position {where[e]} ({want})")
    for p, pool in enumerate(core.kv_pool or []):
        for k, t in pool.items():
            if t.device != core.devices[p] or t.shape[0] != core.per_pos:
                v(f"pool {k} of position {p}: {tuple(t.shape)} on "
                  f"{t.device}, expected {core.per_pos} members on "
                  f"{core.devices[p]}")
    if core.kv_pool is not None and len(core.kv_pool) > 1:
        starts = [core.kv_pool[p]["k"].untyped_storage().data_ptr()
                  for p in range(len(core.kv_pool))]
        if len(set(starts)) != len(starts):
            v("two positions share one pool's storage")
    per_key: Dict[Any, List[int]] = collections.defaultdict(list)
    for kind, key, g in core.step_graphs():
        per_key[(kind, key)].append(g.p)
        if g.dev != core.devices[g.p]:
            v(f"{kind} graph {key} of position {g.p} on {g.dev}")
    for (kind, key), ps in per_key.items():
        if ps != list(range(n)):
            v(f"{kind} step {key} has graphs for positions {ps}, the mesh "
              f"{n}")
    return out


def step_findings(log: _OpLog, moved: List[str],
                  kinds: Tuple[str, ...] = ("decode", "verify")
                  ) -> List[Violation]:
    """H001 for the step buffers that moved and H002 for what the
    instrumented bodies ran (``instrument_steps``' yield); ``kinds``: the
    bodies the caller's traffic must have run."""
    out = [Violation("H001", CORE, 0, msg.split(" ")[0], msg)
           for msg in dict.fromkeys(moved)]
    return out + _impure(log, kinds)


def _impure(log: _OpLog, kinds: Tuple[str, ...] = ("decode", "verify")
            ) -> List[Violation]:
    """H002 over what the instrumented bodies ran."""
    out = []
    for kind, found in sorted(log.found.items()):
        for op, n in sorted(found.items()):
            out.append(Violation(
                "H002", GRAPHS, 0, f"{kind}_body",
                f"the {kind} body ran {op} ({n}x): a host round trip or a "
                "data-dependent shape inside a captured step"))
    for kind in kinds:
        if not log.bodies[kind]:
            out.append(Violation(
                "H002", GRAPHS, 0, f"{kind}_body",
                f"no {kind} body ran: the gate drove nothing to check"))
    return out


# ---------------------------------------------------------------------------
# the engine set
# ---------------------------------------------------------------------------


def _model(reduced: bool, arch: str = ARCH):
    from ..configs import get_config
    from ..models import build_model
    cfg = get_config(arch)
    cfg = cfg.reduced(name=f"contracts-{arch}") if reduced else cfg
    return build_model(cfg)


def _drive(bank, prompts, max_new: int, tag: str) -> None:
    """One wave of ``prompts`` through a bank's member 0, to the end."""
    uids = [(tag, i) for i in range(len(prompts))]
    bank.admit({0: (uids, prompts, [max_new] * len(prompts))})
    while bank.n_active:
        bank.tick()
    bank.poll()


def _hub_checks(model, dev, layout: str, label: str
                ) -> Tuple[List[Violation], List[str]]:
    """A 4-slot hub over a 2-position mesh, warmed through its whole
    ladder, experts committed, then a wrapping wave of duplicate prompts
    (copy-on-write on the paged layout). Returns (H001/H003/H004
    findings, H001 messages)."""
    import numpy as np
    import torch

    from ..launch.mesh import ExpertMesh
    from ..serve import ExpertHub

    mesh = ExpertMesh((dev, dev))
    kw = dict(kv_layout="paged", chunk_len=8, page_size=8) \
        if layout == "paged" else {}
    hub = ExpertHub(model, n_slots=4, max_len=32, min_len_bucket=8,
                    batch_buckets=(1, 2), mesh=mesh, device=dev, **kw)
    out: List[Violation] = []
    moved: List[str] = []
    try:
        params = [model.init(torch.Generator(device=dev).manual_seed(i),
                             device=dev) for i in range(hub.n_slots)]
        for i, p in enumerate(params):
            hub.add_expert(f"{label}{i}", p)
        core = hub.bank.core
        slots = [_ptrs(p) for p in hub.bank.params]
        pools = [_ptrs(p) for p in (core.kv_pool or [])]
        hub.warmup(max_batch=core.batch_buckets[-1], commit=False)
        out += _bounds(core, label)
        graphs = core.stats.decode_compiles
        # installs write the slot's tensors in place and capture nothing
        for e in range(hub.n_slots):
            hub.want(e)
        while hub.has_wanted:
            if not hub.service(block=True):
                break
        for s, before in enumerate(slots):
            if _ptrs(hub.bank.params[s]) != before:
                moved.append(f"{label} slot {s}'s params moved on install")
            e = hub.expert_in(s)
            if e is not None and not all(
                    torch.equal(d.cpu(), h.cpu()) for d, h in zip(
                        _leaves(hub.bank.params[s]),
                        _leaves(hub.catalog[e].params))):
                moved.append(f"{label} slot {s} does not hold expert {e}'s "
                             "params after its install")
        rng = np.random.default_rng(1)
        prompt = rng.integers(0, 100, size=32)
        _drive(hub.bank, [prompt, prompt.copy()], 4, f"{label}-cow")
        if core.stats.decode_compiles != graphs:
            out.append(Violation(
                "H004", HUB, 0, f"{label}.install",
                f"{core.stats.decode_compiles - graphs} decode graphs made "
                "after the warm-up (installs and traffic must reuse the "
                "ladder)"))
        if layout == "paged":
            if not core.stats.pages_copied:
                moved.append(f"{label}: the wrapping duplicate wave made "
                             "no copy-on-write copy")
            if [_ptrs(p) for p in core.kv_pool] != pools:
                moved.append(f"{label} page pool moved to new storage")
            if not any(bool(p["k"].abs().sum()) for p in core.kv_pool):
                moved.append(f"{label} page pool holds no prefill write")
        out += _placement(core, mesh, label)
    finally:
        hub.close()
    return out, moved


def _spec_checks(model, dev) -> Tuple[List[Violation], List[str]]:
    """An E=1 ring engine speculating k=2 with the table draft over the
    wrap-risk grid: Sb 8 waves verify, Sb 16 waves fail the no-wrap gate
    and decode plainly, so both ladders must be exactly full."""
    import numpy as np
    import torch

    from ..serve import ExpertEngine

    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    eng = ExpertEngine(model, params, max_len=16, min_len_bucket=8,
                       batch_buckets=(1, 2), speculate_k=2, draft="table",
                       device=dev)
    core = eng.core
    draft = [_ptrs(s) for s in core.draft_state]
    # each (length, batch) twice: a graph's steps add up over its waves,
    # so every verify and decode graph steps at least twice (a spec
    # wave may end after one verify)
    for Sb, max_new in ((8, 4), (16, 2)):
        for Bb in core.batch_buckets:
            for _ in range(2):
                eng.generate(np.full((Bb, Sb), 3, np.int32), max_new)
    out = _bounds(core, "spec")
    if not core.stats.spec_fallback_waves:
        out.append(Violation(
            "H004", CORE, 0, "spec.fallback_gate",
            "no admission of the wrap-risk grid failed the no-wrap gate: "
            "the fallback decode ladder's bound proved nothing"))
    if not core.stats.verify_steps:
        out.append(Violation("H004", CORE, 0, "spec.verify_ladder",
                             "the spec grid ran no verify"))
    moved = []
    if [_ptrs(s) for s in core.draft_state] != draft:
        moved.append("spec draft state moved to new storage")
    return out, moved


def _slot_checks(model, dev) -> Tuple[List[Violation], List[str]]:
    """A constant-state engine (row slots) through its whole ladder, one
    wave at a time, then three waves of two rows at once over groups of
    two slots: installs, packing and group swaps run outside the
    captured body, make no graph and keep the slab's storage."""
    import numpy as np
    import torch

    from ..serve import ExpertEngine

    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    eng = ExpertEngine(model, params, max_len=16, min_len_bucket=8,
                       batch_buckets=(1, 2), device=dev)
    core = eng.core
    if core.row_slots is None:
        return [Violation("H004", CORE, 0, "slots.engaged",
                          f"a {model.cfg.family} ring engine (constant-size "
                          "state) holds no row slots")], []
    # each (length, batch) once, three tokens a row: every graph steps
    # twice a wave
    for Sb in core.len_buckets:
        for Bb in core.batch_buckets:
            eng.generate(np.full((Bb, Sb), 3, np.int32), 3)
    out = _bounds(core, "slots")
    graphs = core.stats.decode_compiles
    slab = [_ptrs(s) for s in core.row_slots.slab]
    for i in range(3):
        eng.admit([("slots", i, r) for r in range(2)],
                  [np.full(4 + 4 * i, 5 + i, np.int32)] * 2, [4, 6],
                  defer=True)
    while eng.n_active:
        eng.tick(defer=True)
        eng.harvest()
    eng.poll()
    st = core.stats
    if st.decode_compiles != graphs:
        out.append(Violation(
            "H004", GRAPHS, 0, "slots.merged",
            f"{st.decode_compiles - graphs} decode graphs made by merged "
            "waves after the warm-up"))
    if not st.decode_swaps:
        out.append(Violation(
            "H004", GRAPHS, 0, "slots.swaps",
            "six rows over groups of two swapped no group: the swap path "
            "went unchecked"))
    moved = [] if [_ptrs(s) for s in core.row_slots.slab] == slab else \
        ["slots: the row slab moved to new storage"]
    return out, moved


def run(device=None, *, reduced: bool = True) -> List[Violation]:
    """H001-H004 over the engine set on ``device`` (the card unless
    ``"cpu"``; raises without one)."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    model = _model(reduced)
    out: List[Violation] = []
    moved: List[str] = []
    with torch.no_grad(), instrument_steps() as (log, graph_moves):
        for layout, label in (("ring", "ring_hub"),
                              ("paged", "paged_hub")):
            found, m = _hub_checks(model, dev, layout, label)
            out += found
            moved += m
        found, m = _spec_checks(model, dev)
        out += found
        moved += m
        found, m = _slot_checks(_model(reduced, SLOT_ARCH), dev)
        out += found
        moved += m
    return out + step_findings(log, graph_moves + moved)
