"""One decode step per (engine, mesh position, decode batch bucket),
captured once as a CUDA graph and replayed for every later step of every
wave at that bucket: the counterpart of the reference's
``EngineCore._decode_fn(Bb)`` (``jax.jit(jax.vmap(model.decode),
donate_argnums=(1,))``, one executable per batch bucket, the cache
donated and so written in place). ``VerifyGraph`` is the same for a
speculative engine's verify step, one per (engine, position, batch
bucket, k), the counterpart of ``_verify_fn(Bb, k)``. A CUDA graph
belongs to one device, where the reference's SPMD executable spans the
expert mesh: position ``p``'s graph steps the members that live on
``p``, on ``p``'s tensors (without a mesh, one position holds them all).

A CUDA graph reads and writes fixed addresses, so a ``DecodeGraph``
owns static buffers: the token plane it reads, the token plane it
writes (the greedy argmax is inside the captured region, so a replay
returns ``(E, Bb, 1)`` int32 tokens, never logits), and the state the
step updates in place.

  * **ring** waves each own a cache, so the graph's state belongs to
    one *resident* wave at a time. The first wave to step is adopted:
    its cache tensors become the static state, no copy. A resident wave
    replays with no copy; another wave of the bucket swaps in (the
    resident's state is copied out to tensors of its own, the newcomer's
    copied in), about 2 x the cache's bytes. A retired wave leaves
    nothing to copy out. While a wave is resident its ``cache`` is stale:
    the static state is its live state.
  * **paged** waves keep their K/V in the engine's pool, whose address
    never changes; only the page table, ``pos``, ``t`` and the token
    plane are copied in (a few KB) and ``pos``/``t`` copied back out.
  * **row slots** (``RowSlots``): a ring core whose model keeps a
    constant-size decode state (``cache_capacity`` 1: RWKV6) reads no
    position in decode, and each row's state is its own along the batch
    axis, so rows of different waves can share one replay. When a
    wave's prefill lands, each row that decodes is copied into a free
    slot of a *group* of ``Bmax`` (the largest batch bucket) slots, and
    the wave's cache is dropped. Every graph's static state is the
    leading ``Bb`` rows of one ``Bmax``-row slab a position; a tick
    replays each group with live rows once, at the smallest bucket that
    covers its occupied slots. Rows are packed first (``RowSlots.pack``)
    so that a tick replays ``ceil(live rows / Bmax)`` groups; the group
    in the slab replays first, each other group swaps in as a resident
    ring wave does. A finished row's slot is free at once (later copies
    follow the replay on the stream); until reused it computes as
    padding, never read.

On CUDA the first step at a new bucket runs eagerly on a side stream
(the wave's real step; it warms cuBLAS and the allocator), the second
captures the body and replays it (capture records, it does not
execute), and every later step is copy in, ``replay()``, copy out. Each
graph captures and runs with its position's device current; the graphs
of one engine on one device share one memory pool and one capture
stream, and replay one after another on that device's current stream.
A capture or replay that fails raises: there is
no silent eager fallback. ``capture=False`` (the engine's
``capture_decode``) and the CPU run the same body eagerly on the same
static buffers, so the residency and copy-out logic is the same on
every device.

A verify step (``VerifyGraph``) runs propose, verify, accept and
observe in one body. Ring spec waves swap their K/V through the static
state as decode waves do; ring and paged spec waves copy their per-row
``row_pos`` (E/n, Bb, C), ``row_t`` (E/n, Bb), ``cap`` and token plane in
(paged waves their page table too) and ``row_pos``/``row_t`` back out.
The draft's state is the engine's, updated in place at fixed addresses.
The outputs (greedy window, advance, accepted count, next token) are
packed in one static plane and cloned out: they wait on the device until
harvest.

Each step is timed on the device by a ``decode.replay`` (or
``verify.replay``) range of the engine's tracer, from the first copy in
to the clone of the output, and each ring swap by a ``ring.swap`` range
and a host span of that name: all outside the captured body, so a replay
times the same work on every step. A bucket's eager and capture steps
are marked (``eager``, ``captured``) for readers to leave out.

The kernel wrappers count Python calls. A capture calls them without
launching anything, a replay launches without calling them: the graph
records each wrapper's count during capture, takes it back, and adds it
on every replay (``kernels.ops.add_launches``), so the counters still
say how many kernels ran.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..device import on_device
from ..kernels import ops
from ..obs.trace import NULL_RANGE
from ..tree import leaves, tree_map


def _i32(shape, dev) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.int32, device=dev)


class _StepGraph:
    """What a decode and a verify step share: eager, capture and replay on
    static buffers, and the residency of ring waves' caches."""

    def __init__(self, core, p: int, Bb: int, *, capture: bool,
                 pool: Any = None,
                 stream: Optional["torch.cuda.Stream"] = None):
        self.core, self.p, self.Bb = core, p, Bb
        self.dev = core.devices[p]
        self.n = core.per_pos                # the position's members
        self.paged = core.kv_layout == "paged"
        if self.paged:
            self.table = _i32((self.n, Bb, core.n_logical), self.dev)
        self.state: Optional[Dict[str, Any]] = None   # ring: static cache
        self.resident = None                 # ring: the wave it belongs to
        self.capture = capture               # CUDA only (the core decides)
        self._pool, self._stream = pool, stream
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.steps = 0
        self.capture_ms = 0.0                # host clock, capture only
        self.launches: Dict[str, int] = {}   # wrapper launches a replay

    def _body(self) -> None:
        raise NotImplementedError

    def _range(self, name: str, w=None, **args):
        """The device range of one step of wave ``w``: its engine,
        position, bucket, the waves it carries (``waves``), real rows,
        rows still short of their ``max_new``, live cache slots after the
        step and the wave's step index ``j``; a row group's step gives
        its own ``args`` instead of ``w``. ``eager`` / ``captured`` where
        the step runs eagerly before its capture, or captures. The null
        range when the tracer is off."""
        core = self.core
        tr = core.tracer
        if not tr.enabled:
            return NULL_RANGE
        if w is not None:
            j = w.ticks
            news = [m for ms in w.per_row_new.values() for m in ms]
            live = sum(not d for ds in w.done.values() for d in ds) \
                if w.spec else sum(m > j + 1 for m in news)
            args = dict(wave=w.wave_id, waves=[w.wave_id], rows=len(news),
                        live_rows=live,
                        slots=min(w.Sb + j + 1, core.max_len), j=j)
        args = dict(engine=core.trace_engine, position=self.p, Bb=self.Bb,
                    **args)
        if self.capture and self.steps == 0:
            args["eager"] = True
        elif self.capture and self.graph is None:
            args["captured"] = True
        return tr.device_range(name, device=self.dev, **args)

    def _run(self) -> None:
        with on_device(self.dev):
            if not self.capture:
                self._body()
            elif self.steps == 0:
                cur = torch.cuda.current_stream(self.dev)
                self._stream.wait_stream(cur)
                with torch.cuda.stream(self._stream):
                    self._body()
                cur.wait_stream(self._stream)
            else:
                if self.graph is None:
                    self._capture()
                self.graph.replay()
                ops.add_launches(self.launches)
        self.steps += 1

    def _capture(self) -> None:
        before = ops.launches()
        # a dead engine's graphs sit in reference cycles (core <-> stats,
        # core <-> graph); were the cyclic collector to destroy one while
        # this capture runs, the destruction would invalidate the capture
        # (global capture mode), and torch.cuda.graph no longer collects
        # on entry: collect first, and keep the collector off until the
        # capture ends
        gc.collect()
        was_on = gc.isenabled()
        gc.disable()
        t0 = time.perf_counter()
        try:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream):
                self._body()
        finally:
            if was_on:
                gc.enable()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        after = ops.launches()
        self.launches = {k: n - before[k] for k, n in after.items()
                         if n != before[k]}
        ops.add_launches({k: -n for k, n in self.launches.items()})
        self.graph = graph

    # -- ring residency --------------------------------------------------
    def _make_resident(self, w) -> None:
        if self.resident is w:
            return
        p = self.p
        if self.state is None:
            self.state = w.cache[p]          # adopt: no copy
        else:
            r = self.resident
            tr = self.core.tracer
            args = {}
            if tr.enabled:
                size = sum(x.numel() * x.element_size()
                           for x in leaves(self.state))
                args = dict(bytes_out=size if r is not None else 0,
                            bytes_in=size)
            with tr.enqueue_span("ring.swap", **args), \
                    tr.device_range("ring.swap", device=self.dev, **args):
                if r is not None:
                    if r.cache[p] is self.state:     # the adopted wave
                        r.cache[p] = tree_map(torch.clone, self.state)
                    else:
                        tree_map(lambda d, s: d.copy_(s), r.cache[p],
                                 self.state)
                tree_map(lambda d, s: d.copy_(s), self.state, w.cache[p])
            if p == 0:                       # one swap a wave, not a graph
                self.core.stats.decode_swaps += 1
        self.resident = w

    def release(self, w) -> None:
        """``w`` retired: nothing of it needs copying out any more."""
        if self.resident is w:
            self.resident = None


class DecodeGraph(_StepGraph):
    """The decode step of one ``EngineCore``'s position ``p`` at batch
    bucket ``Bb``."""

    def __init__(self, core, p: int, Bb: int, **kw):
        super().__init__(core, p, Bb, **kw)
        n, dev = self.n, self.dev
        self.tok = _i32((n, Bb, 1), dev)
        self.out = torch.zeros_like(self.tok)
        if self.paged:
            self.pos = _i32((n, core.max_len), dev)
            self.t = _i32((n,), dev)
        if core.row_slots is not None:
            self.state = core.row_slots.slab_view(p, Bb)

    def step_group(self, group, **args) -> torch.Tensor:
        """One replay of row group ``group``, resident in the slab, over
        its leading ``Bb`` slots: the group's token plane in, its next
        tokens back into it. Returns the (E/n, Bb, 1) int32 plane in a
        tensor of its own (harvest reads the waves' rows out of it)."""
        tok = group.tok[self.p][:, :self.Bb]
        with self._range("decode.replay", **args):
            self.tok.copy_(tok)
            self._run()
            tok.copy_(self.out)
            return self.out.clone()

    # -- the step --------------------------------------------------------
    def step(self, w) -> torch.Tensor:
        """Advance the position's slice of wave ``w`` one decode step.
        Returns its new (E/n, Bb, 1) int32 token plane in a tensor of its
        own: the static output is overwritten by the next replay, and
        planes wait on the device until harvest."""
        p = self.p
        if not self.paged:
            self._make_resident(w)
        with self._range("decode.replay", w):
            if self.paged:
                self.table.copy_(w.table[p])
                self.pos.copy_(w.pos[p])
                self.t.copy_(w.t[p])
            self.tok.copy_(w.tok[p])
            self._run()
            if self.paged:
                w.pos[p].copy_(self.pos)
                w.t[p].copy_(self.t)
            return self.out.clone()

    def _body(self) -> None:
        core = self.core
        if self.paged:
            logits = core._paged_decode(self.p, self.table, self.pos,
                                        self.t, self.tok)
        else:
            logits = core._decode(self.p, self.state, self.tok)
        self.out.copy_(core._sample(logits))


class VerifyGraph(_StepGraph):
    """The speculative verify step of one ``EngineCore``'s position ``p``
    at batch bucket ``Bb``, with ``k`` drafts a row (fixed per
    engine)."""

    def __init__(self, core, p: int, Bb: int, k: int, **kw):
        super().__init__(core, p, Bb, **kw)
        n, dev = self.n, self.dev
        self.k = k
        self.tok = _i32((n, Bb), dev)
        self.cap = _i32((n, Bb), dev)
        self.pos = _i32((n, Bb, core.max_len), dev)
        self.t = _i32((n, Bb), dev)
        # greedy window (k + 1), advance, accepted drafts, next token
        self.out = _i32((n, Bb, k + 4), dev)

    def step(self, w) -> torch.Tensor:
        """One verify of the position's slice of spec wave ``w``: its
        ``row_pos``/``row_t`` advance in place. Returns the (E/n, Bb, k +
        4) int32 plane [greedy window | adv | acc | next token] in a
        tensor of its own (the core takes the next feed token from
        it)."""
        p = self.p
        if not self.paged:
            self._make_resident(w)
        with self._range("verify.replay", w):
            if self.paged:
                self.table.copy_(w.table[p])
            self.pos.copy_(w.row_pos[p])
            self.t.copy_(w.row_t[p])
            self.cap.copy_(w.cap[p])
            self.tok.copy_(w.tok[p][..., 0])
            self._run()
            w.row_pos[p].copy_(self.pos)
            w.row_t[p].copy_(self.t)
            return self.out.clone()

    def _body(self) -> None:
        self.out.copy_(self.core._verify(
            self.p, self.state, self.table if self.paged else None,
            self.pos, self.t, self.tok, self.cap, self.k))


# ---------------------------------------------------------------------------
# Row slots of a constant-state ring core
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Columns:
    """A wave's tokens of one row-slot step: ``planes`` the step's replay
    outputs (each a position's (E/n, Bb, 1) int32 plane; the waves of the
    step share them) and ``at`` its decoding rows, (local expert, row) ->
    (index into ``planes``, slot)."""
    planes: List[List[torch.Tensor]]
    at: Dict[Tuple[int, int], Tuple[int, int]]


class _Group:
    """``Bmax`` row slots of every member: the rows one replay steps.
    ``occ[e][s]`` is the (wave, row) in member ``e``'s slot ``s`` (None
    where free); ``tok`` each position's (E/n, Bmax, 1) int32 plane of
    every slot's last token; ``store`` each position's state tree, which
    holds the group's rows while another group holds the slab (None until
    the group first leaves it)."""

    def __init__(self, n_experts: int, Bmax: int, tok: List[torch.Tensor]):
        self.occ: List[List[Any]] = [[None] * Bmax for _ in range(n_experts)]
        self.tok = tok
        self.store: Optional[List[Any]] = None

    def count(self, e: Optional[int] = None) -> int:
        """Occupied slots of member ``e`` (of every member: None)."""
        occ = self.occ if e is None else [self.occ[e]]
        return sum(o is not None for row in occ for o in row)

    def top(self) -> int:
        """One past the highest occupied slot of any member."""
        return max((s + 1 for row in self.occ
                    for s, o in enumerate(row) if o is not None), default=0)

    def free(self, e: int, below: int) -> Optional[int]:
        """Member ``e``'s lowest free slot below ``below`` (None: none)."""
        return next((s for s in range(below) if self.occ[e][s] is None),
                    None)


def _runs(pairs: List[Tuple[int, int]]) -> List[Tuple[int, int, int]]:
    """(row, slot) pairs -> (first row, first slot, length) runs in which
    rows and slots both count up by one: one copy a run."""
    out: List[List[int]] = []
    for i, s in sorted(pairs):
        if out and out[-1][0] + out[-1][2] == i \
                and out[-1][1] + out[-1][2] == s:
            out[-1][2] += 1
        else:
            out.append([i, s, 1])
    return [tuple(r) for r in out]


class RowSlots:
    """The decode state of a ring core whose model keeps a constant-size
    state: rows of any wave in slots of row groups, one slab a position
    that every decode graph's static state is a leading view of (module
    docstring). Copies (installs, packing moves, group swaps) are
    enqueued outside any capture, each batch timed by a ``ring.swap``
    range."""

    def __init__(self, core):
        self.core = core
        self.Bmax = core.batch_buckets[-1]
        one, two = (core.model.cache_shapes(b, 1) for b in (1, 2))
        # each leaf's batch axis in the stacked (E/n, ...) trees; -1 for a
        # leaf without one (a counter that the decode does not read, as
        # RWKV6's ``t``: a group's rows share it)
        self.axes = tree_map(
            lambda a, b: next((k + 1 for k, (x, y) in
                               enumerate(zip(a.shape, b.shape)) if x != y),
                              -1), one, two)
        self.slab: Optional[List[Any]] = None    # a position's tree each
        self.groups: List[_Group] = []           # the slab's group first
        self.resident: Optional[_Group] = None   # the group the slab holds

    # -- storage ---------------------------------------------------------
    def _zeros(self, dev) -> Any:
        shapes = self.core.model.cache_shapes(self.Bmax, 1)
        return tree_map(lambda x: torch.zeros(
            (self.core.per_pos,) + tuple(x.shape), dtype=x.dtype,
            device=dev), shapes)

    def slab_view(self, p: int, Bb: int) -> Any:
        """Position ``p``'s slab over its leading ``Bb`` slots: the
        static state of the decode graph at bucket ``Bb``."""
        return tree_map(lambda x, ax: x if ax < 0 else x.narrow(ax, 0, Bb),
                        self.slab[p], self.axes)

    def _home(self, g: _Group, p: int) -> Any:
        """Where group ``g``'s rows live on position ``p``."""
        if g is self.resident:
            return self.slab[p]
        if g.store is None:
            g.store = [self._zeros(dev) for dev in self.core.devices]
        return g.store[p]

    def _copy(self, dst, src, d0: int, s0: int, k: int,
              m: Optional[int] = None) -> None:
        """Rows ``s0:s0+k`` of state tree ``src`` into rows ``d0:d0+k`` of
        ``dst``: of member ``m``, or of every member (None)."""
        for d, s, ax in zip(leaves(dst), leaves(src), leaves(self.axes)):
            if ax >= 0 and m is not None:
                d, s, ax = d[m], s[m], ax - 1
            if ax >= 0:
                d.narrow(ax, d0, k).copy_(s.narrow(ax, s0, k))

    def _row_bytes(self) -> int:
        return sum(x.numel() * x.element_size() // (self.Bmax
                                                    * self.core.per_pos)
                   for x, ax in zip(leaves(self.slab[0]), leaves(self.axes))
                   if ax >= 0)

    def _copies(self, **args):
        """The host span and device range of one batch of row copies."""
        tr = self.core.tracer
        if not tr.enabled:
            return NULL_RANGE, NULL_RANGE
        return (tr.enqueue_span("ring.swap", **args),
                tr.device_range("ring.swap", device=self.core.devices[0],
                                **args))

    def _new_group(self) -> _Group:
        core = self.core
        g = _Group(core.n_experts, self.Bmax,
                   [_i32((core.per_pos, self.Bmax, 1), dev)
                    for dev in core.devices])
        if self.resident is None:
            self.resident = g
        self.groups.append(g)
        return g

    # -- rows in and out -------------------------------------------------
    def install(self, w, caches: List[Any], tok: List[torch.Tensor]
                ) -> None:
        """Copy each row of wave ``w`` that decodes (``max_new`` > 1) out
        of its prefill ``caches`` and first-token plane ``tok`` (a
        position's each) into the lowest free slot, the slab's group
        first; ``w.slots`` keeps where each went."""
        core = self.core
        if self.slab is None:
            self.slab = [self._zeros(dev) for dev in core.devices]
        runs: Dict[Tuple[int, _Group], List[Tuple[int, int]]] = {}
        for e, ms in w.per_row_new.items():
            for i, m in enumerate(ms):
                if m < 2:
                    continue
                g = next((g for g in self.groups
                          if g.free(e, self.Bmax) is not None), None) \
                    or self._new_group()
                s = g.free(e, self.Bmax)
                g.occ[e][s] = (w, i)
                w.slots[(e, i)] = (g, s)
                runs.setdefault((e, g), []).append((i, s))
        n = sum(map(len, runs.values()))
        if not n:
            return
        span, rng = self._copies(rows_installed=n,
                                 bytes_in=n * self._row_bytes())
        with span, rng:
            for (e, g), pairs in runs.items():
                p, m = divmod(e, core.per_pos)
                for i0, s0, k in _runs(pairs):
                    self._copy(self._home(g, p), caches[p], s0, i0, k, m)
                    g.tok[p][m, s0:s0 + k].copy_(tok[p][m, i0:i0 + k])
        core.stats.rows_installed += n

    def pack(self) -> None:
        """Before a step: move rows so that ``ceil(live rows of the
        fullest member / Bmax)`` groups hold them all (the fullest kept,
        the slab's group first among equals: the fewest moves), each in
        its leading slots up to the bucket its fullest member needs;
        groups left empty go, the slab's too (the next swap then copies
        nothing out)."""
        core = self.core
        E, B = core.n_experts, self.Bmax
        need = max(-(-sum(g.count(e) for g in self.groups) // B)
                   for e in range(E)) if self.groups else 0
        keep = sorted(self.groups, key=lambda g: (-g.count(),
                                                  g is not self.resident)
                      )[:need]
        moves = []                           # (e, from, slot, to, slot)

        def move(e, g, s, h, d):
            w, i = g.occ[e][s]
            g.occ[e][s], h.occ[e][d] = None, (w, i)
            w.slots[(e, i)] = (h, d)
            moves.append((e, g, s, h, d))

        for g in self.groups:
            if g in keep:
                continue
            for e in range(E):
                for s in range(B):
                    if g.occ[e][s] is not None:
                        h = next(h for h in keep if h.free(e, B) is not None)
                        move(e, g, s, h, h.free(e, B))
        for g in keep:
            top = next(b for b in core.batch_buckets
                       if b >= max(g.count(e) for e in range(E)))
            for e in range(E):
                for s in range(top, B):
                    if g.occ[e][s] is not None:
                        move(e, g, s, g, g.free(e, top))
        if moves:
            span, rng = self._copies(rows_moved=len(moves),
                                     bytes_in=len(moves) * self._row_bytes())
            with span, rng:
                for e, g, s, h, d in moves:
                    p, m = divmod(e, core.per_pos)
                    self._copy(self._home(h, p), self._home(g, p), d, s, 1, m)
                    h.tok[p][m, d].copy_(g.tok[p][m, s])
        if self.resident not in keep:
            self.resident = None
        self.groups = sorted(keep, key=lambda g: g is not self.resident)

    def _swap_in(self, g: _Group) -> None:
        """Make ``g`` the slab's group: the resident's occupied leading
        slots copied out to its store, ``g``'s copied in."""
        core = self.core
        r, self.resident = self.resident, None
        hi_out, hi_in = (r.top() if r is not None else 0), g.top()
        args = {}
        if core.tracer.enabled:
            rb = self._row_bytes()
            args = dict(bytes_out=hi_out * rb, bytes_in=hi_in * rb)
        span, rng = self._copies(**args)
        with span, rng:
            for p in range(len(core.devices)):
                if hi_out:
                    self._copy(self._home(r, p), self.slab[p], 0, 0, hi_out)
                self._copy(self.slab[p], self._home(g, p), 0, 0, hi_in)
        self.resident = g
        core.stats.decode_swaps += 1

    def step(self, waves: List[Any], graphs) -> List[Columns]:
        """One decode step of ``waves``, whose decoding rows are all in
        slots: pack, then replay every group with rows once (the slab's
        first; ``graphs(Bb)`` gives a bucket's graphs, one a position),
        then free the slots of rows that have their last token. Returns
        each wave's ``Columns`` of the step."""
        core = self.core
        self.pack()
        order = self.groups
        planes: List[List[torch.Tensor]] = []
        for g in order:
            if g is not self.resident:
                self._swap_in(g)
            Bb = next(b for b in core.batch_buckets if b >= g.top())
            args = {}
            if core.tracer.enabled:
                args = dict(waves=sorted({o[0].wave_id for row in g.occ
                                          for o in row if o is not None}),
                            rows=g.count())
            planes.append([gr.step_group(g, **args) for gr in graphs(Bb)])
            core.stats.decode_replays += 1
        index = {g: k for k, g in enumerate(order)}
        out = []
        for w in waves:
            out.append(Columns(planes, {r: (index[g], s)
                                        for r, (g, s) in w.slots.items()}))
            for (e, i), (g, s) in list(w.slots.items()):
                if w.per_row_new[e][i] - 2 == w.ticks:   # its last token
                    g.occ[e][s] = None
                    del w.slots[(e, i)]
        # the last group replayed holds the slab: it goes first next step
        self.groups = order[-1:] + order[:-1]
        return out
