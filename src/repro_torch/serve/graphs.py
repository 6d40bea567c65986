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

import gc
import time
from typing import Any, Dict, Optional

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

    def _range(self, name: str, w):
        """The device range of one step of wave ``w``: its engine,
        position, bucket, real rows, rows still short of their
        ``max_new``, live cache slots after the step and the wave's step
        index ``j``; ``eager`` / ``captured`` where the step runs
        eagerly before its capture, or captures. The null range when the
        tracer is off."""
        core = self.core
        tr = core.tracer
        if not tr.enabled:
            return NULL_RANGE
        j = w.ticks
        news = [m for ms in w.per_row_new.values() for m in ms]
        live = sum(not d for ds in w.done.values() for d in ds) if w.spec \
            else sum(m > j + 1 for m in news)
        args = dict(engine=core.trace_engine, position=self.p,
                    wave=w.wave_id, Bb=self.Bb, rows=len(news),
                    live_rows=live, slots=min(w.Sb + j + 1, core.max_len),
                    j=j)
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
