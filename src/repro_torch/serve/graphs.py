"""One decode step per (engine, decode batch bucket), captured once as a
CUDA graph and replayed for every later step of every wave at that
bucket: the counterpart of the reference's ``EngineCore._decode_fn(Bb)``
(``jax.jit(jax.vmap(model.decode), donate_argnums=(1,))``, one
executable per batch bucket, the cache donated and so written in place).

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
execute), and every later step is copy in, ``replay()``, copy out. The
graphs of one engine share one memory pool and replay one after another
on the current stream. A capture or replay that fails raises: there is
no silent eager fallback. ``capture=False`` (the engine's
``capture_decode``) and the CPU run the same body eagerly on the same
static buffers, so the residency and copy-out logic is the same on
every device.

The kernel wrappers count Python calls. A capture calls them without
launching anything, a replay launches without calling them: the graph
records each wrapper's count during capture, takes it back, and adds it
on every replay (``kernels.ops.add_launches``), so the counters still
say how many kernels ran.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

from ..kernels import ops


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of equal structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


class DecodeGraph:
    """The decode step of one ``EngineCore`` at batch bucket ``Bb``."""

    def __init__(self, core, Bb: int, *, capture: bool,
                 pool: Any = None,
                 stream: Optional["torch.cuda.Stream"] = None):
        E, dev = core.n_experts, core.device
        self.core, self.Bb = core, Bb
        self.paged = core.kv_layout == "paged"
        self.tok = torch.zeros((E, Bb, 1), dtype=torch.int32, device=dev)
        self.out = torch.zeros_like(self.tok)
        if self.paged:
            self.table = torch.zeros((E, Bb, core.n_logical),
                                     dtype=torch.int32, device=dev)
            self.pos = torch.zeros((E, core.max_len), dtype=torch.int32,
                                   device=dev)
            self.t = torch.zeros((E,), dtype=torch.int32, device=dev)
        self.state: Optional[Dict[str, Any]] = None   # ring: static cache
        self.resident = None                 # ring: the wave it belongs to
        self.capture = capture               # CUDA only (the core decides)
        self._pool, self._stream = pool, stream
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.steps = 0
        self.capture_ms = 0.0                # host clock, capture only
        self.launches: Dict[str, int] = {}   # wrapper launches a replay

    # -- the step --------------------------------------------------------
    def step(self, w) -> torch.Tensor:
        """Advance wave ``w`` one decode step. Returns its new (E, Bb, 1)
        int32 token plane in a tensor of its own: the static output is
        overwritten by the next replay, and planes wait on the device
        until harvest."""
        if self.paged:
            self.table.copy_(w.table)
            self.pos.copy_(w.pos)
            self.t.copy_(w.t)
        else:
            self._make_resident(w)
        self.tok.copy_(w.tok)
        self._run()
        if self.paged:
            w.pos.copy_(self.pos)
            w.t.copy_(self.t)
        return self.out.clone()

    def _body(self) -> None:
        core = self.core
        if self.paged:
            logits = core._paged_decode(self.table, self.pos, self.t,
                                        self.tok)
        else:
            logits = core._decode(self.state, self.tok)
        self.out.copy_(core._sample(logits))

    def _run(self) -> None:
        if not self.capture:
            self._body()
        elif self.steps == 0:
            cur = torch.cuda.current_stream()
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
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            self._body()
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
        if self.state is None:
            self.state = w.cache             # adopt: no copy
        else:
            r = self.resident
            if r is not None:
                if r.cache is self.state:    # the adopted wave
                    r.cache = tree_map(torch.clone, self.state)
                else:
                    tree_map(lambda d, s: d.copy_(s), r.cache, self.state)
            tree_map(lambda d, s: d.copy_(s), self.state, w.cache)
            self.core.stats.decode_swaps += 1
        self.resident = w

    def release(self, w) -> None:
        """``w`` retired: nothing of it needs copying out any more."""
        if self.resident is w:
            self.resident = None
