"""EngineCore: the residency / bucketing / harvest machinery behind every
expert engine, plus the dispatch executors.

  * ``EngineCore`` serves E >= 1 experts (``E = 1`` behind
    ``ExpertEngine``); wave arrays keep a leading ``E`` axis, as in the
    reference. Admissions snap to (batch bucket, length bucket) shapes.
  * two KV layouts: ``ring`` gives each wave a cache of its own, in
    whatever tree the model's ``prefill`` returns (a dense family's K/V
    ring, a recurrent family's state); ``paged``
    keeps one page pool per engine ``(E, P1, L, page, KV, dh)`` that
    waves address through per-row page tables, with prefix sharing
    (in-wave dedup and a cross-wave prefix cache), copy-on-write before
    decode wraps into shared prompt pages, ``PagePoolExhausted``
    backpressure, and chunked prefill of long prompts (``chunk_len``).
    The pool is written in place on one CUDA stream — prefill scatters,
    decode appends and COW copies in issue order — and a wave's pages
    return to the allocator only in ``harvest``, after its last token
    plane reached the host, so no kernel in flight can read a page that
    a new wave was handed.
  * a tick **enqueues** device work and keeps the sampled token on the
    device: ``wave.tok`` stays a tensor and emitted columns accumulate as
    device tensors. Nothing blocks until ``harvest()``, which copies all
    planes a completable row needs to the host in **one** device-to-host
    copy per wave per step.
  * the decode step of each batch bucket is one ``DecodeGraph``
    (``serve/graphs.py``): on CUDA a captured graph, replayed for every
    wave at that bucket, as the reference compiles one executable per
    decode bucket; eager on the CPU or with ``capture_decode=False``.
    Prefill stays eager. A ring core whose model keeps a constant-size
    decode state (``cache_capacity`` 1: RWKV6) steps rows, not waves:
    each row decodes in a slot of a row group (``graphs.RowSlots``) and
    one replay steps a group's rows of every wave.
  * speculative decoding (``speculate_k`` > 0, dense families): a draft
    (``serve/draft.py``) proposes k tokens a row, the target scores the
    (Bb, k+1) window in one pass (``model.verify``), the matched greedy
    prefix is accepted and the rejected suffix rolled back. Spec waves
    carry per-row positions; each verify is one ``VerifyGraph`` step per
    (engine, batch bucket, k). A wave that could wrap its ring (or, paged,
    a chunked one) falls back to plain decode.
  * every such host-blocking copy increments ``EngineStats.host_blocks``.
  * with a 1-D ``expert`` mesh (``launch.mesh.ExpertMesh``, size n
    dividing E) the bank is split as the reference's
    ``leading_sharding`` splits it: member ``e`` lives on position ``e //
    (E // n)`` with its params, its cache or pool slice, its token planes
    and its draft state. Every E-leading tensor is kept as one tensor a
    position (a list of n; one without a mesh), each step of a bucket is
    one graph a position, and a harvest copies every position's planes
    into one pinned host buffer and waits once: one host block a wave,
    however many devices it spans.

The dispatch executors decide *when* the host blocks:

  * ``SerialExecutor`` — the reference: each admit/tick materialises its
    token immediately.
  * ``OverlappedExecutor`` — issues every shard's prefill and decode tick
    before blocking on anything, then runs one batched harvest.

Both orders run the same computation and give identical tokens; only
``host_blocks`` differs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import on_device, resolve_device
from ..obs.trace import NULL_RANGE, NULL_TRACER
from ..sharding import leading_sharding
from ..tree import leaves, tree_map
from .draft import DraftModel, build_draft
from .graphs import Columns, DecodeGraph, RowSlots, VerifyGraph
from .kvcache import PagePool, PagePoolExhausted, PrefixCache, hash_chain


# ---------------------------------------------------------------------------
# Shape buckets
# ---------------------------------------------------------------------------


def make_buckets(lo: int, hi: int) -> Tuple[int, ...]:
    """Power-of-two ladder covering [lo, hi] (hi always included)."""
    lo, hi = int(lo), int(hi)
    if lo < 1:
        raise ValueError(f"make_buckets: lo must be >= 1, got {lo}")
    if lo > hi:
        raise ValueError(f"make_buckets: lo {lo} > hi {hi}")
    out = []
    b = lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(out)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n, clamped to the largest bucket."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


# ---------------------------------------------------------------------------
# Stats
# ---------------------------------------------------------------------------


class EngineStats:
    """Serving counters for one ``EngineCore``.

    ``decode_compiles`` counts the engine's ``DecodeGraph`` objects, one
    per (mesh position, decode batch bucket) run so far (one position
    without a mesh; ``decode_graphs`` gives them by bucket): on CUDA each
    holds one captured
    graph (``decode_captured`` of them are captured so far; their
    capture took ``decode_capture_ms`` of host time), as each of the
    reference's holds one executable. Prefill runs eagerly and compiles
    nothing per shape, so ``prefill_compiles`` / ``suffix_compiles``
    count the distinct shape keys run — ``(Bb, Sb)`` for prefill, ``(Bb,
    chunk index)`` for suffix prefill — the quantity the reference's
    executable counts bound. ``decode_swaps`` counts ring waves' states
    copied into a bucket's static buffers (the resident wave's copied
    out first, where it still runs), decode and verify steps alike, or a
    row group's into the slab.
    ``verify_compiles`` / ``verify_captured`` / ``verify_capture_ms`` are
    the same for the ``VerifyGraph`` objects of a speculative engine, one
    per (position, batch bucket, k). Speculation: ``verify_steps``
    counts verifies (each also a decode step), ``tokens_drafted`` k per
    verified active row, ``tokens_accepted`` the matched drafts,
    ``spec_fallback_waves`` waves that wanted to speculate but failed
    the no-wrap / chunk gate.
    ``decode_replays`` counts the step graphs' replays (decode and
    verify alike): one a decode step, except in a core whose rows share
    replays (``RowSlots``), where a step of many waves replays once a
    row group; ``rows_installed`` counts rows copied into such slots.
    ``host_blocks`` counts host-blocking device-to-host copies. Prefill
    accounting: ``prefill_tokens_submitted`` counts every prompt token
    clients sent, ``prefill_tokens_computed`` the tokens that went
    through a prefill dispatch (deduplicated and fully cached rows add
    none).
    """

    def __init__(self, core: Optional["EngineCore"] = None):
        self._core = core
        self.prefill_calls = 0
        self.decode_steps = 0
        self.rows_served = 0
        self.rows_padded = 0
        self.tokens_generated = 0
        self.host_blocks = 0
        self.prefill_tokens_submitted = 0
        self.prefill_tokens_computed = 0
        self.prefill_rows_computed = 0
        self.prefix_full_hits = 0       # rows skipped via cross-wave cache
        self.prefix_dup_rows = 0        # rows deduplicated inside a wave
        self.prefix_pages_shared = 0    # page refs shared instead of built
        self.pages_copied = 0           # copy-on-write page copies
        self.decode_swaps = 0           # ring residency swaps
        self.decode_replays = 0         # step graph replays
        self.rows_installed = 0         # rows copied into row slots
        self.verify_steps = 0
        self.tokens_drafted = 0
        self.tokens_accepted = 0
        self.spec_fallback_waves = 0

    @property
    def prefill_compiles(self) -> int:
        return len(self._core._prefill_shapes) if self._core else 0

    @property
    def suffix_compiles(self) -> int:
        return len(self._core._suffix_shapes) if self._core else 0

    @property
    def decode_compiles(self) -> int:
        return sum(map(len, self._core._graphs.values())) if self._core \
            else 0

    @property
    def decode_graphs(self) -> Dict[int, int]:
        """Decode batch bucket -> its step graphs (one a mesh position),
        for the buckets run so far, ascending: the ladder's shape."""
        return {b: len(gs) for b, gs in sorted(self._core._graphs.items())} \
            if self._core else {}

    def _step_graphs(self, kind: str) -> List[Any]:
        return [g for k, _, g in self._core.step_graphs() if k == kind] \
            if self._core else []

    @property
    def decode_captured(self) -> int:
        return sum(g.graph is not None for g in self._step_graphs("decode"))

    @property
    def decode_capture_ms(self) -> float:
        return sum((g.capture_ms for g in self._step_graphs("decode")), 0.0)

    @property
    def verify_compiles(self) -> int:
        return sum(map(len, self._core._verify_graphs.values())) \
            if self._core else 0

    @property
    def verify_captured(self) -> int:
        return sum(g.graph is not None for g in self._step_graphs("verify"))

    @property
    def verify_capture_ms(self) -> float:
        return sum((g.capture_ms for g in self._step_graphs("verify")), 0.0)

    @property
    def acceptance_rate(self) -> float:
        if not self.tokens_drafted:
            return 0.0
        return self.tokens_accepted / self.tokens_drafted

    @property
    def jit_cache_entries(self) -> int:
        return (self.prefill_compiles + self.suffix_compiles
                + self.decode_compiles + self.verify_compiles)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "prefill_calls": self.prefill_calls,
            "decode_steps": self.decode_steps,
            "rows_served": self.rows_served,
            "rows_padded": self.rows_padded,
            "tokens_generated": self.tokens_generated,
            "host_blocks": self.host_blocks,
            "prefill_tokens_submitted": self.prefill_tokens_submitted,
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "prefill_rows_computed": self.prefill_rows_computed,
            "prefix_full_hits": self.prefix_full_hits,
            "prefix_dup_rows": self.prefix_dup_rows,
            "prefix_pages_shared": self.prefix_pages_shared,
            "pages_copied": self.pages_copied,
            "decode_swaps": self.decode_swaps,
            "decode_replays": self.decode_replays,
            "rows_installed": self.rows_installed,
            "verify_steps": self.verify_steps,
            "tokens_drafted": self.tokens_drafted,
            "tokens_accepted": self.tokens_accepted,
            "acceptance_rate": self.acceptance_rate,
            "spec_fallback_waves": self.spec_fallback_waves,
            "prefill_compiles": self.prefill_compiles,
            "suffix_compiles": self.suffix_compiles,
            "decode_compiles": self.decode_compiles,
            "decode_captured": self.decode_captured,
            "decode_capture_ms": self.decode_capture_ms,
            "verify_compiles": self.verify_compiles,
            "verify_captured": self.verify_captured,
            "verify_capture_ms": self.verify_capture_ms,
            "jit_cache_entries": self.jit_cache_entries,
        }

    def __repr__(self) -> str:
        return (f"EngineStats(prefill_compiles={self.prefill_compiles}, "
                f"decode_compiles={self.decode_compiles}, "
                f"prefill_calls={self.prefill_calls}, "
                f"decode_steps={self.decode_steps}, "
                f"rows_served={self.rows_served}, "
                f"rows_padded={self.rows_padded}, "
                f"tokens_generated={self.tokens_generated}, "
                f"host_blocks={self.host_blocks}, "
                f"prefill_tokens={self.prefill_tokens_computed}/"
                f"{self.prefill_tokens_submitted}, "
                f"prefix_hits={self.prefix_full_hits}+"
                f"{self.prefix_dup_rows}dup)")


# ---------------------------------------------------------------------------
# Core
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Wave:
    """One admitted (E, Bb) micro-batch wave resident in the core.

    Every device tensor of a wave is split over the core's mesh
    positions: a list holding one (E / n, ...) tensor a position, on
    that position's device (one (E, ...) tensor without a mesh).

    ``emitted`` holds one (E, Bb) token plane per generated step; planes
    start life as such lists of device tensors and are swapped for host
    (E, Bb) arrays by ``_materialize`` — ``n_host`` is the
    already-materialised prefix.

    Ring waves own a dense ``cache``; paged waves instead carry a page
    ``table`` into the core's shared pool plus the wave's ``pos``/``t``
    (lockstep rows share positions, only physical storage is per row),
    the pages each row releases at retirement, and the prefix chains to
    register in the cross-wave cache.
    """
    uids: Dict[int, List[Any]]          # local expert -> row uids
    per_row_new: Dict[int, List[int]]
    done: Dict[int, List[bool]]
    cache: Any                          # ring: a position's cache tree
    #   each, the model's tree with every leaf stacked on a leading axis
    #   of the position's members (dense: {k, v (E/n, L, Bb, C, KV, dh),
    #   pos (E/n, C), t (E/n,)}); stale while the wave is resident in its
    #   bucket's DecodeGraphs, whose static state is then its own; None
    #   once its rows are in row slots
    tok: Optional[List[torch.Tensor]]   # (E, Bb, 1) last sampled token;
    #   None while prefill chunks are still pending (decode is gated)
    emitted: List[Any]                  # (E, Bb) planes, device or host
    steps_left: int
    n_host: int = 0                     # emitted[:n_host] are host arrays
    # paged-layout fields (None / empty on ring waves)
    table: Optional[List[torch.Tensor]] = None   # (E, Bb, n_logical) int32
    pos: Optional[List[torch.Tensor]] = None     # (E, C) slot positions
    t: Optional[List[torch.Tensor]] = None       # (E,) next write position
    pages_held: Dict[int, List[List[int]]] = \
        dataclasses.field(default_factory=dict)
    register: List[Tuple[int, int, int, List[bytes], List[int]]] = \
        dataclasses.field(default_factory=list)
    #   ^ (local, row, padded_len, chain, pages) to insert at retirement
    # chunked-prefill fields (empty / None on unchunked waves): each
    # pending descriptor is one not-yet-dispatched prefill chunk,
    # dispatched FIFO; the wave's first token (and decode eligibility)
    # materialises only when the last chunk lands (_finalize_wave)
    pending_chunks: List[Dict[str, Any]] = \
        dataclasses.field(default_factory=list)
    finalize: Optional[Dict[str, Any]] = None
    _tok_c: Optional[List[torch.Tensor]] = None  # last chunk's logits
    # speculative-decoding fields (inert on plain waves). Spec waves
    # advance rows at different rates, so they carry per-row ``row_pos``
    # / ``row_t`` instead of the shared pos/t (a ring spec wave's
    # ``cache`` is {k, v} alone); ``cap`` freezes a row once it has
    # written every token it must emit; each verify appends one (E, Bb,
    # k + 4) plane [greedy window | adv | acc | next token] to
    # ``spec_pending``, drained by ``_materialize_spec`` into the host
    # per-row token buffer ``host_buf`` (column 0 is the prefill token)
    spec: bool = False
    row_pos: Optional[List[torch.Tensor]] = None  # (E, Bb, C) per-row slots
    row_t: Optional[List[torch.Tensor]] = None    # (E, Bb) per-row write pos
    cap: Optional[List[torch.Tensor]] = None      # (E, Bb) freeze position
    spec_pending: List[List[torch.Tensor]] = \
        dataclasses.field(default_factory=list)
    host_buf: Optional[np.ndarray] = None    # (E, Bb, 1 + steps) int32
    host_fill: Optional[np.ndarray] = None   # (E, Bb) tokens in host_buf
    spec_seeded: bool = False                # host_buf column 0 written
    # tracing (inert under NULL_TRACER): the prefill span begun at
    # enqueue, ended only inside _materialize / _materialize_spec, so
    # tracing never adds a host block; the device range that made the
    # first tokens; the padded prompt length and the decode steps taken
    # (a step's live slots and index in its ``decode.replay`` range)
    wave_id: int = 0
    sp_prefill: Any = None
    first_range: Any = None
    Sb: int = 0
    ticks: int = 0
    # row slots (a core with ``RowSlots``): (local expert, row) -> (group,
    # slot) of each row still decoding
    slots: Dict[Tuple[int, int], Any] = \
        dataclasses.field(default_factory=dict)


def _stack(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stack on a new leading axis; one tensor becomes a view, no copy."""
    return xs[0].unsqueeze(0) if len(xs) == 1 else torch.stack(xs)


def _in_place(given: torch.Tensor, got: torch.Tensor) -> None:
    if got is not given:
        raise RuntimeError(
            "model.decode rebound a cache leaf: the decode step must write "
            "every leaf of the cache it is given in place (a captured step "
            "replays on fixed buffers)")


def bank_positions(n_experts: int, mesh, device=None
                   ) -> Tuple[Any, Tuple[torch.device, ...]]:
    """``(mesh, devices)``: the mesh a bank of ``n_experts`` is split
    over (``None`` when unsharded, as for a mesh of size 1) and the
    device of each of its positions (one without a mesh: ``device``,
    ``cuda`` unless ``"cpu"``). The mesh's ``expert`` axis must divide
    the bank, as the reference requires; a ``device`` given beside a mesh
    must be of its devices' type. A ``cuda`` position without an index
    is the current card."""
    if mesh is None:
        return None, (resolve_device(device),)
    if "expert" not in mesh.shape or n_experts % mesh.shape["expert"]:
        raise ValueError(
            f"mesh expert axis {dict(mesh.shape)} must divide the "
            f"bank's {n_experts} experts")
    devs = tuple(resolve_device(d) for d in mesh.devices)
    devs = tuple(torch.device("cuda", torch.cuda.current_device())
                 if d.type == "cuda" and d.index is None else d
                 for d in devs)
    if device is not None and resolve_device(device).type != devs[0].type:
        raise ValueError(f"device {device} beside a mesh on "
                         f"{[str(d) for d in devs]}")
    return (mesh if len(devs) > 1 else None), devs


def _on(got: torch.device, want: torch.device) -> bool:
    """Whether a tensor on ``got`` lives on ``want`` (a ``cuda`` without
    an index is any card)."""
    return got.type == want.type and (want.index is None
                                      or got.index == want.index)


class EngineCore:
    """E homogeneous experts: bucketed shapes, resident waves, device-side
    token state, batched harvest.

    Admission and decode *enqueue* work; the only host-blocking points are
    ``_materialize`` calls — per tick in sync mode (``defer=False``, the
    serial reference), or one batched copy per wave inside ``harvest()``
    in deferred mode. Runs on ``cuda`` unless ``device="cpu"``; the
    experts' params must already live there. With ``mesh`` (a 1-D
    ``expert`` mesh whose size divides E) member ``e`` runs on position
    ``e // (E // n)``'s device, where its params must already live. On
    CUDA each decode bucket's step (and each verify bucket's) is a
    captured graph a position unless ``capture_decode=False`` (the
    counterpart of ``jax.disable_jit``), which runs the same step
    eagerly; the CPU always runs it eagerly. ``speculate_k`` > 0 drafts
    that many tokens a row with ``draft`` (a ``DraftModel`` or its name,
    default ``"mlp"``), whose state is drawn once for all E members from
    a ``torch.Generator`` seeded 0 on the first position's device, then
    split over the positions.
    """

    def __init__(self, model, params_list: Sequence[Any], *,
                 max_len: int = 256, min_len_bucket: int = 8,
                 batch_buckets: Optional[Sequence[int]] = None,
                 kv_layout: str = "ring", page_size: int = 8,
                 pool_pages: Optional[int] = None,
                 chunk_len: Optional[int] = None,
                 speculate_k: int = 0,
                 draft: "DraftModel | str | None" = None, mesh=None,
                 device=None, capture_decode: bool = True):
        if not params_list:
            raise ValueError("EngineCore needs at least one expert")
        if kv_layout not in ("ring", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}; expected "
                             "'ring' or 'paged'")
        self.model = model
        self.params = list(params_list)
        self.n_experts = len(self.params)
        self.mesh, self.devices = bank_positions(self.n_experts, mesh,
                                                 device)
        self.device = self.devices[0]
        self.per_pos = self.n_experts // len(self.devices)
        where = leading_sharding(self.n_experts, "expert", self.mesh)
        for e, params in enumerate(self.params):
            dev = self.devices[where[e] if where else 0]
            for w in leaves(params):
                if not _on(w.device, dev):
                    raise ValueError(
                        f"expert {e}'s params live on {w.device}, the "
                        f"engine runs it on {dev}")
        self.max_len = max_len
        self.len_buckets = make_buckets(min_len_bucket, max_len)
        self.batch_buckets = tuple(batch_buckets or make_buckets(1, 16))
        self.kv_layout = kv_layout
        self.stats = EngineStats(self)
        self.tracer = NULL_TRACER
        self.trace_engine: Any = None        # the engine's label in ranges
        self._active: List[_Wave] = []
        self._finished: List[Tuple[int, Any, np.ndarray]] = []
        self._prefill_shapes: set = set()    # (Bb, Sb) run so far
        self._suffix_shapes: set = set()     # (Bb, chunk index k >= 1)
        self.capture_decode = bool(capture_decode)
        self._graphs: Dict[int, List[DecodeGraph]] = {}
        #   ^ Bb -> its step, one graph a position
        self._verify_graphs: Dict[Tuple[int, int], List[VerifyGraph]] = {}
        #   ^ (Bb, k) -> its verify step, one graph a position
        self._graph_pools: Dict[torch.device, Tuple[Any, Any]] = {}
        #   ^ CUDA: one (memory pool, capture stream) a device
        # -- paged KV state (None in ring layout) ------------------------
        self.pool: Optional[PagePool] = None
        self.prefix_cache: Optional[PrefixCache] = None
        self.kv_pool = None     # a position's {k, v}: (E/n, P1, L, page, ...)
        if kv_layout == "paged":
            if not model.supports_paged_kv:
                raise ValueError(
                    f"model family {model.cfg.family!r} does not "
                    "implement the paged KV cache protocol; use "
                    "kv_layout='ring'")
            self.page = int(page_size)
            bad = [b for b in (*self.len_buckets, self.max_len)
                   if b % self.page]
            if bad:
                raise ValueError(
                    f"paged layout needs every length bucket to be a "
                    f"multiple of page_size={self.page}; offending "
                    f"buckets {bad} (prefills must fill whole pages so "
                    "prefix-shared pages are never partially written)")
            self.n_logical = self.max_len // self.page
            per_expert = int(pool_pages) if pool_pages else \
                3 * self.batch_buckets[-1] * self.n_logical
            self.pool = PagePool(self.n_experts, per_expert, self.page)
            self.prefix_cache = PrefixCache(self.pool, capacity=1024)
            # one zeroed pool per expert, stacked by position: trash-page
            # reads by padding rows must stay finite
            self.kv_pool = []
            for dev in self.devices:
                pools = [model.init_paged_pool(per_expert, self.page,
                                               device=dev)
                         for _ in range(self.per_pos)]
                self.kv_pool.append({k: _stack([p[k] for p in pools])
                                     for k in ("k", "v")})
        # -- chunked prefill geometry (paged only) -----------------------
        self.chunk_len: Optional[int] = None
        if chunk_len is not None:
            cl = int(chunk_len)
            if kv_layout != "paged":
                raise ValueError("chunk_len requires kv_layout='paged' "
                                 "(suffix prefill attends over pool pages)")
            if cl % self.page:
                raise ValueError(
                    f"chunk_len={cl} must be a multiple of "
                    f"page_size={self.page}")
            if self.max_len % cl:
                raise ValueError(
                    f"max_len={self.max_len} must be a multiple of "
                    f"chunk_len={cl} (the suffix ladder tiles max_len)")
            if cl not in self.len_buckets:
                raise ValueError(
                    f"chunk_len={cl} must itself be a length bucket "
                    f"(got buckets {self.len_buckets}) — chunk 0 reuses "
                    "the monolithic prefill at that bucket")
            bad = [b for b in self.len_buckets if b > cl and b % cl]
            if bad:
                raise ValueError(
                    f"length buckets above chunk_len must be multiples "
                    f"of chunk_len={cl}; offending buckets {bad} (every "
                    "padded prompt must split into whole chunks)")
            self.chunk_len = cl
        # -- speculative decoding ----------------------------------------
        self.speculate_k = int(speculate_k)
        self.draft: Optional[DraftModel] = None
        self.draft_name: Optional[str] = None
        self.draft_state = None
        if self.speculate_k < 0:
            raise ValueError(f"speculate_k must be >= 0, got "
                             f"{self.speculate_k}")
        if self.speculate_k:
            if not model.supports_verify:
                raise ValueError(
                    f"model family {model.cfg.family!r} does not "
                    "implement the speculative verify protocol; use "
                    "speculate_k=0")
            d = draft if draft is not None else "mlp"
            if isinstance(d, str):
                d = build_draft(d, int(model.cfg.padded_vocab))
            self.draft = d
            self.draft_name = d.name
            # engine-level state, updated in place by every verify, so an
            # online draft keeps learning across waves. It is drawn once
            # for the whole bank (a generator a position would draw
            # other values) and each position takes its members' slice
            st = d.init_state(
                torch.Generator(device=self.device).manual_seed(0),
                self.n_experts)
            self.draft_state = [tree_map(lambda a: a[sl].to(dev), st)
                                for sl, dev in self._slices()]
        elif draft is not None:
            raise ValueError("draft requires speculate_k > 0")
        # a model whose decode state has a constant size reads no position
        # in decode: its rows share replays through row slots
        self.row_slots: Optional[RowSlots] = RowSlots(self) \
            if kv_layout == "ring" and not self.speculate_k \
            and model.cache_capacity(max_len) == 1 else None

    def bind_tracer(self, tracer, engine: Any = None) -> None:
        """Install a lifecycle tracer (None restores NULL_TRACER);
        ``engine`` labels this core's device ranges. An enabled tracer
        anchors each CUDA position's clock here (one sync, before any
        traffic)."""
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.trace_engine = engine
        for dev in self.devices:
            self.tracer.anchor(dev)

    def _prefill_range(self, wave: int, **args: Any):
        """The ``prefill.dispatch`` device range of one prefill or chunk
        dispatch (position 0's stream on a mesh)."""
        if not self.tracer.enabled:
            return NULL_RANGE
        return self.tracer.device_range("prefill.dispatch",
                                        device=self.device,
                                        engine=self.trace_engine,
                                        wave=wave, **args)

    def executable_bounds(self) -> Dict[str, int]:
        """Steady-state bound on the distinct shape keys per family (the
        reference's executable-count bound). With chunking, monolithic
        prefill shapes exist only for length buckets <= chunk_len, and
        the suffix ladder adds one per (batch bucket, chunk index >= 1).
        A step graph belongs to one device, so the decode and verify
        ladders hold one graph per (mesh position, batch bucket) where
        the reference's SPMD executable spans the mesh."""
        nB = len(self.batch_buckets)
        if self.chunk_len:
            prefill = nB * sum(1 for b in self.len_buckets
                               if b <= self.chunk_len)
            suffix = nB * (max(self.len_buckets) // self.chunk_len - 1)
        else:
            prefill = nB * len(self.len_buckets)
            suffix = 0
        # the verify ladder is keyed (Bb, k) with k fixed per engine: at
        # most one per batch bucket, none on an engine that never
        # speculates
        steps = nB * len(self.devices)
        return {"prefill": prefill, "suffix": suffix, "decode": steps,
                "verify": steps if self.speculate_k else 0}

    # -- mesh positions --------------------------------------------------
    def _slices(self) -> List[Tuple[slice, torch.device]]:
        """Each position's members (a slice of the E axis) and device."""
        n = self.per_pos
        return [(slice(p * n, (p + 1) * n), dev)
                for p, dev in enumerate(self.devices)]

    def _members(self, p: int) -> range:
        return range(p * self.per_pos, (p + 1) * self.per_pos)

    def _upload(self, a: np.ndarray, dtype=None) -> List[torch.Tensor]:
        """A host (E, ...) array -> each position's (E/n, ...) slice on
        its device."""
        t = torch.from_numpy(a)
        if dtype is not None:
            t = t.to(dtype)
        return [t[sl].to(dev) for sl, dev in self._slices()]

    def _fetch(self, parts: Sequence[torch.Tensor]) -> np.ndarray:
        """Each position's (E/n, ...) tensor -> one host (E, ...) array:
        every copy is issued without blocking into one pinned buffer, then
        the host waits once (the caller counts one host block)."""
        if self.device.type == "cpu":
            # synchronous: the copy is the wait
            with self.tracer.span("engine.fetch"):
                return torch.cat(list(parts)).numpy()
        host = torch.empty((self.n_experts,) + tuple(parts[0].shape[1:]),
                           dtype=parts[0].dtype, pin_memory=True)
        done = []
        for (sl, _), x in zip(self._slices(), parts):
            host[sl].copy_(x, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(x.device))
            done.append(ev)
        with self.tracer.span("engine.fetch"):
            for ev in done:
                ev.synchronize()
        return host.numpy()

    def step_graphs(self) -> List[Tuple[str, Any, Any]]:
        """``(kind, key, graph)`` for every step graph made so far:
        ``("decode", Bb, g)`` and ``("verify", (Bb, k), g)``, each
        bucket's positions in order. The one enumeration of the ladder:
        ``EngineStats``, retirement and the contract checks read it."""
        return [(kind, key, g)
                for kind, ladder in (("decode", self._graphs),
                                     ("verify", self._verify_graphs))
                for key, gs in ladder.items() for g in gs]

    # -- device work -----------------------------------------------------
    def _expert_pool(self, e: int) -> Dict[str, torch.Tensor]:
        """Expert ``e``'s (P1, L, page, KV, dh) pool views."""
        p, i = divmod(e, self.per_pos)
        return {"k": self.kv_pool[p]["k"][i], "v": self.kv_pool[p]["v"][i]}

    def _prefill(self, toks: np.ndarray):
        """(E, Bb, Sb) tokens -> (logits (E, Bb, V), wave cache), each a
        list over the positions."""
        self._prefill_shapes.add(toks.shape[1:])
        logits, caches = [], []
        for p, tok_dev in enumerate(self._upload(toks)):
            lg_p, c_p = [], []
            for i, e in enumerate(self._members(p)):
                lg, c = self.model.prefill(self.params[e],
                                           {"tokens": tok_dev[i]},
                                           capacity=self.max_len)
                lg_p.append(lg)
                c_p.append(c)
            logits.append(_stack(lg_p))
            caches.append(tree_map(lambda *leaves: _stack(leaves), *c_p))
        return logits, caches

    def _paged_prefill(self, toks: np.ndarray, stbl: np.ndarray
                       ) -> List[torch.Tensor]:
        """(E, Bb, Sb) tokens, (E, Bb, Sb // page) scatter table ->
        logits (E, Bb, V); the pages land in the pool in place."""
        self._prefill_shapes.add(toks.shape[1:])
        logits = []
        for p, (tok_dev, stbl_dev) in enumerate(zip(self._upload(toks),
                                                    self._upload(stbl))):
            logits.append(_stack([self.model.paged_prefill(
                self.params[e], {"tokens": tok_dev[i]},
                self._expert_pool(e), stbl_dev[i], page=self.page,
                capacity=self.max_len)[0]
                for i, e in enumerate(self._members(p))]))
        return logits

    def _paged_suffix(self, k: int, toks: np.ndarray, ptbl: np.ndarray,
                      stbl: np.ndarray) -> List[torch.Tensor]:
        """Suffix prefill of chunk ``k >= 1``: exactly ``chunk_len``
        tokens at offset ``k * chunk_len``, attending over the prefix
        pages already in the pool. Shape key (Bb, k), so the ladder is
        bounded by ``(max(len_buckets) // chunk_len - 1) *
        len(batch_buckets)``."""
        self._suffix_shapes.add((toks.shape[1], k))
        logits = []
        for p, (tok_dev, ptbl_dev, stbl_dev) in enumerate(zip(
                self._upload(toks), self._upload(ptbl),
                self._upload(stbl))):
            logits.append(_stack([self.model.paged_prefill_suffix(
                self.params[e], {"tokens": tok_dev[i]},
                self._expert_pool(e), ptbl_dev[i], stbl_dev[i],
                offset=k * self.chunk_len, page=self.page)[0]
                for i, e in enumerate(self._members(p))]))
        return logits

    def _new_graphs(self, cls, *args) -> List[Any]:
        """A step's graphs, one a position: captured on CUDA unless
        ``capture_decode=False``. The graphs on one device share one
        memory pool and one capture stream."""
        out = []
        for p, dev in enumerate(self.devices):
            capture = self.capture_decode and dev.type == "cuda"
            if capture and dev not in self._graph_pools:
                with on_device(dev):
                    self._graph_pools[dev] = (torch.cuda.graph_pool_handle(),
                                              torch.cuda.Stream(dev))
            pool, stream = self._graph_pools.get(dev, (None, None))
            out.append(cls(self, p, *args, capture=capture, pool=pool,
                           stream=stream))
        return out

    def _decode_graphs(self, Bb: int) -> List[DecodeGraph]:
        """Bucket ``Bb``'s ``DecodeGraph``s, made at its first step."""
        gs = self._graphs.get(Bb)
        if gs is None:
            gs = self._graphs[Bb] = self._new_graphs(DecodeGraph, Bb)
        return gs

    def _decode_step(self, w: "_Wave") -> List[torch.Tensor]:
        """One decode step of wave ``w`` through its bucket's
        ``DecodeGraph``s, every position's enqueued before anything
        blocks. Returns the new (E, Bb, 1) int32 token plane, tensors of
        its own."""
        self.stats.decode_replays += 1
        return [g.step(w) for g in self._decode_graphs(w.tok[0].shape[1])]

    def _verify_step(self, w: "_Wave") -> List[torch.Tensor]:
        """One verify of spec wave ``w`` through its (bucket, k)
        ``VerifyGraph``s. Returns the (E, Bb, k + 4) plane of its outputs,
        tensors of its own; ``w.tok``, ``w.row_pos`` and ``w.row_t``
        advance."""
        key = (w.tok[0].shape[1], self.speculate_k)
        gs = self._verify_graphs.get(key)
        if gs is None:
            gs = self._verify_graphs[key] = self._new_graphs(VerifyGraph,
                                                             *key)
        outs = [g.step(w) for g in gs]
        self.stats.decode_replays += 1
        w.tok = [o[..., self.speculate_k + 3:] for o in outs]
        return outs

    def _verify(self, p: int, cache, table, row_pos, row_t, tok, cap,
                k: int) -> torch.Tensor:
        """The body of position ``p``'s verify step, the counterpart of
        the reference's fused ``_verify_fn``: per member, the draft
        proposes ``k`` tokens from each row's last one, the model scores
        the (Bb, k+1) window (``verify`` on the ring cache {k, v} (E/n,
        L, Bb, C, KV, dh), or ``paged_verify`` through ``table`` (E/n, Bb,
        n_logical)), and ``_accept`` takes the matched prefix. ``row_pos``
        (E/n, Bb, C), ``row_t`` (E/n, Bb), the cache or pool and the draft
        state are written in place; ``tok`` and ``cap`` (E/n, Bb) are
        read. Returns the (E/n, Bb, k + 4) int32 plane [greedy window |
        adv | acc | next token]."""
        outs = []
        for i, e in enumerate(self._members(p)):
            st = tree_map(lambda a: a[i], self.draft_state[p])
            window = torch.cat([tok[i][:, None],
                                self.draft.propose(st, tok[i], k)], dim=1)
            if self.kv_layout == "paged":
                greedy, _ = self.model.paged_verify(
                    self.params[e], self._expert_pool(e), table[i],
                    row_pos[i], row_t[i], {"tokens": window},
                    page=self.page)
            else:
                greedy, _ = self.model.verify(
                    self.params[e], {"k": cache["k"][i], "v": cache["v"][i]},
                    row_pos[i], row_t[i], {"tokens": window})
            outs.append(self._accept(window, greedy, row_pos[i], row_t[i],
                                     tok[i], cap[i], st))
        return _stack(outs)

    def _accept(self, window, greedy, row_pos, row_t, tok, cap, dstate
                ) -> torch.Tensor:
        """One expert's accept step. The accepted prefix is the drafts
        matching the greedy chain (a cumulative product); a row advances
        ``adv = min(j + 1, cap - t)`` tokens (>= 1 while active, 0 once
        frozen, where ``acc`` is -1); the slots the window wrote past the
        accepted prefix roll back to pos -1 (the admission gate saw to it
        that they held -1 before, never live context); the next feed
        token is the last accepted greedy one; the draft observes the
        verified transitions. ``row_pos`` / ``row_t`` / ``dstate`` in
        place; returns (Bb, k + 4) int32 [greedy | adv | acc | tok']."""
        K1 = window.shape[1]
        dev = window.device
        match = (window[:, 1:] == greedy[:, :-1]).to(torch.int32)
        j = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
        remaining = (cap - row_t).clamp_min(0)
        adv = torch.minimum(j + 1, remaining)
        active = remaining > 0
        acc = torch.where(active, j, -1)
        ar = torch.arange(K1, dtype=torch.int32, device=dev)[None, :]
        offs = row_t[:, None] + ar
        row_pos.scatter_(1, (offs % row_pos.shape[1]).long(),
                         torch.where(ar < adv[:, None], offs, -1))
        last = greedy.gather(1, (adv - 1).clamp_min(0).long()[:, None])
        tok2 = torch.where(active, last[:, 0], tok)
        self.draft.observe(dstate, window, greedy, adv)
        row_t.add_(adv)
        return torch.cat([greedy, adv[:, None], acc[:, None],
                          tok2[:, None]], dim=1)

    def _decode(self, p: int, cache, tok: torch.Tensor) -> torch.Tensor:
        """The body of position ``p``'s ring decode step over the model's
        own cache tree (nested dicts of (E/n, ...) tensors), which the
        model writes in place: every leaf it returns must be the view it
        was given. It gets a copy of the dict of views, so a key it
        rebinds shows as a new leaf and raises. Returns logits (E/n, Bb,
        V)."""
        logits = []
        for i, e in enumerate(self._members(p)):
            ve = tree_map(lambda a: a[i], cache)
            lg, out = self.model.decode(self.params[e],
                                        tree_map(lambda a: a, ve),
                                        {"token": tok[i]})
            tree_map(_in_place, ve, out)
            logits.append(lg)
        return _stack(logits)

    def _paged_decode(self, p: int, table: torch.Tensor, pos: torch.Tensor,
                      t: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
        """The body of position ``p``'s paged decode step through page
        tables ``table`` (E/n, Bb, n_logical): the pool is written in
        place and ``pos`` (E/n, C) / ``t`` (E/n,) advance in place.
        Returns logits (E/n, Bb, V)."""
        logits = []
        for i, e in enumerate(self._members(p)):
            lg, _, q, te = self.model.paged_decode(
                self.params[e], self._expert_pool(e), table[i], pos[i],
                t[i], {"token": tok[i]}, page=self.page)
            pos[i].copy_(q)
            t[i].copy_(te)
            logits.append(lg)
        return _stack(logits)

    def _copy_pages(self, copies: Mapping[int, Sequence[Tuple[int, int]]]
                    ) -> None:
        """Apply copy-on-write page copies: one indexed copy per pool
        over each position's (member, src, dst) triples, in place (the
        reference pads the copy count to a power of two to bound its
        compiles; the port compiles nothing per shape, so it copies
        exactly what it must). Each copy moves a page for every layer."""
        for p, dev in enumerate(self.devices):
            triples = [(local - p * self.per_pos, s_, d)
                       for local, pairs in copies.items()
                       if local // self.per_pos == p for s_, d in pairs]
            if not triples:
                continue
            es, srcs, dsts = (torch.as_tensor(col, dtype=torch.long,
                                              device=dev)
                              for col in zip(*triples))
            for buf in self.kv_pool[p].values():
                buf[es, dsts] = buf[es, srcs]

    @staticmethod
    def _sample(logits: torch.Tensor) -> torch.Tensor:
        """Greedy token plane (E, Bb, 1) int32, left on the device."""
        return torch.argmax(logits, dim=-1).to(torch.int32)[..., None]

    # -- admission -------------------------------------------------------
    def pad_shape(self, n_rows: int, prompt_len: int) -> Tuple[int, int]:
        """(batch bucket, length bucket) this admission would snap to."""
        return (bucket_for(n_rows, self.batch_buckets),
                bucket_for(prompt_len, self.len_buckets))

    def _make_spec_wave(self, uids, per_row, done, Bb: int, Sb: int,
                        steps: int, *, tok, row_pos, row_t, **fields
                        ) -> _Wave:
        """Assemble a speculative wave: the per-row position planes
        (tensors of the wave's own: verifies advance them in place), the
        per-row freeze position ``cap`` (a row stops once it has written
        its last emitted token; padding rows freeze at once) and the host
        token buffer. ``fields``: the ring cache, or the paged wave's
        table, pages and prefixes to register."""
        E = self.n_experts
        cap = np.full((E, Bb), Sb, np.int32)
        for local, ms in per_row.items():
            for i, m in enumerate(ms):
                cap[local, i] = Sb + m - 1
        return _Wave(uids=uids, per_row_new=per_row, done=done, tok=tok,
                     emitted=[[t[..., 0] for t in tok]], steps_left=steps,
                     spec=True, row_pos=row_pos, row_t=row_t,
                     cap=self._upload(cap),
                     host_buf=np.zeros((E, Bb, steps + 1), np.int32),
                     host_fill=np.zeros((E, Bb), np.int32), **fields)

    def admit_wave(self, groups: Mapping[int, Tuple[Sequence[Any],
                                                    Sequence[np.ndarray],
                                                    Sequence[int]]],
                   *, defer: bool = False) -> bool:
        """Prefill one (E, Bb, Sb) wave: every member expert's micro-batch
        in one admission. Returns False when no group has rows.

        ``groups`` maps local expert index -> (uids, prompts, max_new).
        Prompts are right-truncated to the length bucket (keeping the most
        recent tokens) and zero-padded on the right to it; the batch dim
        is zero-padded to its bucket. The first token of each row is the
        argmax at the last *padded* position, as in the reference.

        With ``defer=True`` the prefill (and the first sampled token)
        stays enqueued on the device — call ``harvest()`` to materialise
        and emit. With ``defer=False`` the first token plane is
        materialised and harvested before returning.
        """
        rows_max, len_max = 0, 1
        for local, (uids, prompts, max_new) in groups.items():
            if not 0 <= local < self.n_experts:
                raise ValueError(f"local expert {local} out of range")
            if len(uids) != len(prompts) or len(uids) != len(max_new):
                raise ValueError("uids/prompts/max_new length mismatch")
            if len(prompts) > self.batch_buckets[-1]:
                raise ValueError(
                    f"micro-batch of {len(prompts)} rows exceeds the "
                    f"largest batch bucket {self.batch_buckets[-1]}")
            rows_max = max(rows_max, len(prompts))
            len_max = max(len_max, max((len(p) for p in prompts),
                                       default=1))
        if rows_max == 0:
            return False
        wave_id = self.tracer.next_id() if self.tracer.enabled else 0
        groups = {l: g for l, g in groups.items() if g[0]}
        Bb = bucket_for(rows_max, self.batch_buckets)
        Sb = bucket_for(len_max, self.len_buckets)
        E = self.n_experts
        toks = np.zeros((E, Bb, Sb), np.int32)
        uids: Dict[int, List[Any]] = {}
        per_row: Dict[int, List[int]] = {}
        done: Dict[int, List[bool]] = {}
        n_rows, n_submitted = 0, 0
        for local, (u, prompts, max_new) in groups.items():
            for i, p in enumerate(prompts):
                p = np.asarray(p, np.int32)[-Sb:]
                toks[local, i, :len(p)] = p
                n_submitted += len(p)
            uids[local] = list(u)
            per_row[local] = [max(1, int(m)) for m in max_new]
            done[local] = [False] * len(u)
            n_rows += len(u)
        fb0 = self.stats.spec_fallback_waves
        if self.kv_layout == "paged":
            # may raise PagePoolExhausted with nothing changed — the
            # scheduler requeues the rows as backpressure; the device span
            # below opens only after admission succeeds
            w = self._admit_paged(toks, uids, per_row, done, Bb, Sb,
                                  wave_id)
        else:
            with self._prefill_range(wave_id, Bb=Bb, Sb=Sb, rows=n_rows,
                                     tokens=n_rows * Sb) as rng:
                logits, caches = self._prefill(toks)
            self.stats.prefill_calls += 1
            self.stats.prefill_rows_computed += n_rows
            self.stats.prefill_tokens_computed += n_rows * Sb
            tok = [self._sample(lg) for lg in logits]
            steps = max(m for ms in per_row.values() for m in ms) - 1
            sk = self.speculate_k
            # no-wrap gate: every slot a verify may optimistically write
            # (up to Sb + steps - 1 + k) must fit the ring without
            # wrapping onto live context
            if sk and steps > 0 and Sb + steps + sk <= self.max_len:
                C, n = self.max_len, self.per_pos
                w = self._make_spec_wave(
                    uids, per_row, done, Bb, Sb, steps, tok=tok,
                    cache=[{"k": c["k"], "v": c["v"]} for c in caches],
                    row_pos=[c["pos"][:, None].expand(n, Bb, C).clone()
                             for c in caches],
                    row_t=[c["t"][:, None].expand(n, Bb).clone()
                           for c in caches])
            else:
                if sk:
                    self.stats.spec_fallback_waves += 1
                w = _Wave(uids=uids, per_row_new=per_row, done=done,
                          cache=caches, tok=tok,
                          emitted=[[t[..., 0] for t in tok]],
                          steps_left=steps)
                if self.row_slots is not None:
                    self.row_slots.install(w, caches, tok)
                    w.cache = None
            w.first_range = rng
        w.Sb = Sb
        self.stats.rows_served += n_rows
        self.stats.rows_padded += E * Bb - n_rows
        self.stats.prefill_tokens_submitted += n_submitted
        if self.tracer.enabled:
            w.wave_id = wave_id
            flat = [u for us in uids.values() for u in us]
            self.tracer.first_token(flat, w.first_range)
            w.sp_prefill = self.tracer.begin_device(
                "wave.prefill", wave=w.wave_id, Bb=Bb, Sb=Sb,
                rows=n_rows, spec=w.spec, chunks=len(w.pending_chunks),
                uids=flat, traces=[self.tracer.trace_of(u) for u in flat])
            if self.stats.spec_fallback_waves > fb0:
                self.tracer.event("spec.fallback", wave=w.wave_id)
        self._active.append(w)
        if not defer:
            # blocking reference: drain the wave's prefill chunks (none on
            # unchunked waves) before materialising the first token
            while w.pending_chunks:
                self._dispatch_chunk(w)
            self._materialize(w, 1)
            self.harvest()
        return True

    # -- paged admission -------------------------------------------------
    def _alloc_pages(self, local: int, n: int,
                     ledger: List[Tuple[int, List[int]]]) -> List[int]:
        """Pool allocation with prefix-cache eviction as the fallback;
        every page taken is recorded in ``ledger`` for rollback."""
        try:
            pages = self.pool.alloc(local, n)
        except PagePoolExhausted:
            self.prefix_cache.evict_for(local, n)
            pages = self.pool.alloc(local, n)
        ledger.append((local, pages))
        return pages

    def _admit_paged(self, toks: np.ndarray, uids, per_row, done,
                     Bb: int, Sb: int, wave_id: int = 0) -> _Wave:
        """Plan page tables for one wave, sharing prefixes, then prefill
        only the rows no cached or duplicated prefix covers.

        Host phase (transactional): every row is

          * ``cached`` — its full padded prompt's pages are in the
            cross-wave prefix cache and the greedy first token is known:
            the row adopts the pages (refcount++) and skips prefill;
          * ``dup`` — an earlier row of this wave carries the identical
            padded prompt: share its pages, take its first token;
          * ``computed`` — adopt whatever cached prefix exists (with
            chunking, snapped down to a chunk boundary and its chunks
            skipped; without, scattered to trash: storage shared, compute
            not), allocate fresh pages for the rest, and join the packed
            prefill batch.

        Rows that wrap (Sb + steps > capacity) overwrite prompt pages
        during decode, so shared pages in the write range are
        copy-on-write remapped to fresh copies before the first tick. If
        the pool cannot cover the wave even after evicting cache entries,
        every reference taken is rolled back and ``PagePoolExhausted``
        propagates with the pool untouched.

        Device phase: computed rows are packed into an (E, Bbc, Sb)
        prefill — or planned as chunk descriptors when the prompt is
        longer than ``chunk_len`` — followed by the COW page copies and
        the first-token plane (gathered from the packed logits, cached
        rows overlaid), all enqueued without a host block.
        """
        E, page, nlp, C = self.n_experts, self.page, self.n_logical, \
            self.max_len
        npp = Sb // page
        trash = self.pool.trash
        steps = max(m for ms in per_row.values() for m in ms) - 1
        # chunked geometry: prompts longer than chunk_len split into
        # chunk dispatches; partial-prefix adoption snaps down to a chunk
        # boundary and is capped at npp - ppc, so the last chunk always
        # computes (its logits carry every computed row's first token)
        chunked = self.chunk_len is not None and Sb > self.chunk_len
        ppc = (self.chunk_len // page) if chunked else npp
        start_chunk: Dict[Tuple[int, int], int] = {}
        # speculative gate: a row's last verify may start at Sb + steps - 1
        # and write k slots past it, so the whole write window [Sb, Sb +
        # steps + k) must fit without wrapping — which also keeps every
        # speculative write inside pages the row owns (never a shared
        # prompt page) and copy-on-write out of the picture. Chunked waves
        # fall back to plain decode (the same tokens, not accelerated).
        sk = self.speculate_k
        spec_ok = bool(sk) and steps > 0 and Sb + steps + sk <= C \
            and not chunked
        if sk and not spec_ok:
            self.stats.spec_fallback_waves += 1
        slack = sk if spec_ok else 0
        wr_pages = sorted({(s % C) // page
                           for s in range(Sb, Sb + steps + slack)})
        wr_prompt = [lp for lp in wr_pages if lp < npp]
        wr_decode = [lp for lp in wr_pages if lp >= npp]
        register_ok = not wr_prompt      # decode never clobbers a prefix

        table = np.full((E, Bb, nlp), trash, np.int32)
        ledger: List[Tuple[int, List[int]]] = []      # refs for rollback
        to_release: List[Tuple[int, List[int]]] = []  # COW'd-out pages
        copies: Dict[int, List[Tuple[int, int]]] = {}  # local -> (src, dst)
        scatter: Dict[Tuple[int, int], List[int]] = {}  # computed rows
        cached_tok: Dict[Tuple[int, int], int] = {}
        dup_src: Dict[Tuple[int, int], int] = {}      # row -> computed row
        register: List[Tuple[int, int, int, List[bytes], List[int]]] = []
        n_cached = n_dup = n_shared = 0
        try:
            for local, row_uids in uids.items():
                seen: Dict[bytes, int] = {}       # full-prompt key -> row
                for i in range(len(row_uids)):
                    chain = hash_chain(toks[local, i], page)
                    key = chain[-1]
                    prow: List[int]
                    if key in seen:
                        # only computed rows enter ``seen``, so a dup's
                        # first token comes from its representative's
                        # packed logits
                        rep = seen[key]
                        prow = list(table[local, rep, :npp])
                        self.pool.retain(local, prow)
                        # a ledger entry owns its page list: the COW remap
                        # below mutates prow in place
                        ledger.append((local, list(prow)))
                        dup_src[(local, i)] = rep
                        n_dup += 1
                        n_shared += npp
                    else:
                        adopted = self.prefix_cache.adopt_prefix(local,
                                                                 chain)
                        if adopted:
                            ledger.append((local, list(adopted)))
                        ftok = None
                        if len(adopted) == npp:
                            ftok = self.prefix_cache.first_token(
                                local, Sb, chain)
                        if ftok is not None:
                            prow = list(adopted)
                            cached_tok[(local, i)] = ftok
                            n_cached += 1
                            n_shared += npp
                        else:
                            if wr_prompt and adopted:
                                # a wrapping row must own its wrapped
                                # prompt pages: drop the adoption and
                                # compute everything into fresh pages
                                self.pool.release(local, adopted)
                                ledger.pop()
                                adopted = []
                            d = len(adopted)
                            if chunked and d:
                                # snap adoption to the chunk grid: kept
                                # pages' chunks are skipped, not re-run
                                keep = min((d // ppc) * ppc, npp - ppc)
                                if keep < d:
                                    self.pool.release(local,
                                                      adopted[keep:])
                                    if keep:
                                        ledger[-1] = (local,
                                                      list(adopted[:keep]))
                                    else:
                                        ledger.pop()
                                    adopted = adopted[:keep]
                                    d = keep
                            fresh = self._alloc_pages(local, npp - d,
                                                      ledger)
                            prow = list(adopted) + fresh
                            scatter[(local, i)] = [trash] * d + fresh
                            if chunked:
                                start_chunk[(local, i)] = d // ppc
                            n_shared += d
                            if register_ok:
                                register.append((local, i, Sb, chain,
                                                 list(prow)))
                            seen[key] = i
                    # copy-on-write: shared pages decode will overwrite
                    for lp in wr_prompt:
                        if self.pool.shared(local, prow[lp]):
                            new = self._alloc_pages(local, 1, ledger)[0]
                            copies.setdefault(local, []).append(
                                (prow[lp], new))
                            to_release.append((local, [prow[lp]]))
                            prow[lp] = new
                    decode_pages = self._alloc_pages(
                        local, len(wr_decode), ledger)
                    table[local, i, :npp] = prow
                    for lp, pg in zip(wr_decode, decode_pages):
                        table[local, i, lp] = pg
        except PagePoolExhausted:
            for local, pages in ledger:
                self.pool.release(local, pages)
            raise
        # commit: COW'd-out shared pages lose this wave's reference (the
        # rollback above must not see them as released, hence deferred)
        for local, pages in to_release:
            self.pool.release(local, pages)
        pages_held = {
            local: [[int(p) for p in table[local, i] if p != trash]
                    for i in range(len(row_uids))]
            for local, row_uids in uids.items()}

        # device phase: packed prefill over computed rows only
        computed = sorted(scatter)                 # [(local, i), ...]
        per_local: Dict[int, List[int]] = {}
        for local, i in computed:
            per_local.setdefault(local, []).append(i)
        n_computed = len(computed)
        use_chunks = chunked and n_computed > 0
        mask = vals = rng = None
        if cached_tok:
            mask = np.zeros((E, Bb), bool)
            vals = np.zeros((E, Bb), np.int32)
            for (local, i), ft in cached_tok.items():
                mask[local, i] = True
                vals[local, i] = ft
        pending: List[Dict[str, Any]] = []
        fin: Optional[Dict[str, Any]] = None
        if use_chunks:
            # plan (don't dispatch) one descriptor per chunk: chunk k
            # packs every computed row whose adopted prefix doesn't cover
            # it; chunk 0 is a plain paged prefill at the chunk_len
            # bucket, chunks >= 1 are suffix prefills. _dispatch_chunk
            # issues them — at once (blocking admit) or interleaved with
            # decode ticks under the executor's token budget (deferred).
            cl = self.chunk_len
            for k in range(Sb // cl):
                rows_k = [(l, i) for (l, i) in computed
                          if start_chunk[(l, i)] <= k]
                if not rows_k:
                    continue
                pl_k: Dict[int, List[int]] = {}
                for l, i in rows_k:
                    pl_k.setdefault(l, []).append(i)
                Bbk = bucket_for(max(len(v) for v in pl_k.values()),
                                 self.batch_buckets)
                toks_k = np.zeros((E, Bbk, cl), np.int32)
                stbl_k = np.full((E, Bbk, ppc), trash, np.int32)
                # padding rows read the trash page through their prefix
                # table — finite garbage, outputs discarded
                ptbl_k = np.full((E, Bbk, k * ppc), trash, np.int32)
                slot_of_k: Dict[Tuple[int, int], int] = {}
                for l, rows in pl_k.items():
                    for c, i in enumerate(rows):
                        toks_k[l, c] = toks[l, i, k * cl:(k + 1) * cl]
                        stbl_k[l, c] = \
                            scatter[(l, i)][k * ppc:(k + 1) * ppc]
                        if k:
                            ptbl_k[l, c] = table[l, i, :k * ppc]
                        slot_of_k[(l, i)] = c
                pending.append({"k": k, "toks": toks_k, "stbl": stbl_k,
                                "ptbl": ptbl_k, "rows": len(rows_k),
                                "slot_of": slot_of_k})
            # every computed row rides the last chunk, so its packed
            # logits carry every first token; dups resolve through their
            # representative
            last = pending[-1]["slot_of"]
            src = np.zeros((E, Bb), np.int32)
            for local, row_uids in uids.items():
                for i in range(len(row_uids)):
                    src[local, i] = last.get(
                        (local, i),
                        last.get((local, dup_src.get((local, i), -1)), 0))
            fin = {"src": src, "mask": mask, "vals": vals,
                   "copies": copies}
        else:
            logits = src = None
            if n_computed:
                Bbc = bucket_for(max(len(v) for v in per_local.values()),
                                 self.batch_buckets)
                toks_c = np.zeros((E, Bbc, Sb), np.int32)
                stbl = np.full((E, Bbc, npp), trash, np.int32)
                slot_of: Dict[Tuple[int, int], int] = {}
                for local, rows in per_local.items():
                    for c, i in enumerate(rows):
                        toks_c[local, c] = toks[local, i]
                        stbl[local, c] = scatter[(local, i)]
                        slot_of[(local, i)] = c
                with self._prefill_range(wave_id, Bb=Bbc, Sb=Sb,
                                         rows=n_computed,
                                         tokens=n_computed * Sb) as rng:
                    logits = self._paged_prefill(toks_c, stbl)
                self.stats.prefill_calls += 1
                src = np.zeros((E, Bb), np.int32)
                for local, row_uids in uids.items():
                    for i in range(len(row_uids)):
                        src[local, i] = slot_of.get(
                            (local, i),
                            slot_of.get((local,
                                         dup_src.get((local, i), -1)), 0))
            tok = self._first_tokens(logits, src, mask, vals)
            # COW copies read post-prefill pages (a dup's source may have
            # been written by this very wave's scatter)
            self._copy_pages(copies)
            self.stats.pages_copied += sum(len(p) for p in copies.values())
            self.stats.prefill_tokens_computed += n_computed * Sb

        self.stats.prefill_rows_computed += n_computed
        self.stats.prefix_full_hits += n_cached
        self.stats.prefix_dup_rows += n_dup
        self.stats.prefix_pages_shared += n_shared
        pos = np.where(np.arange(C) < Sb, np.arange(C), -1).astype(np.int32)
        table_dev = self._upload(table)
        pos_dev = self._upload(np.broadcast_to(pos, (E, C)).copy())
        n = self.per_pos
        t_dev = [torch.full((n,), Sb, dtype=torch.int32, device=dev)
                 for dev in self.devices]
        if spec_ok:
            # per-row position planes (rows advance at different rates)
            return self._make_spec_wave(
                uids, per_row, done, Bb, Sb, steps,
                tok=[t[..., None] for t in tok],
                row_pos=[q[:, None].expand(n, Bb, C).clone()
                         for q in pos_dev],
                row_t=[t[:, None].expand(n, Bb).clone() for t in t_dev],
                cache=None, table=table_dev, pages_held=pages_held,
                register=register, first_range=rng)
        w = _Wave(uids=uids, per_row_new=per_row, done=done, cache=None,
                  tok=None, emitted=[], steps_left=steps, table=table_dev,
                  pos=pos_dev, t=t_dev, pages_held=pages_held,
                  register=register, first_range=rng)
        if use_chunks:
            w.pending_chunks, w.finalize = pending, fin
        else:
            w.tok = [t[..., None] for t in tok]
            w.emitted.append(tok)
        return w

    def _first_tokens(self, logits, src, mask, vals) -> List[torch.Tensor]:
        """The wave's (E, Bb) int32 first-token plane, on the devices:
        the greedy token of packed row ``src[e, i]`` of ``logits`` (E,
        Bbc, V), with cached rows (``mask``) overlaid by their known
        token ``vals``. Either half may be absent (``None``)."""
        if logits is None and mask is None:
            raise AssertionError("wave with rows but no token source")
        n = len(self.devices)
        srcs = self._upload(src, torch.long) if logits is not None \
            else [None] * n
        masks, vs = (self._upload(mask), self._upload(vals)) \
            if mask is not None else ([None] * n, [None] * n)
        out = []
        for p in range(n):
            tok = None
            if logits is not None:
                tok_c = torch.argmax(logits[p], dim=-1).to(torch.int32)
                tok = torch.gather(tok_c, 1, srcs[p])
            if mask is not None:
                tok = vs[p] if tok is None else torch.where(masks[p], vs[p],
                                                            tok)
            out.append(tok)
        return out

    # -- chunked prefill dispatch ----------------------------------------
    def _dispatch_chunk(self, w: _Wave) -> int:
        """Issue the wave's next pending prefill chunk (FIFO). Chunk 0 is
        a plain paged prefill at the chunk_len bucket; later chunks attend
        over the pages earlier chunks (or an adopted prefix) wrote. When
        the last chunk is issued the wave is finalized. Returns prompt
        tokens dispatched (real rows x chunk_len, the budget currency)."""
        d = w.pending_chunks.pop(0)
        k = d["k"]
        spent = d["rows"] * self.chunk_len
        with self._prefill_range(w.wave_id, Bb=d["toks"].shape[1], k=k,
                                 rows=d["rows"], tokens=spent) as rng:
            if k == 0:
                logits = self._paged_prefill(d["toks"], d["stbl"])
            else:
                logits = self._paged_suffix(k, d["toks"], d["ptbl"],
                                            d["stbl"])
        self.stats.prefill_calls += 1
        self.stats.prefill_tokens_computed += spent
        self.tracer.event("wave.chunk", wave=w.wave_id, chunk=k,
                          tokens=spent, remaining=len(w.pending_chunks))
        if not w.pending_chunks:
            w._tok_c = logits
            if self.tracer.enabled:
                self.tracer.first_token(
                    [u for us in w.uids.values() for u in us], rng)
            self._finalize_wave(w)
        return spent

    def _finalize_wave(self, w: _Wave) -> None:
        """Last chunk landed: gather every row's first token from the
        final chunk's packed logits (cached rows overlay their known
        token) and apply the deferred COW copies — the wave is now
        decode-eligible."""
        f = w.finalize
        w.finalize = None
        tok = self._first_tokens(w._tok_c, f["src"], f["mask"], f["vals"])
        w._tok_c = None
        # COW copies must read fully written prompt pages, so they wait
        # for the last chunk
        self._copy_pages(f["copies"])
        self.stats.pages_copied += sum(len(p) for p in f["copies"].values())
        w.tok = [t[..., None] for t in tok]
        w.emitted.append(tok)

    def prefill_step(self, budget: int = 0) -> int:
        """Dispatch pending prefill chunks FIFO across active waves — at
        least one chunk per call so long prompts always progress —
        stopping once ``budget`` prompt tokens (0 = unbounded) have been
        issued. The executor calls this between admission and decode
        ticks, so a long prompt's remaining chunks interleave with
        co-resident waves' decode steps. Returns tokens dispatched."""
        spent = 0
        for w in list(self._active):
            while w.pending_chunks:
                spent += self._dispatch_chunk(w)
                if budget and spent >= budget:
                    return spent
        return spent

    @property
    def has_pending_chunks(self) -> bool:
        return any(w.pending_chunks for w in self._active)

    # -- decoding --------------------------------------------------------
    def tick(self, *, defer: bool = False) -> int:
        """Advance every active wave one decode step. Returns waves
        advanced.

        ``defer=False`` (the blocking reference) materialises each wave's
        new token plane immediately — one host block per wave — and
        harvests before returning. ``defer=True`` only enqueues: the token
        feeds the next decode without leaving the device, and the host
        blocks once per wave at ``harvest()``.

        In a core with row slots every wave's step comes from one replay
        a row group, and its plane is its rows' ``Columns`` of the
        replays' outputs; a wave still counts one decode step a step.
        """
        # a wave with prefill chunks still pending has no sampled token
        # yet: decode takes it once its last chunk lands
        waves = [w for w in self._active
                 if w.tok is not None and w.steps_left > 0]
        planes: List[Any] = [None] * len(waves)
        if self.row_slots is not None and waves:
            planes = self.row_slots.step(waves, self._decode_graphs)
        for w, plane in zip(waves, planes):
            if w.spec:
                self._spec_tick(w)
                if not defer:
                    self._materialize_spec(w)
                continue
            if plane is None:
                # a plane of its own: planes wait on the device until
                # harvest, and the graph's static output is overwritten
                w.tok = self._decode_step(w)
                plane = [t[..., 0] for t in w.tok]
            w.emitted.append(plane)
            w.ticks += 1
            w.steps_left -= 1
            self.stats.decode_steps += 1
            if not defer:
                self._materialize(w, len(w.emitted))
        if not defer:
            self.harvest()
        return len(waves)

    def _spec_tick(self, w: _Wave) -> None:
        """One verify of a speculative wave: every active row advances by
        at least one token (the corrected greedy token when every draft
        misses), so the wave ends within ``steps`` verifies and usually
        far fewer. ``steps_left`` stays the plain tick count's upper
        bound; harvest zeroes it once every row has its tokens."""
        w.spec_pending.append(self._verify_step(w))
        w.ticks += 1
        w.steps_left -= 1
        self.stats.decode_steps += 1
        self.stats.verify_steps += 1

    # -- harvest ---------------------------------------------------------
    def _materialize(self, w: _Wave, upto: int) -> None:
        """Bring ``emitted[:upto]`` to the host in one blocking copy: every
        plain plane and every replay output that a ``Columns`` plane reads
        (each once) side by side on each device, out of which each step's
        (E, Bb) plane is read (a ``Columns`` row that no longer decodes
        keeps 0: harvest reads none)."""
        upto = min(upto, len(w.emitted))
        if upto <= w.n_host:
            return
        planes = w.emitted[w.n_host:upto]
        parts: List[List[torch.Tensor]] = []
        at: Dict[int, int] = {}              # id of a part -> its column
        width = 0
        for pl in planes:
            for x in (pl.planes if isinstance(pl, Columns) else [pl]):
                if id(x) not in at:
                    at[id(x)] = width
                    width += x[0].shape[1]
                    parts.append(x)
        host = self._fetch([torch.cat([x[p].reshape(x[p].shape[0], -1)
                                       for x in parts], dim=1)
                            for p in range(len(self.devices))])
        Bb = w.tok[0].shape[1]
        for k, pl in enumerate(planes):
            if isinstance(pl, Columns):
                arr = np.zeros((self.n_experts, Bb), host.dtype)
                for (e, i), (q, s) in pl.at.items():
                    arr[e, i] = host[e, at[id(pl.planes[q])] + s]
            else:
                arr = host[:, at[id(pl)]:at[id(pl)] + Bb]
            w.emitted[w.n_host + k] = arr
        w.n_host = upto
        self.stats.host_blocks += 1
        # the copy above completed everything enqueued for this wave, so
        # its open prefill span closes here (tracing rides this sync)
        if w.sp_prefill is not None:
            self.tracer.end_device(w.sp_prefill, planes=upto)
            w.sp_prefill = None

    def _materialize_spec(self, w: _Wave) -> None:
        """Bring a speculative wave's pending verify planes (and the
        prefill token plane the first time) to the host in one blocking
        copy, and advance each row's token buffer by its *actual* advance:
        the host learns real progress, which lets harvest retire the wave
        after about steps / E[adv] verifies instead of steps. Counted as
        one host block, as the reference counts it, even when only the
        already-host prefill plane is left to seed."""
        if w.spec_seeded and not w.spec_pending:
            return
        E, Bb = w.host_fill.shape
        first = w.emitted[0]
        seed = not isinstance(first, np.ndarray)     # still on the device
        # a member's row of each position: [first plane | verify planes]
        planes = ([first] if seed else []) + w.spec_pending
        host = self._fetch([torch.cat([x.reshape(x.shape[0], -1)
                                       for x in pp], dim=1)
                            for pp in zip(*planes)]) if planes else None
        self.stats.host_blocks += 1
        # the copy above completed everything enqueued for this wave, so
        # its open prefill span closes here
        if w.sp_prefill is not None:
            self.tracer.end_device(w.sp_prefill)
            w.sp_prefill = None
        if seed:
            w.emitted[0] = host[:, :Bb]
            host = host[:, Bb:]
        if not w.spec_seeded:
            w.n_host = max(w.n_host, 1)
            w.host_buf[:, :, 0] = w.emitted[0]
            np.maximum(w.host_fill, 1, out=w.host_fill)
            w.spec_seeded = True
        k = self.speculate_k
        K1 = k + 1
        planes = host.reshape(E, len(w.spec_pending), Bb, k + 4).swapaxes(
            0, 1) if w.spec_pending else ()
        for plane in planes:
            for local, row_uids in w.uids.items():
                for i in range(len(row_uids)):
                    a = int(plane[local, i, K1])
                    if a > 0:
                        f = int(w.host_fill[local, i])
                        w.host_buf[local, i, f:f + a] = plane[local, i, :a]
                        w.host_fill[local, i] = f + a
                    c = int(plane[local, i, K1 + 1])
                    if c >= 0:
                        self.stats.tokens_drafted += k
                        self.stats.tokens_accepted += c
        w.spec_pending = []

    def _harvest_spec(self, w: _Wave) -> None:
        """Emit every speculative row whose token buffer is full; once all
        rows are done, zero ``steps_left`` so the wave retires now rather
        than after its remaining tick budget.

        The copy is gated as plain waves gate ``_materialize`` (``need >
        n_host``): a verify advances a row by at most ``k + 1`` tokens, so
        until the pending planes could complete some unfinished row there
        is nothing to emit and the sync is skipped — without this, spec
        waves would block the host at every harvest."""
        if w.spec_pending and w.steps_left > 0:
            bound = (len(w.spec_pending) * (self.speculate_k + 1)
                     + (0 if w.spec_seeded else 1))
            if not any(not w.done[local][i]
                       and w.host_fill[local, i] + bound
                       >= w.per_row_new[local][i]
                       for local, row_uids in w.uids.items()
                       for i in range(len(row_uids))):
                return
        self._materialize_spec(w)
        for local, row_uids in w.uids.items():
            for i, uid in enumerate(row_uids):
                if w.done[local][i]:
                    continue
                n = w.per_row_new[local][i]
                if w.host_fill[local, i] >= n:
                    seq = np.array(w.host_buf[local, i, :n], np.int32)
                    self._finished.append((local, uid, seq))
                    self.stats.tokens_generated += n
                    w.done[local][i] = True
        if all(all(d) for d in w.done.values()):
            w.steps_left = 0
            self._retire(w)

    def _retire(self, w: _Wave) -> None:
        """Drop a finished wave: nothing of it needs copying out of any
        step graph any more, and a paged wave's pages go back."""
        self._active.remove(w)
        for _, _, g in self.step_graphs():
            g.release(w)
        if self.kv_layout == "paged":
            self._retire_paged(w)

    def harvest(self) -> None:
        """Emit every row whose ``max_new`` tokens are all available and
        retire fully-done waves (at most one host block per wave)."""
        for w in list(self._active):
            if w.spec:
                self._harvest_spec(w)
                continue
            have = len(w.emitted)
            need = 0
            for local, row_uids in w.uids.items():
                for i in range(len(row_uids)):
                    if (not w.done[local][i]
                            and w.per_row_new[local][i] <= have):
                        need = max(need, w.per_row_new[local][i])
            if need > w.n_host:
                self._materialize(w, need)
            for local, row_uids in w.uids.items():
                for i, uid in enumerate(row_uids):
                    if w.done[local][i] or w.per_row_new[local][i] > have:
                        continue
                    seq = np.asarray(
                        [w.emitted[t][local, i] for t in
                         range(w.per_row_new[local][i])], np.int32)
                    self._finished.append((local, uid, seq))
                    self.stats.tokens_generated += len(seq)
                    w.done[local][i] = True
            if w.steps_left <= 0 and all(all(d) for d in w.done.values()):
                self._retire(w)

    def _retire_paged(self, w: _Wave) -> None:
        """Register computed prefixes in the cross-wave cache (the first
        token plane is on the host by now, so registering costs no sync),
        then release every page the wave's rows held. This runs only
        after the wave's last token plane reached the host, which
        completed every kernel that read its pages."""
        for local, i, padded_len, chain, pages in w.register:
            self.prefix_cache.insert(local, padded_len, chain, pages,
                                     int(w.emitted[0][local, i]))
        for local, rows in w.pages_held.items():
            for pages in rows:
                self.pool.release(local, pages)
        w.pages_held = {}
        w.register = []

    def poll(self) -> List[Tuple[int, Any, np.ndarray]]:
        """Drain finished (local expert, uid, tokens) triples."""
        out, self._finished = self._finished, []
        return out

    @property
    def n_active(self) -> int:
        return len(self._active)

    @property
    def has_pending(self) -> bool:
        """Active waves or finished rows not yet polled."""
        return bool(self._active or self._finished)


# ---------------------------------------------------------------------------
# Dispatch executors
# ---------------------------------------------------------------------------


class DispatchExecutor:
    """How one scheduler step drives its shards: run the expert hub's
    lifecycle round, issue every shard's
    prefill, then pending prefill chunks under the step's token budget,
    then every shard's decode tick, then harvest. ``defer``
    decides whether each dispatch blocks on its own device-to-host copy
    (serial, the reference) or nothing blocks until the single batched
    harvest copy per wave (overlapped). The computation is the same
    either way, so the tokens are identical; only
    ``EngineStats.host_blocks`` differs."""

    name = "base"
    defer = False

    def run_step(self, sched) -> None:
        # each phase is a host span (``sched.*``: the time the host spends
        # there, enqueues and waits alike)
        tr = sched.tracer
        # the expert hub's round first: slot installs are enqueued ahead
        # of this step's prefills and decode ticks (a no-op without a hub)
        with tr.enqueue_span("sched.hub"):
            sched._service_hub()
        with tr.enqueue_span("sched.admit"):
            sched._admit_batches(defer=self.defer)
        # pending chunks of partially prefilled waves go out here, bounded
        # per step by SchedulerConfig.prefill_tokens_per_step, so the
        # decode ticks below run every step while a long prompt prefills
        # (on the blocking path admission already drained its chunks)
        with tr.enqueue_span("sched.chunks"):
            sched._prefill_chunks()
        with tr.enqueue_span("sched.tick"):
            sched._tick_engines(defer=self.defer)
        with tr.enqueue_span("sched.harvest"):
            sched._harvest_engines()


class SerialExecutor(DispatchExecutor):
    """Reference behaviour: every admit/tick materialises its sampled
    token immediately, blocking the host once per tick per wave."""

    name = "serial"
    defer = False


class OverlappedExecutor(DispatchExecutor):
    """Prefills and decode ticks for *all* shards are enqueued before
    anything blocks; tokens stay on the device and the host blocks at
    most once per wave per step, inside the batched harvest. On CUDA each
    decode tick replays its bucket's captured graph; prefill is eager,
    and every shard issues on the one current stream (separate CUDA
    streams per shard are port slice A7.2)."""

    name = "overlapped"
    defer = True


def get_executor(executor) -> DispatchExecutor:
    """Resolve ``'serial'`` / ``'overlapped'`` / an instance."""
    if isinstance(executor, DispatchExecutor):
        return executor
    if executor == "serial":
        return SerialExecutor()
    if executor == "overlapped":
        return OverlappedExecutor()
    raise ValueError(f"unknown executor {executor!r}; expected 'serial', "
                     "'overlapped' or a DispatchExecutor instance")
