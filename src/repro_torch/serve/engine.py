"""ExpertEngine: one expert model behind the router — the E=1 shim over
the shared ``EngineCore``.

What the engine guarantees (see ``EngineCore`` for mechanics):

  * admissions snap to (batch, prompt-length) buckets, so the set of
    shapes the engine ever runs is bounded by the bucket-ladder product;
  * admitted groups stay resident (KV cache + last token) and advance one
    token per ``tick`` — the scheduler interleaves ticks across engines;
  * the decode step writes the KV cache in place: the wave's ring
    cache, or (``kv_layout="paged"``) the engine's page pool, with
    prefix sharing, copy-on-write and chunked prefill (``chunk_len``);
    one step per decode batch bucket, a captured CUDA graph on the card;
  * with ``speculate_k`` > 0 a draft (``draft``: a ``DraftModel`` or
    ``"mlp"`` / ``"table"`` / ``"always-wrong"``) proposes that many
    tokens a row and one verify step scores them all, with the same
    tokens as plain decode;
  * per-row results are emitted as soon as a row has its
    ``max_new_tokens``, not when its whole group retires.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.registry import ExpertSpec
from ..models.api import BaseModel
from .core import EngineCore, EngineStats, bucket_for, make_buckets

__all__ = ["EngineFacade", "ExpertEngine", "EngineStats", "bucket_for",
           "make_buckets"]


class EngineFacade:
    """The serving surface an engine exposes over its ``EngineCore``:
    ``ExpertEngine`` (one expert) and ``BankedEngine`` (E experts, one
    wave and one captured step for all) share it."""

    def __init__(self, model: BaseModel, core: EngineCore):
        self.core = core
        self.model = model
        self.device = core.device
        self.max_len = core.max_len
        self.len_buckets = core.len_buckets
        self.batch_buckets = core.batch_buckets
        self.kv_layout = core.kv_layout

    @property
    def stats(self) -> EngineStats:
        return self.core.stats

    def bind_tracer(self, tracer) -> None:
        """Install a lifecycle tracer on the core (None disables)."""
        self.core.bind_tracer(tracer)

    def pad_shape(self, n_rows: int, prompt_len: int) -> Tuple[int, int]:
        """(batch bucket, length bucket) this admission would snap to."""
        return self.core.pad_shape(n_rows, prompt_len)

    def tick(self, *, defer: bool = False) -> int:
        """Advance every active wave one decode step (a bank's step
        covers every member). Returns the number of waves advanced
        (0 == engine idle)."""
        return self.core.tick(defer=defer)

    def harvest(self) -> None:
        """Materialise (one batched copy per wave) and emit every row
        whose tokens are all available; retire finished waves."""
        self.core.harvest()

    @property
    def n_active(self) -> int:
        return self.core.n_active

    @property
    def has_pending(self) -> bool:
        """Still decoding, or holding finished rows not yet polled."""
        return self.core.has_pending


class ExpertEngine(EngineFacade):
    """One expert model with bucketed shapes and resident groups. Runs on
    ``cuda`` unless ``device="cpu"``; ``params`` must live there (and may
    be shared with other engines: the engine never copies them). On CUDA
    each decode bucket's step is captured once as a CUDA graph and
    replayed; ``capture_decode=False`` runs the same step eagerly (read
    only on CUDA: the CPU is always eager). ``speculate_k`` > 0 serves
    waves by draft-k/verify-1 speculative decoding with ``draft``."""

    def __init__(self, model: BaseModel, params, *, max_len: int = 256,
                 min_len_bucket: int = 8,
                 batch_buckets: Optional[Sequence[int]] = None,
                 kv_layout: str = "ring", page_size: int = 8,
                 pool_pages: Optional[int] = None,
                 chunk_len: Optional[int] = None,
                 speculate_k: int = 0, draft=None, device=None,
                 capture_decode: bool = True):
        super().__init__(model, EngineCore(
            model, [params], max_len=max_len, min_len_bucket=min_len_bucket,
            batch_buckets=batch_buckets, kv_layout=kv_layout,
            page_size=page_size, pool_pages=pool_pages, chunk_len=chunk_len,
            speculate_k=speculate_k, draft=draft, device=device,
            capture_decode=capture_decode))
        self.params = params
        self._gen_serial = 0           # private generate() uid namespace

    @property
    def spec(self) -> ExpertSpec:
        """The catalog entry type describing this engine."""
        return ExpertSpec.of_engine(self)

    # -- admission -------------------------------------------------------
    def admit(self, uids: Sequence[int], prompts: Sequence[np.ndarray],
              max_new: Sequence[int], *, defer: bool = False) -> None:
        """Prefill a micro-batch and keep it resident for ticking.
        ``defer=True`` enqueues only — see ``EngineCore.admit_wave``."""
        if not (len(uids) == len(prompts) == len(max_new)):
            raise ValueError("uids/prompts/max_new length mismatch")
        if not len(uids):
            raise ValueError(
                "ExpertEngine.admit: empty micro-batch (0 rows); admit "
                "at least one row or skip the call")
        self.core.admit_wave(
            {0: (list(uids), list(prompts), list(max_new))}, defer=defer)

    # -- decoding --------------------------------------------------------
    def poll(self) -> List[Tuple[int, np.ndarray]]:
        """Drain finished (uid, tokens) pairs."""
        return [(uid, seq) for _local, uid, seq in self.core.poll()]

    # -- blocking convenience --------------------------------------------
    def generate(self, tokens, max_new: int) -> np.ndarray:
        """Greedy generation. tokens: (B, S) int32 -> (B, max_new).

        Safe to interleave with scheduler-owned admit/tick/poll traffic:
        rows are admitted under a private uid namespace (tuples never
        collide with caller-issued int uids), and any other owner's
        finished rows drained along the way are put back.
        """
        toks = np.asarray(tokens)
        if len(toks) == 0:
            return np.zeros((0, max(1, int(max_new))), np.int32)
        self._gen_serial += 1
        uids = [("__generate__", self._gen_serial, i)
                for i in range(len(toks))]
        self.admit(uids, list(toks), [max_new] * len(toks))
        want = set(uids)
        rows: Dict[Any, np.ndarray] = {}
        stash: List[Tuple[Any, np.ndarray]] = []

        def drain():
            for uid, seq in self.poll():
                if uid in want:
                    rows[uid] = seq
                else:
                    stash.append((uid, seq))

        try:
            drain()
            while len(rows) < len(uids):
                self.tick()
                drain()
        finally:
            self.core._finished.extend(
                (0, uid, seq) for uid, seq in stash)
        return np.stack([rows[u] for u in uids])
