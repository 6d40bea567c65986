"""EngineCore: the residency / bucketing / harvest machinery behind every
expert engine, plus the dispatch executors (ring KV layout).

  * ``EngineCore`` serves E >= 1 experts (``E = 1`` behind
    ``ExpertEngine``); wave arrays keep a leading ``E`` axis, as in the
    reference. Admissions snap to (batch bucket, length bucket) shapes.
  * a tick **enqueues** device work and keeps the sampled token on the
    device: ``wave.tok`` stays a tensor and emitted columns accumulate as
    device tensors. Nothing blocks until ``harvest()``, which copies all
    planes a completable row needs to the host in **one** device-to-host
    copy per wave per step.
  * every such host-blocking copy increments ``EngineStats.host_blocks``.

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

from ..device import resolve_device
from ..obs.trace import NULL_TRACER


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

    PyTorch runs eagerly and compiles nothing per shape, so
    ``prefill_compiles`` / ``decode_compiles`` count the distinct shape
    keys the engine has run — ``(Bb, Sb)`` for prefill, ``Bb`` for decode
    — the quantity the reference's executable counts bound. ``host_blocks``
    counts host-blocking device-to-host copies.
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

    @property
    def prefill_compiles(self) -> int:
        return len(self._core._prefill_shapes) if self._core else 0

    @property
    def decode_compiles(self) -> int:
        return len(self._core._decode_shapes) if self._core else 0

    @property
    def jit_cache_entries(self) -> int:
        return self.prefill_compiles + self.decode_compiles

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
            "prefill_compiles": self.prefill_compiles,
            "decode_compiles": self.decode_compiles,
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
                f"host_blocks={self.host_blocks})")


# ---------------------------------------------------------------------------
# Core
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Wave:
    """One admitted (E, Bb) micro-batch wave resident in the core.

    ``emitted`` holds one (E, Bb) token plane per generated step; planes
    start life as device tensors and are swapped for host arrays by
    ``_materialize`` — ``n_host`` is the already-materialised prefix.
    """
    uids: Dict[int, List[Any]]          # local expert -> row uids
    per_row_new: Dict[int, List[int]]
    done: Dict[int, List[bool]]
    cache: Any                          # {k, v (E, L, Bb, C, KV, dh),
    #                                      pos (E, C), t (E,)}
    tok: torch.Tensor                   # (E, Bb, 1) last sampled token
    emitted: List[Any]                  # (E, Bb) planes, device or host
    steps_left: int
    n_host: int = 0                     # emitted[:n_host] are host arrays
    # tracing (inert under NULL_TRACER): device spans begun at enqueue,
    # ended only inside _materialize, so tracing never adds a host block
    wave_id: int = 0
    sp_prefill: Any = None
    sp_decode: Any = None


def _stack(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stack on a new leading axis; one tensor becomes a view, no copy."""
    return xs[0].unsqueeze(0) if len(xs) == 1 else torch.stack(xs)


class EngineCore:
    """E homogeneous experts: bucketed shapes, resident waves, device-side
    token state, batched harvest.

    Admission and decode *enqueue* work; the only host-blocking points are
    ``_materialize`` calls — per tick in sync mode (``defer=False``, the
    serial reference), or one batched copy per wave inside ``harvest()``
    in deferred mode. Runs on ``cuda`` unless ``device="cpu"``; the
    experts' params must already live there.
    """

    def __init__(self, model, params_list: Sequence[Any], *,
                 max_len: int = 256, min_len_bucket: int = 8,
                 batch_buckets: Optional[Sequence[int]] = None,
                 kv_layout: str = "ring", chunk_len: Optional[int] = None,
                 speculate_k: int = 0, mesh=None, device=None):
        if not params_list:
            raise ValueError("EngineCore needs at least one expert")
        if kv_layout == "paged":
            raise NotImplementedError(
                "kv_layout='paged' arrives with port slice A6")
        if kv_layout != "ring":
            raise ValueError(f"unknown kv_layout {kv_layout!r}; expected "
                             "'ring' or 'paged'")
        if chunk_len is not None:
            raise NotImplementedError(
                "chunked prefill arrives with port slice A7")
        if speculate_k:
            raise NotImplementedError(
                "speculative decoding arrives with port slice A8")
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh is not part of the single-GPU port")
        self.device = resolve_device(device)
        for params in params_list:
            w = params["embed"]
            if w.device.type != self.device.type:
                raise ValueError(f"expert params live on {w.device}, the "
                                 f"engine runs on {self.device}")
        self.model = model
        self.params = list(params_list)
        self.n_experts = len(self.params)
        self.max_len = max_len
        self.len_buckets = make_buckets(min_len_bucket, max_len)
        self.batch_buckets = tuple(batch_buckets or make_buckets(1, 16))
        self.kv_layout = kv_layout
        self.stats = EngineStats(self)
        self.tracer = NULL_TRACER
        self._active: List[_Wave] = []
        self._finished: List[Tuple[int, Any, np.ndarray]] = []
        self._prefill_shapes: set = set()    # (Bb, Sb) run so far
        self._decode_shapes: set = set()     # Bb run so far

    def bind_tracer(self, tracer) -> None:
        """Install a lifecycle tracer (None restores NULL_TRACER)."""
        self.tracer = tracer if tracer is not None else NULL_TRACER

    # -- device work -----------------------------------------------------
    def _prefill(self, toks: np.ndarray):
        """(E, Bb, Sb) tokens -> (logits (E, Bb, V), wave cache)."""
        self._prefill_shapes.add(toks.shape[1:])
        tok_dev = torch.from_numpy(toks).to(self.device)
        logits, caches = [], []
        for e in range(self.n_experts):
            lg, c = self.model.prefill(self.params[e],
                                       {"tokens": tok_dev[e]},
                                       capacity=self.max_len)
            logits.append(lg)
            caches.append(c)
        cache = {k: _stack([c[k] for c in caches])
                 for k in ("k", "v", "pos", "t")}
        return _stack(logits), cache

    def _decode(self, cache, tok: torch.Tensor) -> torch.Tensor:
        """One decode step of a wave; the cache is updated in place.
        Returns logits (E, Bb, V)."""
        self._decode_shapes.add(tok.shape[1])
        logits, pos, ts = [], [], []
        for e in range(self.n_experts):
            ce = {"k": cache["k"][e], "v": cache["v"][e],
                  "pos": cache["pos"][e], "t": cache["t"][e]}
            lg, ce = self.model.decode(self.params[e], ce,
                                       {"token": tok[e]})
            logits.append(lg)
            pos.append(ce["pos"])
            ts.append(ce["t"])
        cache["pos"] = _stack(pos)
        cache["t"] = _stack(ts)
        return _stack(logits)

    @staticmethod
    def _sample(logits: torch.Tensor) -> torch.Tensor:
        """Greedy token plane (E, Bb, 1) int32, left on the device."""
        return torch.argmax(logits, dim=-1).to(torch.int32)[..., None]

    # -- admission -------------------------------------------------------
    def pad_shape(self, n_rows: int, prompt_len: int) -> Tuple[int, int]:
        """(batch bucket, length bucket) this admission would snap to."""
        return (bucket_for(n_rows, self.batch_buckets),
                bucket_for(prompt_len, self.len_buckets))

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
        logits, cache = self._prefill(toks)
        self.stats.prefill_calls += 1
        self.stats.prefill_rows_computed += n_rows
        self.stats.prefill_tokens_computed += n_rows * Sb
        tok = self._sample(logits)
        steps = max(m for ms in per_row.values() for m in ms) - 1
        w = _Wave(uids=uids, per_row_new=per_row, done=done, cache=cache,
                  tok=tok, emitted=[tok[..., 0]], steps_left=steps)
        self.stats.rows_served += n_rows
        self.stats.rows_padded += E * Bb - n_rows
        self.stats.prefill_tokens_submitted += n_submitted
        if self.tracer.enabled:
            w.wave_id = self.tracer.next_id()
            flat = [u for us in uids.values() for u in us]
            w.sp_prefill = self.tracer.begin_device(
                "wave.prefill", wave=w.wave_id, Bb=Bb, Sb=Sb,
                rows=n_rows, spec=False, chunks=0, uids=flat,
                traces=[self.tracer.trace_of(u) for u in flat])
        self._active.append(w)
        if not defer:
            self._materialize(w, 1)
            self.harvest()
        return True

    # -- decoding --------------------------------------------------------
    def tick(self, *, defer: bool = False) -> int:
        """Advance every active wave one decode step. Returns waves
        advanced.

        ``defer=False`` (the blocking reference) materialises each wave's
        new token plane immediately — one host block per wave — and
        harvests before returning. ``defer=True`` only enqueues: the token
        feeds the next decode without leaving the device, and the host
        blocks once per wave at ``harvest()``.
        """
        advanced = 0
        for w in list(self._active):
            if w.steps_left > 0:
                if w.sp_decode is None and self.tracer.enabled:
                    w.sp_decode = self.tracer.begin_device(
                        "wave.decode", wave=w.wave_id, Bb=w.tok.shape[1])
                logits = self._decode(w.cache, w.tok)
                w.tok = self._sample(logits)
                w.emitted.append(w.tok[..., 0])
                w.steps_left -= 1
                self.stats.decode_steps += 1
                advanced += 1
                if not defer:
                    self._materialize(w, len(w.emitted))
        if not defer:
            self.harvest()
        return advanced

    # -- harvest ---------------------------------------------------------
    def _materialize(self, w: _Wave, upto: int) -> None:
        """Bring ``emitted[:upto]`` to the host in one blocking copy."""
        upto = min(upto, len(w.emitted))
        if upto <= w.n_host:
            return
        planes = w.emitted[w.n_host:upto]
        host = torch.stack(planes).cpu().numpy()
        for k in range(len(planes)):
            w.emitted[w.n_host + k] = host[k]
        w.n_host = upto
        self.stats.host_blocks += 1
        # the copy above completed everything enqueued for this wave, so
        # its open device spans close here (tracing rides this sync)
        if w.sp_prefill is not None:
            self.tracer.end_device(w.sp_prefill, planes=upto)
            w.sp_prefill = None
        if w.sp_decode is not None:
            self.tracer.end_device(w.sp_decode, planes=upto)
            w.sp_decode = None

    def harvest(self) -> None:
        """Emit every row whose ``max_new`` tokens are all available and
        retire fully-done waves (at most one host block per wave)."""
        for w in list(self._active):
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
                self._active.remove(w)

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
    """How one scheduler step drives its shards: issue every shard's
    prefill, then every shard's decode tick, then harvest. ``defer``
    decides whether each dispatch blocks on its own device-to-host copy
    (serial, the reference) or nothing blocks until the single batched
    harvest copy per wave (overlapped). The computation is the same
    either way, so the tokens are identical; only
    ``EngineStats.host_blocks`` differs."""

    name = "base"
    defer = False

    def run_step(self, sched) -> None:
        sched._admit_batches(defer=self.defer)
        sched._tick_engines(defer=self.defer)
        sched._harvest_engines()


class SerialExecutor(DispatchExecutor):
    """Reference behaviour: every admit/tick materialises its sampled
    token immediately, blocking the host once per tick per wave."""

    name = "serial"
    defer = False


class OverlappedExecutor(DispatchExecutor):
    """Prefills and decode ticks for *all* shards are enqueued before
    anything blocks; tokens stay on the device and the host blocks at
    most once per wave per step, inside the batched harvest. (Separate
    CUDA streams per shard arrive with port slice A7.)"""

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
