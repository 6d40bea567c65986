"""Decoder-only transformer: dense (llama/qwen-style GQA), MoE
(mixtral/olmoe, ``models/moe.py``) and the VLM backbone (stub patch
embeddings prepended), the reference's one ``DecoderLM``.

The reference's ``DecoderLM`` scans stacked layer params; here a Python
loop walks the same ``L``-stacked tensors (``unbind`` gives per-layer
views, no copies). Projections and the FFN are plain ``x @ w`` matmuls,
as the reference leaves them to XLA; prefill attention is plain PyTorch;
each decode layer launches the hand-written ``decode_attention`` kernel
on its updated ring cache, with ``q_pos = t`` shared across rows.

Decode updates the KV cache in place (the reference returns a new
cache; the port writes the one slot per layer into the existing buffers,
advances ``pos`` and ``t`` in their own storage and returns the same
dict), so a wave's cache is allocated once and a captured decode step
(``serve/graphs.py``) replays on the same buffers.

The paged protocol keeps the reference's pool layout ``(P1, L, page, KV,
dh)``. Paged prefills scatter whole pages into the pool in place; each
paged decode layer writes its new K/V slot through the table column and
then launches ``paged_decode_attention`` on that layer's strided view of
the pool — the reference gathers a dense per-row copy instead.

``verify`` (speculative decoding) scores a (B, k+1) draft window per
row in one pass: every layer writes all k+1 K/V slots into the ring at
each row's own positions, then attends through the plain ``attention``
with per-row ``q_pos`` (B, k+1) and ``kv_pos`` (B, C), as the reference
does — neither decode kernel takes per-row positions or more than one
query a row. ``paged_verify`` gathers each row's dense view, runs
``verify`` on it and scatters the written slots back into the pool.

``loss`` (training) runs prefill's full-sequence layers over every
position, each under ``torch.utils.checkpoint`` where ``cfg.remat`` is
set, and the cross-entropy over the padded vocab (text positions only
where ``cfg.n_stub_embeds`` is set), plus the MoE balance loss.

MoE layers follow the reference's ``dropless`` per call site: full and
suffix (chunked) prefill drop tokens past an expert's capacity, decode
and verify do not. A capacity-dispatch prefill's output depends on the
whole padded call, so for such a model a paged (chunked) or
prefix-cached prefill gives other logits than a ring one, as the
reference's does.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.decode_attention import decode_attention
from ..kernels.paged_decode_attention import paged_decode_attention
from ..sharding import shard_act
from ..sharding.context import (reduce_grad, reduce_sums,
                                unshard_batch_axes)
from .api import BaseModel, register_family
from .attention import (attention, cache_prefill, heads_whole,
                        init_kv_cache, last_writer, merge_heads, paged_append,
                        paged_append_rows, paged_gather, paged_scatter_pages,
                        ring_write, suffix_attend)
from .common import (ArchConfig, ShapeConfig, apply_rope, dense_init, dt,
                     embed_init, embed_lookup, init_device, rmsnorm,
                     softmax_xent, stack_views)
from .moe import init_moe, moe_ffn

BATCH = ("pod", "data")


def _init_layers(gen: torch.Generator, cfg: ArchConfig, dtype) -> Dict:
    L = cfg.n_layers
    D, H, KV, dh, Fd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh,
                        cfg.d_ff)
    dev = gen.device
    p = {
        "ln1": torch.ones((L, D), dtype=torch.float32, device=dev),
        "ln2": torch.ones((L, D), dtype=torch.float32, device=dev),
        "wq": dense_init(gen, (L, D, H * dh), dtype),
        "wk": dense_init(gen, (L, D, KV * dh), dtype),
        "wv": dense_init(gen, (L, D, KV * dh), dtype),
        "wo": dense_init(gen, (L, H * dh, D), dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((L, H * dh), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((L, KV * dh), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((L, KV * dh), dtype=dtype, device=dev)
    if cfg.n_experts:
        p["moe"] = init_moe(gen, cfg, dtype, L)
    else:
        p["mlp"] = {
            "w_gate": dense_init(gen, (L, D, Fd), dtype),
            "w_up": dense_init(gen, (L, D, Fd), dtype),
            "w_down": dense_init(gen, (L, Fd, D), dtype),
        }
    return p


def _qkv(h, lp, cfg: ArchConfig, positions):
    B, S, _ = h.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    q = h @ lp["wq"]
    k = h @ lp["wk"]
    v = h @ lp["wv"]
    if cfg.qkv_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    # under a mesh, whole heads before the reshape: K and V are gathered
    # over `model` where it does not divide the KV heads (Q stays split)
    q, k, v = heads_whole(q, H), heads_whole(k, KV), heads_whole(v, KV)
    q = apply_rope(q.reshape(B, S, H, dh), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, KV, dh), positions, cfg.rope_theta)
    q = shard_act(q, (BATCH, None, "model", None))
    k = shard_act(k, (BATCH, None, "model", None))
    return q, k, v.reshape(B, S, KV, dh)


def _ffn(h, lp, cfg: ArchConfig, dropless: bool, with_aux: bool = True):
    """The layer's FFN: (y, aux). MoE layers route (``dropless`` sets
    capacity = T) and give their balance loss, or None without
    ``with_aux``; a dense SwiGLU has none (None)."""
    if cfg.n_experts:
        return moe_ffn(lp["moe"], h, cfg, dropless, with_aux)
    mp = lp["mlp"]
    g = F.silu(h @ mp["w_gate"])
    u = h @ mp["w_up"]
    return (g * u) @ mp["w_down"], None


def _layer_full(x, lp, cfg: ArchConfig, positions):
    """Full-sequence layer (train / prefill). Returns (x, (k, v), aux);
    aux is None for a dense layer. Each projection's input reduces its
    gradient over the split heads or columns (``reduce_grad``)."""
    h = reduce_grad(rmsnorm(x, lp["ln1"], cfg.norm_eps))
    q, k, v = _qkv(h, lp, cfg, positions)
    o = attention(q, k, v, q_pos=positions, kv_pos=positions,
                  window=cfg.sliding_window, chunk=cfg.attn_chunk)
    B, S = x.shape[:2]
    # the output projection's sums reduced before the residual: DTensor
    # would otherwise reduce-scatter them over the sequence
    x = x + reduce_sums(merge_heads(o) @ lp["wo"]).to(x.dtype)
    h2 = reduce_grad(rmsnorm(x, lp["ln2"], cfg.norm_eps))
    y, aux = _ffn(h2, lp, cfg, dropless=False)
    # sequence parallelism: between TP blocks the residual stream is
    # sharded along seq over `model` (Korthikanti et al.)
    x = shard_act(x + y.to(x.dtype),
                  (BATCH, "model" if cfg.seq_parallel else None, None))
    return x, (k, v), aux


def _layer_suffix(x, lp, cfg: ArchConfig, positions, pk, pv, offset):
    """Suffix-prefill layer: queries at absolute ``positions`` attend over
    the gathered prefix KV (positions 0..offset-1) plus the suffix's own
    KV. Returns (x, (k, v)) where k, v cover only the suffix slice."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(h, lp, cfg, positions)
    o = suffix_attend(q, k, v, pk, pv, offset=offset,
                      window=cfg.sliding_window, chunk=cfg.attn_chunk)
    B, S = x.shape[:2]
    x = x + (merge_heads(o) @ lp["wo"]).to(x.dtype)
    h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    y, _ = _ffn(h2, lp, cfg, dropless=False, with_aux=False)
    x = shard_act(x + y.to(x.dtype),
                  (BATCH, "model" if cfg.seq_parallel else None, None))
    return x, (k, v)


def _layer_decode(x, lp, t, cfg: ArchConfig, write_attend):
    """Single-token layer; t: () query position shared by rows.
    ``write_attend(q (B, H, dh), k1, v1 (B, 1, KV, dh))`` writes the new
    slot into the layer's cache in place and returns the attention
    output (B, H, dh)."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k1, v1 = _qkv(h, lp, cfg, t.reshape(1))
    o = write_attend(q[:, 0], k1, v1)
    B = x.shape[0]
    # the projections' sums reduced before the residual: a pending sum
    # met at the next projection makes DTensor gather its weights
    x = x + reduce_sums(o.reshape(B, 1, -1) @ lp["wo"]).to(x.dtype)
    h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    y, _ = _ffn(h2, lp, cfg, dropless=True, with_aux=False)
    return x + reduce_sums(y).to(x.dtype)


def _layer_verify(x, lp, cfg: ArchConfig, q_pos, write):
    """Speculative-verify layer over a (B, K1) window; ``q_pos`` (B, K1)
    per-row absolute positions. ``write(k1, v1)`` lands the whole
    window's K/V in the layer's cache in place and returns (k cache, v
    cache, kv_pos (B, C)); attention then masks each query to
    ``kv_pos <= q_pos``, exactly the keys a chained one-token decode
    would have seen."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k1, v1 = _qkv(h, lp, cfg, q_pos)
    ck, cv, kv_pos = write(k1, v1)
    o = attention(q, ck, cv, q_pos=q_pos, kv_pos=kv_pos,
                  window=cfg.sliding_window, chunk=0)
    B, S = x.shape[:2]
    x = x + (merge_heads(o) @ lp["wo"]).to(x.dtype)
    h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    y, _ = _ffn(h2, lp, cfg, dropless=True, with_aux=False)
    return x + y.to(x.dtype)


@register_family("dense")
@register_family("moe")
@register_family("vlm")
class DecoderLM(BaseModel):
    """Dense / MoE / VLM-backbone decoder-only LM."""

    def init(self, generator, device=None):
        """Params from ``generator`` (a ``torch.Generator`` on the target
        device, or an int seed for one). Runs on ``cuda`` unless
        ``device="cpu"``; ``device="meta"`` gives shapes only."""
        cfg = self.cfg
        dev, generator = init_device(generator, device)
        dtype = dt(cfg.param_dtype)
        params = {
            "embed": embed_init(generator, (cfg.padded_vocab, cfg.d_model),
                                dtype),
            "layers": _init_layers(generator, cfg, dtype),
            "ln_f": torch.ones((cfg.d_model,), dtype=torch.float32,
                               device=dev),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = dense_init(
                generator, (cfg.d_model, cfg.padded_vocab), dtype)
        return params

    # ------------------------------------------------------------------
    def _embed(self, params, batch):
        """Token embeddings in the compute dtype, with ``stub_embeds``
        (B, n_stub_embeds, D) prepended where the config has stubs and
        the batch carries them (a VLM prefill; decode feeds tokens only)."""
        cfg = self.cfg
        x = embed_lookup(params["embed"], batch["tokens"]).to(
            dt(cfg.compute_dtype))
        if cfg.n_stub_embeds and "stub_embeds" in batch:
            x = torch.cat([batch["stub_embeds"].to(x.dtype), x], dim=1)
        return shard_act(x, (BATCH, "model" if cfg.seq_parallel else None,
                             None))

    def _unembed(self, params, x):
        w = (params["embed"].T if self.cfg.tie_embeddings
             else params["unembed"])
        return x @ unshard_batch_axes(w).to(x.dtype)

    # ------------------------------------------------------------------
    def loss(self, params, batch):
        """Mean next-token cross-entropy of batch {"tokens", "labels"} (B,
        S) (and ``stub_embeds`` for a VLM) over the padded vocab, through
        prefill's full-sequence layers: (total, {"ce", "aux"}). Where
        ``cfg.remat`` is set each layer runs under
        ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``):
        only its input is kept for the backward pass, which recomputes
        the rest. ``aux`` is the MoE balance loss summed over layers (0
        for dense layers); ``total = ce + 0.01 * aux / n_layers``. With
        ``cfg.n_stub_embeds`` set only the text positions are scored:
        the first ``n_stub_embeds`` are cut whether or not the batch
        carries stubs, as the reference cuts them."""
        cfg = self.cfg
        x = self._embed(params, batch)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)

        def layer(x, lp):
            x, _, a = _layer_full(x, lp, cfg, positions)
            return x, a

        aux = x.new_zeros((), dtype=torch.float32)
        for lp in stack_views(params["layers"]):
            x, a = (checkpoint(layer, x, lp, use_reentrant=False)
                    if cfg.remat else layer(x, lp))
            if a is not None:
                aux = aux + a
        x = reduce_grad(rmsnorm(x, params["ln_f"], cfg.norm_eps))
        if cfg.n_stub_embeds:
            x = x[:, cfg.n_stub_embeds:]
        ce = softmax_xent(self._unembed(params, x), batch["labels"])
        total = ce + 0.01 * aux / max(cfg.n_layers, 1)
        return total, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------------
    def init_cache(self, batch_size, capacity, device=None):
        cfg = self.cfg
        c = init_kv_cache(batch_size, capacity, cfg.n_kv_heads, cfg.dh,
                          dt(cfg.compute_dtype), device=device)
        L = cfg.n_layers
        return {
            "k": c["k"].new_zeros((L,) + tuple(c["k"].shape)),
            "v": c["v"].new_zeros((L,) + tuple(c["v"].shape)),
            "pos": c["pos"],
            "t": c["t"],
        }

    def _prefill_layers(self, params, batch):
        """All layers over the full prompt (stubs first, where given):
        (last-position logits (B, Vp), per-layer [(k, v)] each (B, S, KV,
        dh))."""
        cfg = self.cfg
        x = self._embed(params, batch)
        S = x.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        kvs = []
        for lp in stack_views(params["layers"]):
            x, kv, _ = _layer_full(x, lp, cfg, positions)
            kvs.append(kv)
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        return self._unembed(params, x[:, -1]), kvs

    def prefill(self, params, batch, capacity=None):
        """batch {"tokens": (B, S)} (and a VLM's ``stub_embeds``, whose
        positions come first and count) -> (last-position logits (B,
        Vp), cache {k, v: (L, B, C, KV, dh), pos (C,), t ()})."""
        logits, kvs = self._prefill_layers(params, batch)
        B, S = kvs[0][0].shape[:2]
        C = capacity or self.cache_capacity(S)
        cache = self.new_cache(B, C, like=logits)
        cache_prefill(cache, torch.stack([k for k, _ in kvs]),
                      torch.stack([v for _, v in kvs]))
        return logits, cache

    def decode(self, params, cache, batch):
        """batch {"token": (B, 1)} -> (logits (B, Vp), cache updated in
        place: slot ``t % C`` of every layer written, pos/t advanced)."""
        cfg = self.cfg
        x = self._embed(params, {"tokens": batch["token"]})
        t = cache["t"]
        C = cache["k"].shape[2]
        slot = (t % C).reshape(1).long()
        kv_pos = cache["pos"].index_copy(0, slot, t.reshape(1))
        for i, lp in enumerate(stack_views(params["layers"])):
            ck, cv = cache["k"][i], cache["v"][i]

            def write_attend(q, k1, v1, ck=ck, cv=cv):
                ring_write(ck, cv, k1, v1, slot)
                return decode_attention(q, ck, cv, t, kv_pos,
                                        window=cfg.sliding_window)

            x = _layer_decode(x, lp, t, cfg, write_attend)
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        logits = self._unembed(params, x[:, 0])
        # in place, as every leaf: a captured step replays on these buffers
        cache["pos"].copy_(kv_pos)
        t.add_(1)
        return logits, cache

    def input_shapes(self, sc: ShapeConfig):
        """Token inputs on the ``meta`` device; a VLM's ``stub_embeds`` (B,
        n_stub_embeds, D) take the first positions of the sequence, and
        the tokens the rest."""
        cfg = self.cfg
        if not cfg.n_stub_embeds:
            return super().input_shapes(sc)
        B, S = sc.global_batch, sc.seq_len
        n_txt = S - cfg.n_stub_embeds

        def f(*shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device="meta")

        stub = f(B, cfg.n_stub_embeds, cfg.d_model,
                 dtype=dt(cfg.compute_dtype))
        if sc.mode == "train":
            return {"tokens": f(B, n_txt), "labels": f(B, n_txt),
                    "stub_embeds": stub}
        if sc.mode == "prefill":
            return {"tokens": f(B, n_txt), "stub_embeds": stub}
        return {"token": f(B, 1)}

    # ------------------------------------------------------------------
    # Speculative verify. Exactness: all K+1 keys/values land in the
    # cache at their absolute positions before attention, and the per-row
    # mask (0 <= kv_pos <= q_pos_i) gives query i exactly the key set a
    # chained one-token decode would have seen; a masked slot's softmax
    # weight is exactly 0 in f32, and its (finite) stale K/V adds 0.
    # ------------------------------------------------------------------
    @property
    def supports_verify(self) -> bool:
        return True

    def verify(self, params, cache, pos, t, batch):
        """Score a K+1 token window per row against the model.

        cache: {"k", "v"} (L, B, C, KV, dh) ring buffers, written in
        place; pos: (B, C) int32 per-row slot positions (-1 empty); t:
        (B,) int32 per-row next write position; batch: {"tokens": (B,
        K+1)}, the last emitted token and K draft proposals. Returns
        (greedy (B, K+1) int32, cache): greedy[:, i] is the argmax after
        window token i. Slots t .. t+K of every row are written
        optimistically (the caller guarantees they hold pos == -1 and
        rolls ``pos`` back over the rejected suffix); ``pos`` and ``t``
        are only read. Token ids past the embedding's last row (a draft
        may propose the id ``padded_vocab``) are clamped to it, as the
        reference's gather clamps them."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, K1 = tokens.shape
        C = cache["k"].shape[2]
        dev = tokens.device
        rows = torch.arange(B, device=dev)[:, None]                # (B, 1)
        offs = t[:, None] + torch.arange(K1, dtype=t.dtype,
                                         device=dev)[None, :]     # (B, K1)
        slots = (offs % C).long()
        kv_pos = pos.scatter(1, slots, offs)
        last = params["embed"].shape[0] - 1
        x = self._embed(params, {"tokens": tokens.clamp(0, last)})
        for i, lp in enumerate(stack_views(params["layers"])):
            ck, cv = cache["k"][i], cache["v"][i]

            def write(k1, v1, ck=ck, cv=cv):
                # (row, slot) pairs are distinct: K1 <= C
                ck.index_put_((rows, slots), k1.to(ck.dtype))
                cv.index_put_((rows, slots), v1.to(cv.dtype))
                return ck, cv, kv_pos

            x = _layer_verify(x, lp, cfg, offs, write)
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        logits = self._unembed(params, x)                          # (B, K1, V)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    def paged_verify(self, params, pool, table, pos, t, batch, *, page):
        """Paged verify, as the reference's: gather each row's dense view
        of every layer through its page table, run ``verify`` on it, and
        scatter the K+1 written slots back into the pool in place
        (``paged_append_rows``). table: (B, n_lp) int32; pos (B, C); t
        (B,). Returns (greedy (B, K+1) int32, pool)."""
        tokens = batch["tokens"]
        B, K1 = tokens.shape
        C = table.shape[1] * page
        L = self.cfg.n_layers
        views = [paged_gather(pool["k"][:, i], pool["v"][:, i], table)
                 for i in range(L)]
        gk = torch.stack([k for k, _ in views])
        gv = torch.stack([v for _, v in views])
        del views
        greedy, _ = self.verify(params, {"k": gk, "v": gv}, pos, t, batch)
        dev = tokens.device
        slots = (t[:, None] + torch.arange(K1, dtype=t.dtype,
                                           device=dev)[None, :]) % C
        slots = slots.long()
        tbl_cols = table.gather(1, slots // page)
        offs = slots % page
        rows = torch.arange(B, device=dev)[:, None]
        for i in range(L):
            paged_append_rows(pool["k"][:, i], pool["v"][:, i], tbl_cols,
                              offs, gk[i][rows, slots], gv[i][rows, slots])
        return greedy, pool

    # ------------------------------------------------------------------
    # Paged KV cache protocol. Pools are {k, v: (P1, L, page, KV, dh)}:
    # the page index leads, so one copy-on-write moves a page for every
    # layer, and layer i's view pool[:, i] is a (P1, page, KV, dh) tensor
    # whose page axis is strided. Every method writes the pool in place
    # and returns the same dict.
    # ------------------------------------------------------------------
    @property
    def supports_paged_kv(self) -> bool:
        # stub-embed (VLM) prefills prepend non-token positions, so the
        # prompt page <-> token page correspondence breaks
        return not self.cfg.n_stub_embeds

    def init_paged_pool(self, n_pages, page, device=None):
        """Zeroed {k, v: (n_pages + 1, L, page, KV, dh)}; the last page is
        the trash page. Zeros, not empty: padding rows read the trash
        page as live slots and their (discarded) outputs must be finite."""
        cfg = self.cfg
        shape = (n_pages + 1, cfg.n_layers, page, cfg.n_kv_heads, cfg.dh)
        cdt = dt(cfg.compute_dtype)
        return {"k": torch.zeros(shape, dtype=cdt, device=device),
                "v": torch.zeros(shape, dtype=cdt, device=device)}

    def paged_prefill(self, params, batch, pool, scatter_tbl, *, page,
                      capacity):
        """Prefill + page scatter. scatter_tbl: (B, S // page) physical
        destination pages (trash for rows whose compute is discarded).
        Returns (logits, pool, pos (capacity,), t ())."""
        logits, kvs = self._prefill_layers(params, batch)
        for i, (k, v) in enumerate(kvs):
            paged_scatter_pages(pool["k"][:, i], pool["v"][:, i],
                                scatter_tbl, k, v)
        S = batch["tokens"].shape[1]
        dev = logits.device
        ar = torch.arange(capacity, dtype=torch.int32, device=dev)
        pos = torch.where(ar < S, ar, torch.full_like(ar, -1))
        return logits, pool, pos, torch.full((), S, dtype=torch.int32,
                                             device=dev)

    def paged_prefill_suffix(self, params, batch, pool, prefix_tbl,
                             scatter_tbl, *, offset, page):
        """Compute-shared suffix prefill: attend over the cached prefix KV
        (gathered through ``prefix_tbl``, (B, offset // page)) and compute
        only the suffix tokens at absolute positions offset..offset+Ssuf-1,
        then scatter the suffix KV into pool pages via ``scatter_tbl``
        (B, Ssuf // page). Returns (logits, pool); the logits are the last
        suffix position's, as a monolithic prefill would give them."""
        cfg = self.cfg
        x = self._embed(params, batch)
        Ssuf = x.shape[1]
        positions = torch.arange(offset, offset + Ssuf, dtype=torch.int32,
                                 device=x.device)
        kvs = []
        for i, lp in enumerate(stack_views(params["layers"])):
            # the suffix's own pages are written after every layer ran,
            # so each layer reads the prefix as the call found it
            pk, pv = paged_gather(pool["k"][:, i], pool["v"][:, i],
                                  prefix_tbl)
            x, kv = _layer_suffix(x, lp, cfg, positions, pk, pv, offset)
            kvs.append(kv)
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        logits = self._unembed(params, x[:, -1])
        for i, (k, v) in enumerate(kvs):
            paged_scatter_pages(pool["k"][:, i], pool["v"][:, i],
                                scatter_tbl, k, v)
        return logits, pool

    def paged_decode(self, params, pool, table, pos, t, batch, *, page):
        """One decode step through the page table, without a gather: each
        layer writes its new K/V slot in place at (table column, in-page
        offset) and launches ``paged_decode_attention`` on its view of the
        pool. table: (B, n_lp) int32; pos (C,); t (). Returns (logits,
        pool, pos', t')."""
        cfg = self.cfg
        x = self._embed(params, {"tokens": batch["token"]})
        C = table.shape[1] * page
        slot = (t % C).reshape(1).long()
        kv_pos = pos.index_copy(0, slot, t.reshape(1))
        tbl_col = table.index_select(1, slot // page)[:, 0]
        off = slot[0] % page
        # padding rows meet on the trash page: the last one's write lands
        rows = last_writer(tbl_col, pool["k"].shape[0])
        for i, lp in enumerate(stack_views(params["layers"])):
            kp, vp = pool["k"][:, i], pool["v"][:, i]

            def write_attend(q, k1, v1, kp=kp, vp=vp):
                paged_append(kp, vp, tbl_col, off, k1[rows], v1[rows])
                return paged_decode_attention(q, kp, vp, table, t, kv_pos,
                                              window=cfg.sliding_window)

            x = _layer_decode(x, lp, t, cfg, write_attend)
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        logits = self._unembed(params, x[:, 0])
        return logits, pool, kv_pos, t + 1
