"""Encoder-decoder transformer backbone (Seamless-M4T-v2 style, audio),
the reference's ``repro.models.encdec``.

The modality frontend (mel-spectrogram + conv feature extractor) is a
stub, as in the reference: the batch carries precomputed frame
embeddings ``frames`` (B, enc_seq_len, d_model). The encoder is a
bidirectional transformer; the decoder is causal with cross-attention.
The cross-attention K/V are computed once at prefill and cached (the
encoder length is fixed), so a decode step reads the self-attention ring
and the cached cross K/V.

The reference scans its stacked layer params; here a Python loop walks
the same ``L``-stacked tensors. Every attention is the plain
``attention`` (bidirectional ``causal=False`` in the encoder and in
cross-attention, blockwise online softmax where ``attn_chunk`` tiles the
keys), as the reference leaves it to XLA: its decode reaches no Pallas
kernel, so this family launches none of the port's kernels.

``decode`` writes every leaf it changes in place, as ``DecoderLM.decode``
does: the new self K/V at slot ``t % C`` of each layer, then ``pos`` and
``t``; ``xk`` / ``xv`` are only read. No host sync and no data-dependent
shape, so a decode step can be captured as a CUDA graph.

The reference never serves this family (its launcher swaps it for a
llama): an ``ExpertEngine`` prefill carries tokens only, and ``prefill``
raises ``KeyError`` without ``frames``, as the reference's does.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from ..sharding import shard_act
from ..sharding.context import (reduce_grad, reduce_sums,
                                unshard_batch_axes)
from .api import BaseModel, register_family
from .attention import (attention, cache_prefill, heads_whole, merge_heads,
                        ring_write)
from .common import (ArchConfig, apply_rope, dense_init, dt, embed_init,
                     embed_lookup, init_device, rmsnorm, softmax_xent,
                     stack_views)
from .dense import _ffn

BATCH = ("pod", "data")


def _init_attn(gen, cfg: ArchConfig, dtype, L: int) -> Dict:
    D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    return {
        "wq": dense_init(gen, (L, D, H * dh), dtype),
        "wk": dense_init(gen, (L, D, KV * dh), dtype),
        "wv": dense_init(gen, (L, D, KV * dh), dtype),
        "wo": dense_init(gen, (L, H * dh, D), dtype),
    }


def _init_enc_layers(gen, cfg: ArchConfig, dtype, L: int) -> Dict:
    D, Fd = cfg.d_model, cfg.d_ff
    ones = torch.ones((L, D), dtype=torch.float32, device=gen.device)
    return {
        "ln1": ones,
        "ln2": ones.clone(),
        "attn": _init_attn(gen, cfg, dtype, L),
        "mlp": {
            "w_gate": dense_init(gen, (L, D, Fd), dtype),
            "w_up": dense_init(gen, (L, D, Fd), dtype),
            "w_down": dense_init(gen, (L, Fd, D), dtype),
        },
    }


def _init_dec_layers(gen, cfg: ArchConfig, dtype, L: int) -> Dict:
    p = _init_enc_layers(gen, cfg, dtype, L)
    p["ln_x"] = torch.ones((L, cfg.d_model), dtype=torch.float32,
                           device=gen.device)
    p["xattn"] = _init_attn(gen, cfg, dtype, L)
    return p


def _mha(ap, xq, xkv, cfg: ArchConfig, *, q_pos, kv_pos, causal,
         rope_q=True, rope_k=True, chunk=0):
    """Projections, rope on q and/or k by flag, attention: (out, k, v)."""
    B, Sq, _ = xq.shape
    Sk = xkv.shape[1]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    q = heads_whole(xq @ ap["wq"], H).reshape(B, Sq, H, dh)
    k = heads_whole(xkv @ ap["wk"], KV).reshape(B, Sk, KV, dh)
    v = heads_whole(xkv @ ap["wv"], KV).reshape(B, Sk, KV, dh)
    if rope_q:
        q = apply_rope(q, q_pos, cfg.rope_theta)
    if rope_k:
        k = apply_rope(k, kv_pos, cfg.rope_theta)
    q = shard_act(q, (BATCH, None, "model", None))
    o = attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=causal,
                  chunk=chunk)
    return reduce_sums(merge_heads(o) @ ap["wo"]).to(xq.dtype), k, v


def _mlp(x, lp, cfg: ArchConfig):
    """The FFN block. Under a mesh the projections' inputs reduce their
    gradients (``reduce_grad``) and the output projection's sums are
    reduced before the residual (``reduce_sums``), as in the decoder-only
    layer."""
    h2 = reduce_grad(rmsnorm(x, lp["ln2"], cfg.norm_eps))
    y, _ = _ffn(h2, lp, cfg, dropless=True, with_aux=False)
    return x + reduce_sums(y).to(x.dtype)


def _enc_layer(x, lp, cfg: ArchConfig, positions):
    h = reduce_grad(rmsnorm(x, lp["ln1"], cfg.norm_eps))
    o, _, _ = _mha(lp["attn"], h, h, cfg, q_pos=positions, kv_pos=positions,
                   causal=False, chunk=cfg.attn_chunk)
    return _mlp(x + o, lp, cfg)


def _dec_layer_full(x, enc_out, lp, cfg: ArchConfig, positions,
                    enc_positions):
    """Full-sequence decoder layer: (x, (k, v, xk, xv))."""
    h = reduce_grad(rmsnorm(x, lp["ln1"], cfg.norm_eps))
    o, k, v = _mha(lp["attn"], h, h, cfg, q_pos=positions, kv_pos=positions,
                   causal=True, chunk=cfg.attn_chunk)
    x = x + o
    hx = reduce_grad(rmsnorm(x, lp["ln_x"], cfg.norm_eps))
    ox, xk, xv = _mha(lp["xattn"], hx, enc_out, cfg, q_pos=positions,
                      kv_pos=enc_positions, causal=False, rope_q=False,
                      rope_k=False, chunk=cfg.attn_chunk)
    return _mlp(x + ox, lp, cfg), (k, v, xk, xv)


def _arange(n, device):
    return torch.arange(n, dtype=torch.int32, device=device)


@register_family("encdec")
class EncDecLM(BaseModel):
    """Bidirectional encoder over stub frames, causal decoder with
    cross-attention; ring self-attention cache."""

    def init(self, generator, device=None):
        """Params from ``generator`` (a ``torch.Generator`` on the target
        device, or an int seed for one), with the reference's names and
        shapes. Runs on ``cuda`` unless ``device="cpu"``;
        ``device="meta"`` gives shapes only."""
        cfg = self.cfg
        dev, generator = init_device(generator, device)
        dtype = dt(cfg.param_dtype)
        return {
            "embed": embed_init(generator, (cfg.padded_vocab, cfg.d_model),
                                dtype),
            "enc_layers": _init_enc_layers(generator, cfg, dtype,
                                           cfg.n_enc_layers),
            "dec_layers": _init_dec_layers(generator, cfg, dtype,
                                           cfg.n_dec_layers),
            "ln_enc": torch.ones((cfg.d_model,), dtype=torch.float32,
                                 device=dev),
            "ln_f": torch.ones((cfg.d_model,), dtype=torch.float32,
                               device=dev),
            "unembed": dense_init(generator, (cfg.d_model, cfg.padded_vocab),
                                  dtype),
        }

    # ------------------------------------------------------------------
    def encode(self, params, frames, remat: bool = False):
        """frames (B, Se, D) -> encoder output (B, Se, D) in the compute
        dtype. With ``remat`` (the loss under ``cfg.remat``) each layer
        runs under ``torch.utils.checkpoint``."""
        cfg = self.cfg
        x = shard_act(frames.to(dt(cfg.compute_dtype)), (BATCH, None, None))
        positions = _arange(x.shape[1], x.device)
        for lp in stack_views(params["enc_layers"]):
            x = (checkpoint(_enc_layer, x, lp, cfg, positions,
                            use_reentrant=False) if remat
                 else _enc_layer(x, lp, cfg, positions))
        return reduce_grad(rmsnorm(x, params["ln_enc"], cfg.norm_eps))

    def _decode_full(self, params, enc_out, tokens, remat: bool = False):
        """Every decoder layer over the full sequence: (x after ``ln_f``,
        per-layer [(k, v, xk, xv)]; empty with ``remat``, where each layer
        runs under ``torch.utils.checkpoint``)."""
        cfg = self.cfg
        x = embed_lookup(params["embed"], tokens).to(dt(cfg.compute_dtype))
        x = shard_act(x, (BATCH, None, None))
        positions = _arange(x.shape[1], x.device)
        enc_positions = _arange(enc_out.shape[1], x.device)
        kvs = []
        for lp in stack_views(params["dec_layers"]):
            if remat:
                x = checkpoint(
                    lambda x, lp: _dec_layer_full(
                        x, enc_out, lp, cfg, positions, enc_positions)[0],
                    x, lp, use_reentrant=False)
            else:
                x, kv = _dec_layer_full(x, enc_out, lp, cfg, positions,
                                        enc_positions)
                kvs.append(kv)
        return rmsnorm(x, params["ln_f"], cfg.norm_eps), kvs

    def _unembed(self, params, x):
        return reduce_grad(x) @ unshard_batch_axes(
            params["unembed"]).to(x.dtype)

    def loss(self, params, batch):
        """Mean cross-entropy of batch {"frames", "tokens", "labels"} over
        the padded vocab, labels as given (no shift, as the reference):
        (ce, {"ce"}). Under ``cfg.remat`` every layer runs under
        ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``)."""
        remat = self.cfg.remat
        enc_out = self.encode(params, batch["frames"], remat=remat)
        x, _ = self._decode_full(params, enc_out, batch["tokens"], remat)
        ce = softmax_xent(self._unembed(params, x), batch["labels"])
        return ce, {"ce": ce}

    def input_shapes(self, sc):
        """The dry run's inputs on the ``meta`` device: stub ``frames`` (B,
        enc_seq_len, d_model) with the tokens of a train or prefill step,
        one token a row to decode."""
        cfg = self.cfg
        B, S = sc.global_batch, sc.seq_len

        def f(*shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device="meta")

        frames = f(B, cfg.enc_seq_len, cfg.d_model,
                   dtype=dt(cfg.compute_dtype))
        if sc.mode == "train":
            return {"frames": frames, "tokens": f(B, S), "labels": f(B, S)}
        if sc.mode == "prefill":
            return {"frames": frames, "tokens": f(B, S)}
        return {"token": f(B, 1)}

    # ------------------------------------------------------------------
    def init_cache(self, batch_size, capacity, device=None):
        """Zeroed {k, v (L, B, C, KV, dh); xk, xv (L, B, enc_seq_len, KV,
        dh); pos (C,) = -1; t ()}, K/V in the compute dtype."""
        cfg = self.cfg
        L, Se = cfg.n_dec_layers, cfg.enc_seq_len
        KV, dh = cfg.n_kv_heads, cfg.dh
        cdt = dt(cfg.compute_dtype)

        def zeros(S):
            return torch.zeros((L, batch_size, S, KV, dh), dtype=cdt,
                               device=device)

        return {"k": zeros(capacity), "v": zeros(capacity), "xk": zeros(Se),
                "xv": zeros(Se),
                "pos": torch.full((capacity,), -1, dtype=torch.int32,
                                  device=device),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def prefill(self, params, batch, capacity=None):
        """batch {"frames": (B, Se, D), "tokens": (B, S)} -> (last-position
        logits (B, Vp), cache as ``init_cache`` with the prompt's self K/V
        written, the cross K/V of every layer and t = S)."""
        if "frames" not in batch:
            raise KeyError(
                "frames: the encoder-decoder prefills from stub frame "
                "embeddings (B, enc_seq_len, d_model) and tokens; a "
                "token-only batch (the serving path's) cannot feed it")
        cfg = self.cfg
        cdt = dt(cfg.compute_dtype)
        enc_out = self.encode(params, batch["frames"])
        x, kvs = self._decode_full(params, enc_out, batch["tokens"])
        logits = self._unembed(params, x[:, -1])
        B, S = batch["tokens"].shape
        C = capacity or self.cache_capacity(S)
        cache = self.new_cache(B, C, like=x)
        for key, j in (("xk", 2), ("xv", 3)):
            cache[key].copy_(torch.stack([a[j] for a in kvs]).to(cdt))
        # writes the ring's K/V in place and sets pos and t
        cache_prefill(cache, torch.stack([a[0] for a in kvs]),
                      torch.stack([a[1] for a in kvs]))
        return logits, cache

    def decode(self, params, cache, batch):
        """batch {"token": (B, 1)} -> (logits (B, Vp), cache updated in
        place). Self-attention over the ring at ``q_pos = t``; the
        cross-attention attends to every encoder position, unmasked
        (``causal=False``: t is smaller than most encoder positions)."""
        cfg = self.cfg
        x = embed_lookup(params["embed"], batch["token"]).to(
            dt(cfg.compute_dtype))
        B = x.shape[0]
        H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
        t = cache["t"]
        q_pos = t.reshape(1)
        C = cache["k"].shape[2]
        slot = (t % C).reshape(1).long()
        kv_pos = cache["pos"].index_copy(0, slot, q_pos)
        enc_positions = _arange(cache["xk"].shape[2], x.device)
        for i, lp in enumerate(stack_views(params["dec_layers"])):
            ck, cv = cache["k"][i], cache["v"][i]
            h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
            ap = lp["attn"]
            q = apply_rope(heads_whole(h @ ap["wq"], H).reshape(B, 1, H, dh),
                           q_pos, cfg.rope_theta)
            k1 = apply_rope(heads_whole(h @ ap["wk"], KV).reshape(
                B, 1, KV, dh), q_pos, cfg.rope_theta)
            v1 = heads_whole(h @ ap["wv"], KV).reshape(B, 1, KV, dh)
            ring_write(ck, cv, k1, v1, slot)
            o = attention(q, ck, cv, q_pos=q_pos, kv_pos=kv_pos)
            x = x + (o.reshape(B, 1, H * dh) @ ap["wo"]).to(x.dtype)
            hx = rmsnorm(x, lp["ln_x"], cfg.norm_eps)
            xp = lp["xattn"]
            qx = heads_whole(hx @ xp["wq"], H).reshape(B, 1, H, dh)
            ox = attention(qx, cache["xk"][i], cache["xv"][i], q_pos=q_pos,
                           kv_pos=enc_positions, causal=False)
            x = x + (ox.reshape(B, 1, H * dh) @ xp["wo"]).to(x.dtype)
            x = _mlp(x, lp, cfg)
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        logits = self._unembed(params, x[:, 0])
        # in place, as every leaf: a captured step replays on these buffers
        cache["pos"].copy_(kv_pos)
        t.add_(1)
        return logits, cache
