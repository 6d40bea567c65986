"""Decoder-only transformer, dense family (llama/qwen-style GQA).

The reference's ``DecoderLM`` scans stacked layer params; here a Python
loop walks the same ``L``-stacked tensors (``unbind`` gives per-layer
views, no copies). Projections and the FFN are plain ``x @ w`` matmuls,
as the reference leaves them to XLA; prefill attention is plain PyTorch;
each decode layer launches the hand-written ``decode_attention`` kernel
on its updated ring cache, with ``q_pos = t`` shared across rows.

Decode updates the KV cache in place (the reference returns a new
cache; the port writes the one slot per layer into the existing buffers
and returns the same dict), so a wave's cache is allocated once.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels.decode_attention import decode_attention
from .api import BaseModel, register_family
from .attention import attention, cache_prefill, init_kv_cache
from .common import (ArchConfig, apply_rope, dense_init, dt, embed_init,
                     rmsnorm)


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
    p["mlp"] = {
        "w_gate": dense_init(gen, (L, D, Fd), dtype),
        "w_up": dense_init(gen, (L, D, Fd), dtype),
        "w_down": dense_init(gen, (L, Fd, D), dtype),
    }
    return p


def _layer_views(params) -> List[Dict]:
    """Per-layer views of the L-stacked layer params."""
    lay = params["layers"]
    flat = {k: v.unbind(0) for k, v in lay.items() if k != "mlp"}
    mlp = {k: v.unbind(0) for k, v in lay["mlp"].items()}
    L = len(flat["wq"])
    return [dict({k: v[i] for k, v in flat.items()},
                 mlp={k: v[i] for k, v in mlp.items()}) for i in range(L)]


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
    q = apply_rope(q.reshape(B, S, H, dh), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, KV, dh), positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, KV, dh)


def _ffn(h, lp):
    mp = lp["mlp"]
    g = F.silu(h @ mp["w_gate"])
    u = h @ mp["w_up"]
    return (g * u) @ mp["w_down"]


def _layer_full(x, lp, cfg: ArchConfig, positions):
    """Full-sequence layer (prefill). Returns (x, (k, v))."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(h, lp, cfg, positions)
    o = attention(q, k, v, q_pos=positions, kv_pos=positions,
                  window=cfg.sliding_window, chunk=cfg.attn_chunk)
    B, S = x.shape[:2]
    x = x + (o.reshape(B, S, -1) @ lp["wo"]).to(x.dtype)
    h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    x = x + _ffn(h2, lp).to(x.dtype)
    return x, (k, v)


def _layer_decode(x, lp, ck, cv, slot, t, kv_pos, cfg: ArchConfig):
    """Single-token layer. ck/cv: this layer's (B, C, KV, dh) ring cache,
    written in place at ``slot``; t: () query position shared by rows;
    kv_pos: (C,) slot positions after the write."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k1, v1 = _qkv(h, lp, cfg, t.reshape(1))
    ck.index_copy_(1, slot, k1.to(ck.dtype))
    cv.index_copy_(1, slot, v1.to(cv.dtype))
    o = decode_attention(q[:, 0], ck, cv, t, kv_pos,
                         window=cfg.sliding_window)         # (B, H, dh)
    B = x.shape[0]
    x = x + (o.reshape(B, 1, -1) @ lp["wo"]).to(x.dtype)
    h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + _ffn(h2, lp).to(x.dtype)


@register_family("dense")
class DecoderLM(BaseModel):
    """Dense decoder-only LM (MoE and VLM backbones arrive with A10)."""

    def init(self, generator, device=None):
        """Params from ``generator`` (a ``torch.Generator`` on the target
        device, or an int seed for one). Runs on ``cuda`` unless
        ``device="cpu"``."""
        cfg = self.cfg
        dev = resolve_device(device)
        if isinstance(generator, int):
            generator = torch.Generator(device=dev).manual_seed(generator)
        if generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, params "
                             f"asked for on {dev}")
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
        cfg = self.cfg
        if cfg.n_stub_embeds:
            raise NotImplementedError(
                "VLM stub embeds arrive with port slice A10")
        return params["embed"][batch["tokens"].long()].to(
            dt(cfg.compute_dtype))

    def _unembed(self, params, x):
        w = (params["embed"].T if self.cfg.tie_embeddings
             else params["unembed"])
        return x @ w.to(x.dtype)

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

    def prefill(self, params, batch, capacity=None):
        """batch {"tokens": (B, S)} -> (last-position logits (B, Vp),
        cache {k, v: (L, B, C, KV, dh), pos (C,), t ()})."""
        cfg = self.cfg
        x = self._embed(params, batch)
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        ks, vs = [], []
        for lp in _layer_views(params):
            x, (k, v) = _layer_full(x, lp, cfg, positions)
            ks.append(k)
            vs.append(v)
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        logits = self._unembed(params, x[:, -1])
        C = capacity or self.cache_capacity(S)
        cache = self.init_cache(B, C, device=x.device)
        cache_prefill(cache, torch.stack(ks), torch.stack(vs))
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
        for i, lp in enumerate(_layer_views(params)):
            x = _layer_decode(x, lp, cache["k"][i], cache["v"][i], slot, t,
                              kv_pos, cfg)
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        logits = self._unembed(params, x[:, 0])
        cache["pos"] = kv_pos
        cache["t"] = t + 1
        return logits, cache
