"""Plain reference of the port's decoder-only LM (dense GQA and top-k MoE):
one full causal forward over each sequence in float32, layer by layer,
from the benchmark's own weights.

What it computes, in the port's layouts (weights ``(in, out)``, layer
stacks on a leading axis):

    x = embed[tokens]
    per layer:  h = rmsnorm(x) * ln1
                q, k, v = h wq, h wk, h wv   (+ biases where the file sets
                                              qkv_bias); RoPE on q and k,
                                              split halves, theta from the file
                x += softmax(q k^T / sqrt(dh), causal) v  wo
                h = rmsnorm(x) * ln2
                x += FFN(h)
    logits = (rmsnorm(x) * ln_f) unembed

FFN: SwiGLU, ``silu(h w_gate) * (h w_up) w_down``. MoE: router logits
``h router`` in f32, softmax over the experts, the first ``k`` of a
stable descending sort, their weights renormalised to sum 1, and the
SwiGLU of each chosen expert weighted and summed: every token reaches
its k experts (OLMoE as published is dropless).

Departures from OLMoE as published (arXiv:2409.02060), which the port
shares and so the reference follows: no QK-norm, and the top-k weights
renormalised (OLMoE's ``norm_topk_prob`` is false).

``weight`` turns a stored weight into the matrix the reference
multiplies by: float32 for the reference, a lower precision for the
control (``quantize_fp8``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F


def as_f32(w: torch.Tensor) -> torch.Tensor:
    return w.float()


def quantize_fp8(w: torch.Tensor) -> torch.Tensor:
    """``w`` rounded to float8 e4m3 with one scale a tensor (amax / 448),
    back in float32: the control's weights."""
    w = w.float()
    s = w.abs().amax().clamp(min=1e-30) / 448.0
    return (w / s).to(torch.float8_e4m3fn).float() * s


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, pos, theta):
    """x (T, H, dh), pos (T,): split-halves rotation."""
    dh = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                        device=x.device) / dh))
    ang = pos[:, None].float() * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v):
    """Causal GQA: q (T, H, dh), k/v (T, KV, dh) -> (T, H * dh)."""
    T, H, dh = q.shape
    g = H // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / float(dh) ** 0.5
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v).reshape(T, -1)


def moe(h, lw, cfg, weight):
    """Top-k MoE over h (N, D): every token through its k experts."""
    E, k = cfg["n_experts"], cfg["experts_per_token"]
    probs = torch.softmax(h @ lw["router"].float(), dim=-1)
    ids = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
    w = probs.gather(1, ids)
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    y = torch.zeros_like(h)
    for e in range(E):
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        if not len(tok):
            continue
        he = h[tok]
        out = (F.silu(he @ weight(lw["w_gate"][e]))
               * (he @ weight(lw["w_up"][e]))) @ weight(lw["w_down"][e])
        y.index_add_(0, tok, out * w[tok, slot][:, None])
    return y


def forward(params: Dict, cfg: Dict, seqs: Sequence[torch.Tensor],
            need_from: Sequence[int],
            weight: Callable[[torch.Tensor], torch.Tensor] = as_f32
            ) -> List[torch.Tensor]:
    """Logits (T_i - need_from[i], V) in float32 at positions need_from[i]
    .. T_i - 1 of each token sequence ``seqs[i]``."""
    L, H, KV = cfg["n_layers"], cfg["n_heads"], cfg["n_kv_heads"]
    dh = cfg.get("head_dim") or cfg["d_model"] // H
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    lay = params["layers"]
    emb = params["embed"]
    xs = [emb[s.long()].float() for s in seqs]
    pos = [torch.arange(len(s), device=s.device) for s in seqs]
    for i in range(L):
        wq, wk, wv, wo = (weight(lay[n][i]) for n in ("wq", "wk", "wv", "wo"))
        for j, x in enumerate(xs):
            h = rmsnorm(x, lay["ln1"][i].float(), eps)
            q, kk, vv = h @ wq, h @ wk, h @ wv
            if cfg.get("qkv_bias"):
                q = q + lay["bq"][i].float()
                kk = kk + lay["bk"][i].float()
                vv = vv + lay["bv"][i].float()
            T = len(x)
            q = rope(q.view(T, H, dh), pos[j], theta)
            kk = rope(kk.view(T, KV, dh), pos[j], theta)
            xs[j] = x + attention(q, kk, vv.view(T, KV, dh)) @ wo
        del wq, wk, wv, wo
        hs = torch.cat([rmsnorm(x, lay["ln2"][i].float(), eps) for x in xs])
        if cfg.get("n_experts"):
            lw = {n: lay["moe"][n][i] for n in ("router", "w_gate", "w_up",
                                                 "w_down")}
            y = moe(hs, lw, cfg, weight)
        else:
            m = lay["mlp"]
            y = (F.silu(hs @ weight(m["w_gate"][i]))
                 * (hs @ weight(m["w_up"][i]))) @ weight(m["w_down"][i])
        out, o = [], 0
        for x in xs:
            out.append(x + y[o:o + len(x)])
            o += len(x)
        xs = out
    un = params["embed"].T if cfg.get("tie_embeddings") else params["unembed"]
    un = weight(un)
    return [rmsnorm(x[f:], params["ln_f"].float(), eps) @ un
            for x, f in zip(xs, need_from)]
