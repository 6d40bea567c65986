"""Plain reference of RWKV6 "Finch" (arXiv:2404.05892) in the port's
layouts: a full forward over each sequence in float32, layer by layer,
the WKV recurrence stepped token by token from a zero state.

Per layer, with ``shift(h)`` the previous token's h (0 before the first):

    h = rmsnorm(x) * ln1;  dx = shift(h) - h
    lo = tanh((h + dx * maa_x) maa_w1)                      (T, 5, R)
    xw, xk, xv, xr, xg = h + dx * (maa_base + lo maa_w2)    (ddlerp)
    r, k, v = xr w_r, xk w_kk, xv w_vv;  g = silu(xg w_g)
    logw = -exp(decay_w0 + tanh(xw decay_lora1) decay_lora2)
    per head (size P):  o_t = r_t (S + (u * k_t) v_t^T)
                        S <- exp(logw_t) * S + k_t v_t^T     (rows of S)
    x += (groupnorm_heads(o) * g_norm * g) w_o2
    h = rmsnorm(x) * ln2;  dx = shift(h) - h
    x += sigmoid((h + dx ch_maa_r) w_ch_r) * (relu((h + dx ch_maa_k) w_ch_k)^2 w_ch_v)
    logits = (rmsnorm(x) * ln_f) unembed

GroupNorm is over each head's P channels, population variance, eps
1e-5, unit scale. ``weight`` turns a stored matrix into the one
multiplied by (float32, or the control's lower precision).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

from .decoder import as_f32, rmsnorm

N_MIX = 5


def _shift(h, lens):
    """h (B, T, D) -> the previous token's h, zero at each row's start."""
    return torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)


def _groupnorm(o, eps=1e-5):
    mu = o.mean(-1, keepdim=True)
    var = o.var(-1, keepdim=True, correction=0)
    return (o - mu) * torch.rsqrt(var + eps)


def forward(params: Dict, cfg: Dict, seqs: Sequence[torch.Tensor],
            need_from: Sequence[int],
            weight: Callable[[torch.Tensor], torch.Tensor] = as_f32
            ) -> List[torch.Tensor]:
    """Logits at positions need_from[i] .. T_i - 1 of each sequence. The
    sequences run together, right-padded to the longest (a position
    never sees a later one, so padding changes nothing before it)."""
    L, D = cfg["n_layers"], cfg["d_model"]
    H = cfg["n_heads"]
    P = D // H
    R = cfg["rwkv_lora_dim"]
    eps = cfg["norm_eps"]
    lay = params["layers"]
    B, T = len(seqs), max(len(s) for s in seqs)
    dev = seqs[0].device
    tok = torch.zeros(B, T, dtype=torch.long, device=dev)
    for b, s in enumerate(seqs):
        tok[b, :len(s)] = s.long()
    x = params["embed"][tok].float()
    for i in range(L):
        lw = {k: v[i] for k, v in lay.items()}
        h = rmsnorm(x, lw["ln1"].float(), eps)
        dx = _shift(h, None) - h
        xxx = h + dx * lw["maa_x"].float()
        lo = torch.tanh(xxx @ lw["maa_w1"].float()).view(B, T, N_MIX, R)
        mixes = lw["maa_base"].float() + torch.einsum(
            "btkr,krd->btkd", lo, lw["maa_w2"].float())
        xm = h[:, :, None] + dx[:, :, None] * mixes
        xw, xk, xv, xr, xg = (xm[:, :, j] for j in range(N_MIX))
        r = (xr @ weight(lw["w_r"])).view(B, T, H, P)
        k = (xk @ weight(lw["w_kk"])).view(B, T, H, P)
        v = (xv @ weight(lw["w_vv"])).view(B, T, H, P)
        g = F.silu(xg @ weight(lw["w_g"]))
        dec = torch.tanh(xw @ lw["decay_lora1"].float()) \
            @ lw["decay_lora2"].float()
        logw = -torch.exp(lw["decay_w0"].float().reshape(D) + dec)
        w = torch.exp(logw).view(B, T, H, P)
        u = lw["first_u"].float()
        S = torch.zeros(B, H, P, P, device=dev)
        o = torch.empty(B, T, H, P, device=dev)
        for t in range(T):
            kv = k[:, t, :, :, None] * v[:, t, :, None, :]
            o[:, t] = torch.einsum("bhi,bhij->bhj", r[:, t],
                                   S + u[None, :, :, None] * kv)
            S = w[:, t, :, :, None] * S + kv
        o = _groupnorm(o).reshape(B, T, D) * lw["g_norm"].float() * g
        x = x + o @ weight(lw["w_o2"])
        h = rmsnorm(x, lw["ln2"].float(), eps)
        dx = _shift(h, None) - h
        xk = h + dx * lw["ch_maa_k"].float()
        xr = h + dx * lw["ch_maa_r"].float()
        kk = torch.relu(xk @ weight(lw["w_ch_k"])).square()
        x = x + torch.sigmoid(xr @ weight(lw["w_ch_r"])) \
            * (kk @ weight(lw["w_ch_v"]))
    un = weight(params["unembed"])
    xf = rmsnorm(x, params["ln_f"].float(), eps)
    return [xf[b, f:len(s)] @ un for b, (s, f) in enumerate(zip(seqs, need_from))]
