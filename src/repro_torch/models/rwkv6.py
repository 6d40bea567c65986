"""RWKV6 ("Finch"): attention-free RNN LM with data-dependent decay, the
serving side of the reference's ``repro.models.rwkv6``.

Time mixing runs the WKV6 recurrence per head (P = head size):
    o_t[j] = sum_i r_t[i] * (S_t[i,j] + u[i] k_t[i] v_t[j])
    S_{t+1}[i,j] = exp(logw_t[i]) * S_t[i,j] + k_t[i] v_t[j]
with logw_t = -exp(w0 + lora(x_t)) and ddlerp token-shift mixing of the
w/k/v/r/g branch inputs (arXiv:2404.05892).

Prefill evaluates the recurrence over the prompt with plain PyTorch, as
the reference does with XLA ops outside any Pallas kernel: ``wkv_chunked``
(chunkwise matmuls, state carried across chunks) when the prompt length
is a multiple of ``ssm_chunk``, else ``wkv_scan`` (one step per token).
Decode launches the hand-written ``wkv_step`` kernel once per layer on
that layer's view of the cached state, which it updates in place; the
token-shift states are written in place too, so a wave's cache is
allocated once. The cache is ``{S (L, B, H, P, P) f32, x_tm, x_cm (L, B,
D) compute dtype, t ()}``: constant-size recurrent state, no K/V, so
the family serves on the ring layout only.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.wkv_step import wkv_step, wkv_step_plain
from ..sharding import shard_act
from ..sharding.context import (local_apply, reduce_grad, reduce_sums,
                                replicate_dim, unshard_batch_axes)
from .api import BaseModel, register_family
from .common import (ArchConfig, dense_init, dt, embed_init, embed_lookup,
                     groupnorm_heads, init_device, rmsnorm, softmax_xent,
                     stack_views)

BATCH = ("pod", "data")

N_MIX = 5  # w, k, v, r, g ddlerp branches


def _init_layers(gen: torch.Generator, cfg: ArchConfig, dtype) -> Dict:
    """The reference's ``_init_layer`` tree, every leaf stacked on a
    leading L axis; the mixing, bonus and LoRA-in leaves start at zero and
    the decay base at -6, as there."""
    L, D, Fd, R = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.rwkv_lora_dim
    H, P = cfg.n_heads, cfg.dh
    dev = gen.device
    f32 = torch.float32

    def full(shape, value):
        return torch.full((L,) + shape, value, dtype=f32, device=dev)

    return {
        "ln1": full((D,), 1.0),
        "ln2": full((D,), 1.0),
        "maa_x": full((D,), 0.0),
        "maa_base": full((N_MIX, D), 0.0),
        "maa_w1": full((D, N_MIX * R), 0.0),
        "maa_w2": dense_init(gen, (L, N_MIX, R, D), f32, in_axis=-2),
        "decay_w0": full((H, P), -6.0),
        "decay_lora1": dense_init(gen, (L, D, 2 * R), f32),
        "decay_lora2": dense_init(gen, (L, 2 * R, D), f32),
        "first_u": full((H, P), 0.0),
        "w_r": dense_init(gen, (L, D, D), dtype),
        "w_kk": dense_init(gen, (L, D, D), dtype),
        "w_vv": dense_init(gen, (L, D, D), dtype),
        "w_g": dense_init(gen, (L, D, D), dtype),
        "w_o2": dense_init(gen, (L, D, D), dtype),
        "g_norm": full((D,), 1.0),
        "ch_maa_k": full((D,), 0.0),
        "ch_maa_r": full((D,), 0.0),
        "w_ch_k": dense_init(gen, (L, D, Fd), dtype),
        "w_ch_v": dense_init(gen, (L, Fd, D), dtype),
        "w_ch_r": dense_init(gen, (L, D, D), dtype),
    }


def _shift(x, x_prev):
    """x: (B, L, D); x_prev: (B, D), the last token of the previous
    segment. A token-shift state ``cache_specs`` splits over ``model``
    is made whole first, as x is: DTensor would otherwise split x's
    columns to match, and then the mixing's per-branch views."""
    x_prev = replicate_dim(x_prev, x_prev.ndim - 1)
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _lora_in(x, w):
    """``tanh(x @ w)`` in f32, a LoRA's first product, on each rank's own
    rows. Its gradient comes back with pending sums from the
    head-split products; left to DTensor, they are reduce-scattered onto
    the sequence, and with a batch shard too small to split (8 rows a
    rank on the multi-pod mesh) the weight gradient's token dim is split
    over pod, data and, strided, model, which DTensor's propagation
    cannot take. Here only the (B, L, rank) gradient is gathered."""
    return local_apply(lambda x, w: torch.tanh(x.float() @ w),
                       ((BATCH, None, None), (None, None)), x, w,
                       out_specs=((BATCH, None, None),))


def _ddlerp(lp, x, xs):
    """Data-dependent lerp giving the 5 mixed branch inputs, in the order
    w, k, v, r, g (``maa_base[0]`` is w's)."""
    dx = xs - x
    xxx = (x + dx * lp["maa_x"]).to(x.dtype)
    r = lp["maa_w1"].shape[1] // N_MIX
    lo = _lora_in(xxx, lp["maa_w1"])
    lo = lo.reshape(x.shape[:-1] + (N_MIX, r))
    mixes = lp["maa_base"] + torch.einsum("...kr,krd->...kd", lo,
                                          lp["maa_w2"])
    out = x[..., None, :] + dx[..., None, :] * mixes.to(x.dtype)
    return [out[..., i, :] for i in range(N_MIX)]


def wkv_scan(r, k, v, logw, u, initial_state=None):
    """Exact recurrence, one step per token. r/k/v/logw: (B, L, H, P); u:
    (H, P). Returns (o (B, L, H, P) f32, final state (B, H, P, P) f32)."""
    B, L, H, P = r.shape
    S = (torch.zeros((B, H, P, P), dtype=torch.float32, device=r.device)
         if initial_state is None else initial_state.float())
    outs = []
    for t in range(L):
        o, S = wkv_step_plain(r[:, t], k[:, t], v[:, t], logw[:, t], u, S)
        outs.append(o)
    return torch.stack(outs, dim=1), S


def wkv_chunked(r, k, v, logw, u, initial_state=None, chunk: int = 32):
    """Chunkwise WKV6: intra-chunk (Q x Q) products with the per-channel
    log-space decay factored into r'/k', inter-chunk state carry. Each
    step's logw is clamped to [-8, -1e-6] (the scan is not), and both
    factored halves are shifted by the chunk-midpoint cumsum so neither
    exponent overflows f32 for Q <= 32. A length that is not a multiple of
    ``chunk`` falls back to ``wkv_scan``."""
    B, L, H, P = r.shape
    if L % chunk:
        return wkv_scan(r, k, v, logw, u, initial_state)
    nc, Q = L // chunk, chunk
    f32 = torch.float32
    rc = r.to(f32).reshape(B, nc, Q, H, P)
    kc = k.to(f32).reshape(B, nc, Q, H, P)
    vc = v.to(f32).reshape(B, nc, Q, H, P)
    wc = logw.to(f32).clamp(-8.0, -1e-6).reshape(B, nc, Q, H, P)
    cs = torch.cumsum(wc, dim=2)               # inclusive
    total = cs[:, :, -1]                       # (B, nc, H, P)
    cs_ex = cs - wc                            # exclusive
    mid = cs[:, :, Q // 2:Q // 2 + 1]
    r_dec = rc * torch.exp(cs_ex - mid)
    k_dec = kc * torch.exp(mid - cs)
    att = torch.einsum("bcqhp,bcrhp->bcqrh", r_dec, k_dec)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=r.device),
                     diagonal=-1)              # strictly lower
    att = att.masked_fill(~tri[None, None, :, :, None], 0.0)
    o_intra = torch.einsum("bcqrh,bcrhp->bcqhp", att, vc)
    o_bonus = torch.einsum("bcqhp,bcqhp->bcqh", rc,
                           u.float() * kc)[..., None] * vc
    kv_c = torch.einsum("bcqhp,bcqhj->bchpj",
                        kc * torch.exp(total[:, :, None] - cs), vc)
    S = (torch.zeros((B, H, P, P), dtype=f32, device=r.device)
         if initial_state is None else initial_state.to(f32))
    before = []
    for c in range(nc):
        before.append(S)
        S = torch.exp(total[:, c])[..., None] * S + kv_c[:, c]
    S_before = torch.stack(before, dim=1)      # (B, nc, H, P, P)
    o_state = torch.einsum("bcqhp,bchpj->bcqhj", rc * torch.exp(cs_ex),
                           S_before)
    o = (o_intra + o_bonus + o_state).reshape(B, L, H, P)
    return o, S


def _chunked_local(r, k, v, logw, u, state, chunk: int):
    """``wkv_chunked``, on each rank's own rows and heads where the
    arguments are DTensors (``model`` splits the heads where it divides
    them): DTensor has no sharded rule for the scan's batched products
    over flattened split dims. The state comes back split as the scan's
    own (rows, heads), which the caller's ``copy_`` lays out as its
    cache."""
    seq, heads = (BATCH, None, "model", None), (BATCH, "model", None, None)
    return local_apply(
        lambda r, k, v, logw, u, s: wkv_chunked(r, k, v, logw, u, s, chunk),
        (seq, seq, seq, seq, ("model", None), heads),
        r, k, v, logw, u, state, n_out=2, out_specs=(seq, heads))


def time_mix(lp, x, cfg: ArchConfig, x_prev, wkv_state, mode: str):
    """x: (B, L, D) pre-normed. Returns (out, new x_prev, new wkv state).
    ``mode``: "chunked" over the sequence (``wkv_chunked``, which scans a
    length that is not a multiple of ``ssm_chunk``), or "step" (L = 1):
    the ``wkv_step`` kernel, writing the new state over ``wkv_state``."""
    B, L, D = x.shape
    H, P = cfg.n_heads, cfg.dh
    xs = _shift(x, x_prev)
    xw, xk, xv, xr, xg = _ddlerp(lp, x, xs)
    r = (xr @ lp["w_r"]).reshape(B, L, H, P)
    k = (xk @ lp["w_kk"]).reshape(B, L, H, P)
    v = (xv @ lp["w_vv"]).reshape(B, L, H, P)
    g = F.silu((xg @ lp["w_g"]).float())
    lo = _lora_in(xw, lp["decay_lora1"]) @ lp["decay_lora2"]
    w_raw = lp["decay_w0"].reshape(D) + lo
    logw = -torch.exp(w_raw).reshape(B, L, H, P)
    r = shard_act(r, (BATCH, None, "model", None))
    k = shard_act(k, (BATCH, None, "model", None))
    if mode == "step":
        o, S = wkv_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0],
                        lp["first_u"], wkv_state, out_state=wkv_state)
        o = o[:, None]
    else:
        o, S = _chunked_local(r, k, v, logw, lp["first_u"], wkv_state,
                              cfg.ssm_chunk)
    o = groupnorm_heads(o, torch.ones((H, P), dtype=torch.float32,
                                      device=x.device))
    o = o.reshape(B, L, D) * lp["g_norm"] * g
    out = o.to(x.dtype) @ lp["w_o2"]
    return out.to(x.dtype), x[:, -1], S


def channel_mix(lp, x, x_prev):
    xs = _shift(x, x_prev)
    dx = xs - x
    xk = (x + dx * lp["ch_maa_k"]).to(x.dtype)
    xr = (x + dx * lp["ch_maa_r"]).to(x.dtype)
    k = torch.square(torch.relu(xk @ lp["w_ch_k"]))
    # the row-split product's sums are reduce-scattered onto the columns
    # before the gate multiplies them, and the columns gathered after (the
    # bytes of the all-reduce the residual made): left pending, the gate's
    # gradient, and so ``w_ch_r``'s, is pending too, and DTensor splits its
    # token dim as in ``_lora_in``
    out = replicate_dim(torch.sigmoid((xr @ lp["w_ch_r"]).float()).to(
        x.dtype) * reduce_sums(k @ lp["w_ch_v"], -1), -1)
    return out, x[:, -1]


def _layer_out(lp, x, cfg: ArchConfig, state, mode):
    """One layer from state {S, x_tm, x_cm}: (new x, S, x_tm, x_cm). It
    writes nothing, but in "step" mode the ``wkv_step`` kernel updates
    ``state["S"]`` in place (and returns it as S)."""
    h = reduce_grad(rmsnorm(x, lp["ln1"], cfg.norm_eps))
    o, x_tm, S = time_mix(lp, h, cfg, state["x_tm"], state["S"], mode)
    x = x + reduce_sums(o)
    h2 = reduce_grad(rmsnorm(x, lp["ln2"], cfg.norm_eps))
    o2, x_cm = channel_mix(lp, h2, state["x_cm"])
    return shard_act(x + reduce_sums(o2), (BATCH, None, None)), S, x_tm, x_cm


def _layer(lp, x, cfg: ArchConfig, state, mode):
    """state: {S, x_tm, x_cm} views of one layer's cache; the new state is
    written into them. Returns the new x."""
    x, S, x_tm, x_cm = _layer_out(lp, x, cfg, state, mode)
    if S is not state["S"]:
        state["S"].copy_(S)
    state["x_tm"].copy_(x_tm)
    state["x_cm"].copy_(x_cm)
    return x


@register_family("rwkv")
class RWKV6(BaseModel):
    """RWKV6 LM serving on the ring layout (no paged protocol: the cache
    is recurrent state, not K/V)."""

    def init(self, generator, device=None):
        """Params from ``generator`` (a ``torch.Generator`` on the target
        device, or an int seed for one). Runs on ``cuda`` unless
        ``device="cpu"``; ``device="meta"`` gives shapes only."""
        cfg = self.cfg
        dev, generator = init_device(generator, device)
        dtype = dt(cfg.param_dtype)
        return {
            "embed": embed_init(generator, (cfg.padded_vocab, cfg.d_model),
                                dtype),
            "layers": _init_layers(generator, cfg, dtype),
            "ln_f": torch.ones((cfg.d_model,), dtype=torch.float32,
                               device=dev),
            "unembed": dense_init(generator,
                                  (cfg.d_model, cfg.padded_vocab), dtype),
        }

    # -- serving --------------------------------------------------------
    def init_cache(self, batch_size, capacity, device=None):
        """Zeroed recurrent state for ``batch_size`` rows (``capacity`` is
        ignored: the state has constant size)."""
        cfg = self.cfg
        L, H, P, D = cfg.n_layers, cfg.n_heads, cfg.dh, cfg.d_model
        cdt = dt(cfg.compute_dtype)
        B = batch_size
        return {
            "S": torch.zeros((L, B, H, P, P), dtype=torch.float32,
                             device=device),
            "x_tm": torch.zeros((L, B, D), dtype=cdt, device=device),
            "x_cm": torch.zeros((L, B, D), dtype=cdt, device=device),
            "t": torch.zeros((), dtype=torch.int32, device=device),
        }

    def cache_capacity(self, seq_len):
        return 1  # constant-size recurrent state

    def _run(self, params, x, cache, mode):
        for i, lp in enumerate(stack_views(params["layers"])):
            state = {k: cache[k][i] for k in ("S", "x_tm", "x_cm")}
            x = _layer(lp, x, self.cfg, state, mode)
        return rmsnorm(x, params["ln_f"], self.cfg.norm_eps)

    def _unembed(self, params, x):
        return reduce_grad(x) @ unshard_batch_axes(
            params["unembed"]).to(x.dtype)

    def prefill(self, params, batch, capacity=None):
        """batch {"tokens": (B, S)} -> (last-position logits (B, Vp), cache
        {S, x_tm, x_cm, t = S})."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embed_lookup(params["embed"], tokens).to(dt(cfg.compute_dtype))
        cache = self.new_cache(x.shape[0], 1, like=x)
        x = self._run(params, x, cache, "chunked")
        cache["t"].fill_(tokens.shape[1])
        return self._unembed(params, x[:, -1]), cache

    def decode(self, params, cache, batch):
        """batch {"token": (B, 1)} -> (logits (B, Vp), cache updated in
        place: every layer's state through ``wkv_step``, t advanced)."""
        cfg = self.cfg
        x = embed_lookup(params["embed"], batch["token"]).to(
            dt(cfg.compute_dtype))
        x = self._run(params, x, cache, "step")
        cache["t"].add_(1)
        return self._unembed(params, x[:, 0]), cache

    # -- training -------------------------------------------------------
    def loss(self, params, batch):
        """Mean next-token cross-entropy of batch {"tokens", "labels"} (B,
        S) over the padded vocab: (ce, {"ce"}). Every layer starts from
        the zero state and evaluates the sequence with ``wkv_chunked``
        (its scan fallback where S is not a multiple of ``ssm_chunk``),
        as prefill does, writing nothing; under ``torch.utils.checkpoint``
        where ``cfg.remat`` is set (the reference's ``jax.checkpoint``)."""
        cfg = self.cfg
        x = embed_lookup(params["embed"], batch["tokens"]).to(
            dt(cfg.compute_dtype))
        x = shard_act(x, (BATCH, None, None))
        zero = {k: v[0] for k, v in self.new_cache(
            x.shape[0], 1, like=x).items() if k != "t"}

        def layer(x, lp):
            return _layer_out(lp, x, cfg, zero, "chunked")[0]

        for lp in stack_views(params["layers"]):
            x = (checkpoint(layer, x, lp, use_reentrant=False) if cfg.remat
                 else layer(x, lp))
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        ce = softmax_xent(self._unembed(params, x), batch["labels"])
        return ce, {"ce": ce}
