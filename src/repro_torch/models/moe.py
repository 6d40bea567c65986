"""Mixture-of-Experts FFN, the reference's ``models/moe.py``.

Two implementations, selected by ``cfg.moe_impl``:

* ``dispatch`` (GShard/Switch-style): top-k routing, a capacity-bounded
  scatter into an (E, capacity, D) buffer, batched per-expert GEMMs
  (``torch.bmm``), a weighted combine. One token group (G = 1: a single
  card has no ``pod``/``data`` mesh axes). Prefill drops the tokens past
  an expert's capacity, in the reference's order: assignments are
  numbered row-major over (B, S) then over the k choices, and each
  expert keeps its first ``cap``. A token's output therefore depends on
  every other token of the call, padding included.
* ``dense``: every expert on every token, masked combine; the same math
  with no drops. The correctness oracle, and bankable.

Both return (output, aux_loss), aux_loss the Switch load-balance loss
E * sum_e f_e * p_e. Every shape is fixed by the input's (no boolean
indexing, ``nonzero`` or host read), so a dropless decode or verify step
captures as a CUDA graph.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import ArchConfig, dense_init


def init_moe(gen, cfg: ArchConfig, dtype, n_layers: int) -> Dict:
    """The ``n_layers``-stacked MoE leaves: ``router`` (L, D, E) in f32
    whatever ``dtype`` is, ``w_gate`` / ``w_up`` (L, E, D, F) and
    ``w_down`` (L, E, F, D), each drawn on its fan-in axis -2."""
    L, E, D, Fd = n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": dense_init(gen, (L, D, E), torch.float32),
        "w_gate": dense_init(gen, (L, E, D, Fd), dtype),
        "w_up": dense_init(gen, (L, E, D, Fd), dtype),
        "w_down": dense_init(gen, (L, E, Fd, D), dtype),
    }


def _route(params, x2d, cfg: ArchConfig):
    """x2d (T, D) -> (weights (T, k), ids (T, k) int64, probs (T, E)).

    ``jax.lax.top_k`` lists the k largest in descending order, ties to
    the lower index, and that order fixes the dispatch's assignment
    order; ``torch.topk`` promises no tie order, so the ids are the first
    k of a stable descending sort, and the weights are gathered from
    ``probs`` (gradients reach the same entries as through top_k's
    values)."""
    logits = x2d.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    ids = order[:, :cfg.experts_per_token]
    w = probs.gather(1, ids)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    return w, ids, probs


def _aux_loss(probs, ids, E: int):
    """Switch load-balance loss: E * sum_e (fraction routed) * (mean
    prob)."""
    counts = F.one_hot(ids.reshape(-1), num_classes=E).sum(0).float()
    f = counts / max(float(ids.numel()), 1.0)
    p = probs.mean(dim=0)
    return E * torch.sum(f * p)


def _expert_ffn(w_gate, w_up, w_down, xb):
    """Batched per-expert SwiGLU: xb (E, C, D) -> (E, C, D)."""
    h = F.silu(torch.bmm(xb, w_gate))
    h = h * torch.bmm(xb, w_up)
    return torch.bmm(h, w_down)


def moe_ffn(params, x, cfg: ArchConfig, dropless: bool = False,
            with_aux: bool = True) -> Tuple[torch.Tensor,
                                            Optional[torch.Tensor]]:
    """x (B, S, D) -> (y in x's dtype, aux_loss).

    ``dropless=True`` (decode and verify) sets capacity = T, so no token
    is ever dropped. ``with_aux=False`` skips the balance loss (aux is
    None): the serving steps discard it."""
    B, S, D = x.shape
    T = B * S
    x2d = x.reshape(T, D)
    w, ids, probs = _route(params, x2d, cfg)
    aux = _aux_loss(probs, ids, cfg.n_experts) if with_aux else None
    if cfg.moe_impl == "dense":
        y = _moe_dense(params, x2d, w, ids, cfg)
    else:
        y = _moe_dispatch(params, x2d, w, ids, cfg, dropless)
    return y.reshape(B, S, D).to(x.dtype), aux


def _moe_dense(params, x2d, w, ids, cfg: ArchConfig):
    """Every expert on every token, masked combine (f32)."""
    E = cfg.n_experts
    T, D = x2d.shape
    xb = x2d[None].expand(E, T, D)
    ye = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"], xb)
    # a token's k experts are distinct: a scatter sets each (token, e)
    wte = torch.zeros((T, E), dtype=torch.float32,
                      device=x2d.device).scatter(1, ids, w)
    return torch.einsum("etd,te->td", ye.float(), wte)


def capacity(cfg: ArchConfig, T: int, dropless: bool) -> int:
    """Slots per expert for a call of T tokens: the reference's formula,
    in its operation order, on the padded T."""
    if dropless:
        return T
    return max(1, int(cfg.moe_capacity_factor * T
                      * cfg.experts_per_token / cfg.n_experts))


def _moe_dispatch(params, x2d, w, ids, cfg: ArchConfig,
                  dropless: bool = False):
    """Capacity dispatch over one token group.

    Assignment i = t * k + j (token t's j-th choice) takes slot ``mypos``
    = the number of earlier assignments to its expert (an exclusive
    cumsum over the one-hot, row-major); those at or past ``cap`` are
    dropped. The reference scatters every assignment with an add, a
    dropped one adding zero into slot cap-1; here kept assignments are
    copied into their distinct slots and dropped ones into a trash row
    past the buffer, which is the same buffer with no atomics. The
    combine reads slot (e, dest) of each assignment times its weight
    times ``keep``, and adds a token's k contributions in f32 in slot
    order, as the reference's scatter-add does."""
    T, D = x2d.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    cap = capacity(cfg, T, dropless)
    flat_e = ids.reshape(-1)                                # (T*k,)
    flat_w = w.reshape(-1)
    oh = F.one_hot(flat_e, num_classes=E)                   # (T*k, E)
    pos = torch.cumsum(oh, dim=0) - oh                      # exclusive
    mypos = pos.gather(1, flat_e[:, None])[:, 0]
    keep = mypos < cap
    dest = torch.where(keep, mypos, torch.full_like(mypos, cap - 1))
    slot = flat_e * cap + dest                              # (T*k,)
    trash = torch.full_like(slot, E * cap)
    buf = x2d.new_zeros((E * cap + 1, D))
    src = x2d[:, None].expand(T, k, D).reshape(T * k, D)  # token of each
    buf.index_copy_(0, torch.where(keep, slot, trash), src)
    yb = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"],
                     buf[:E * cap].view(E, cap, D))
    y_tok = yb.reshape(E * cap, D)[slot].float() \
        * (flat_w * keep.float())[:, None]
    y_tok = y_tok.view(T, k, D)
    y = y_tok[:, 0]
    for j in range(1, k):
        y = y + y_tok[:, j]
    return y
