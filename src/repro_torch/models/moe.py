"""Mixture-of-Experts FFN, the reference's ``models/moe.py``.

Two implementations, selected by ``cfg.moe_impl``:

* ``dispatch`` (GShard/Switch-style): top-k routing, a capacity-bounded
  scatter into a (G, E, capacity, D) buffer, batched per-expert GEMMs
  (``torch.bmm``), a weighted combine. The T tokens split into G groups
  aligned with the ``pod`` x ``data`` mesh axes (G = 1 with no mesh, an
  ``ExpertMesh``, or when G does not divide T), and capacity and slots
  are counted within each group. Prefill drops the tokens past an
  expert's capacity, in the reference's order: a group's assignments
  are numbered row-major over its tokens then over the k choices, and
  each expert keeps its first ``cap``. A token's output therefore
  depends on every other token of its group, padding included.
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

from ..sharding.context import axis_size, local_apply, shard_act
from .common import ArchConfig, dense_init

BATCH = ("pod", "data")


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


def _scatter_groups(xg, idsg, E: int, cap: int):
    """Each group's capacity scatter, groups batched on dim 0: xg (G, Tg,
    D), idsg (G, Tg, k) -> (buf (G, E, cap, D), slot (G, Tg*k), keep
    (G, Tg*k)).

    Assignment i = t * k + j (token t's j-th choice) takes slot ``mypos``
    = the number of earlier assignments of its group to its expert (an
    exclusive cumsum over the one-hot, row-major within the group);
    those at or past ``cap`` are dropped. The reference scatters every
    assignment with an add, a dropped one adding zero into slot cap-1;
    here kept assignments are copied into their distinct slots and
    dropped ones into a trash row past the group's buffer, which is the
    same buffer with no atomics."""
    G, Tg, D = xg.shape
    k = idsg.shape[-1]
    flat_e = idsg.reshape(G, Tg * k)
    oh = F.one_hot(flat_e, num_classes=E)                   # (G, Tg*k, E)
    pos = torch.cumsum(oh, dim=1) - oh                      # exclusive
    mypos = pos.gather(2, flat_e[..., None])[..., 0]
    keep = mypos < cap
    dest = torch.where(keep, mypos, torch.full_like(mypos, cap - 1))
    slot = flat_e * cap + dest                              # (G, Tg*k)
    trash = torch.full_like(slot, E * cap)
    row = E * cap + 1                                       # + trash row
    buf = xg.new_zeros((G * row, D))
    src = xg[:, :, None].expand(G, Tg, k, D).reshape(G * Tg * k, D)
    into = torch.where(keep, slot, trash)
    if G > 1:                       # each group's rows of the flat buffer
        into = into + (torch.arange(G, device=xg.device) * row)[:, None]
    buf.index_copy_(0, into.reshape(-1), src)
    return buf.view(G, row, D)[:, :E * cap].reshape(G, E, cap, D), slot, keep


def _combine_groups(yb, slot, wg, keep):
    """Each group's weighted combine: slot (e, dest) of every assignment
    of yb (G, E, cap, D), times its weight times ``keep``; a token's k
    contributions added in f32 in choice order, as the reference's
    scatter-add adds them. -> (G, Tg, D) f32."""
    G, E, cap, D = yb.shape
    Tg, k = wg.shape[1], wg.shape[2]
    at = slot
    if G > 1:                       # each group's rows of the flat buffer
        at = at + (torch.arange(G, device=yb.device) * (E * cap))[:, None]
    y_tok = yb.reshape(G * E * cap, D)[at.reshape(-1)].float() \
        * (wg.reshape(-1) * keep.reshape(-1).float())[:, None]
    y_tok = y_tok.view(G, Tg, k, D)
    y = y_tok[:, :, 0]
    for j in range(1, k):
        y = y + y_tok[:, :, j]
    return y


def _group_local(fn, n_out: int, *args):
    """``fn`` on each rank's own groups: every argument's group dim 0
    over ``pod`` x ``data``, the counterpart of the reference's
    group-local ``vmap`` on a data-sharded axis (DTensor has no sharded
    rule for the data-dependent scatter and gather)."""
    return local_apply(fn, [(BATCH,) + (None,) * (a.ndim - 1) for a in args],
                       *args, n_out=n_out)


def _moe_dispatch(params, x2d, w, ids, cfg: ArchConfig,
                  dropless: bool = False):
    """Hierarchical (grouped) capacity dispatch, GShard-style.

    Tokens are split into G = ``pod`` x ``data`` groups (1 if that does
    not divide T); capacity and slots are computed *within* each group,
    so the scatter into the (G, E, cap, D) buffer and the combine are
    group-local (``_group_local``), and the only cross-device traffic
    left is the expert GEMM's own parallelism. The experts run as one
    ``torch.bmm`` over every group's slots (E, G * cap, D)."""
    T, D = x2d.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    G = max(1, axis_size("pod") * axis_size("data"))
    if T % G:
        G = 1
    Tg = T // G
    cap = capacity(cfg, Tg, dropless)
    xg = shard_act(x2d.reshape(G, Tg, D), (BATCH, None, None))
    wg = w.reshape(G, Tg, k)
    bufs, slot, keep = _group_local(
        lambda xs, i: _scatter_groups(xs, i, E, cap), 3, xg,
        ids.reshape(G, Tg, k))
    bufs = shard_act(bufs, (BATCH, "model", None, None))
    xb = bufs.transpose(0, 1).reshape(E, G * cap, D)
    yb = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"], xb)
    yb = yb.reshape(E, G, cap, D).transpose(0, 1)
    yb = shard_act(yb, (BATCH, "model", None, None))
    y = _group_local(_combine_groups, 1, yb, slot, wg, keep)
    return y.reshape(T, D)
