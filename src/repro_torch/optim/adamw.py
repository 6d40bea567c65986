"""AdamW + global-norm clipping in plain PyTorch, the reference's
``repro.optim.adamw`` (no ``torch.optim``: the state is a tree the caller
holds, and every call returns a new one).

Optimizer state is a tree mirroring params:
  {"m": tree, "v": tree, "step": () int32}
First and second moments are kept in float32 whatever the param dtype
(bf16 training keeps f32 statistics); the update is applied in f32 and
cast back to the param dtype.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map

from ..sharding.context import local_value
from ..tree import leaves, tree_map, unflatten

PyTree = Any


def adamw_init(params: PyTree) -> PyTree:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    return {"m": zeros,
            "v": tree_map(torch.clone, zeros),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves(params)[0].device)}


def _sharded_upd(upd, g, m, v, p):
    """``upd`` on each rank's shard of DTensor moments (ZeRO-1): the
    gradient and the param are laid out as the moments (which may split
    a leaf over ``data`` too), the step's arithmetic runs rank-locally,
    and the new param goes back to the param's placements. The scalars
    ``upd`` closes over (lr, the bias corrections) are replicated."""
    mesh, pl = m.device_mesh, tuple(m.placements)
    new_p, m, v = local_map(upd, out_placements=(pl, pl, pl),
                            in_placements=(pl, pl, pl, pl),
                            device_mesh=mesh)(g.redistribute(mesh, pl), m, v,
                                              p.redistribute(mesh, pl))
    return new_p.redistribute(mesh, tuple(p.placements)), m, v


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, leaf by leaf in
    the reference's order."""
    return torch.sqrt(sum(l.float().square().sum() for l in leaves(tree)))


def adamw_update(
    grads: PyTree,
    state: PyTree,
    params: PyTree,
    lr: torch.Tensor,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    clip_norm: Optional[float] = None,
) -> Tuple[PyTree, PyTree]:
    """One AdamW step. Returns (new_params, new_state); nothing given is
    modified."""
    step = state["step"] + 1
    if clip_norm is not None:
        gn = global_norm(grads)
        scale = torch.clamp(clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
        # a 0-d f32 tensor does not promote a bf16 one in torch (JAX's
        # g * scale is f32): scale the f32 gradient, as the reference does
        grads = tree_map(lambda g: g.float() * scale, grads)
    t = step.float()
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t     # bias corrections, once a step
    # replicated scalars (a sharded step's) enter a rank-local update whole
    c1, c2, lr = (local_value(x) for x in (c1, c2, lr))

    def upd(g, m, v, p):
        g32 = g.float()
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * torch.square(g32)
        mhat = m / c1
        vhat = v / c2
        delta = mhat / (torch.sqrt(vhat) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.float()
        new_p = (p.float() - lr * delta).to(p.dtype)
        return new_p, m, v

    out = [_sharded_upd(upd, g, m, v, p) if isinstance(m, DTensor)
           else upd(g, m, v, p) for g, m, v, p in
           zip(leaves(grads), leaves(state["m"]), leaves(state["v"]),
               leaves(params))]
    new_p = unflatten(params, [o[0] for o in out])
    new_m = unflatten(params, [o[1] for o in out])
    new_v = unflatten(params, [o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "step": step}
