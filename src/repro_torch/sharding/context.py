"""Mesh context, activation sharding constraints, and leading-axis
sharding, the reference's ``sharding/context.py``.

Models call ``shard_act(x, ("data", None, "model"))`` at key points.
With no mesh active, or on a plain tensor, this is a no-op; under a
``mesh_context`` over a ``DeviceMesh`` a DTensor is redistributed to the
spec's placements, the counterpart of ``with_sharding_constraint``: the
values stay, the layout is pinned.

``leading_sharding`` is the layout contract of banked expert serving:
the reference splits every leaf's leading dim over a mesh axis with a
``NamedSharding``. Banks keep one tensor per mesh position instead of a
sharded array, so there the contract reduces to which position each
member of the leading axis lives on.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

_STATE = threading.local()


class Spec(tuple):
    """A partition spec: ``Spec(None, "model")`` is the tuple ``(None,
    "model")`` (and equals ``PartitionSpec(None, "model")``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def current_mesh():
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` (a ``DeviceMesh``, an ``ExpertMesh``, or ``None``)
    this thread's current mesh for the block, restoring the previous one
    after."""
    prev = current_mesh()
    _STATE.mesh = mesh
    try:
        yield mesh
    finally:
        _STATE.mesh = prev


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (its dim names), an
    ``ExpertMesh`` or any mesh whose ``shape`` is such a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def axis_size(name: str) -> int:
    mesh = current_mesh()
    if mesh is None:
        return 1
    return mesh_shape(mesh).get(name, 1)


def _clean_spec(mesh, spec: Sequence, shape) -> Tuple:
    """Drop axes that don't exist in the mesh or don't divide the dim."""
    ms = mesh_shape(mesh)
    out = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        axes = tuple(a for a in axes if a in ms)
        total = 1
        for a in axes:
            total *= ms[a]
        if not axes or total == 1 or dim % total:
            out.append(None)
        else:
            out.append(axes if len(axes) > 1 else axes[0])
    return Spec(*out)


def placements(spec: Sequence, mesh) -> Tuple:
    """One DTensor placement a dimension of ``mesh`` (a ``DeviceMesh``
    with dim names): ``Shard(i)`` where the spec shards tensor dim ``i``
    over that mesh dim, ``Replicate()`` elsewhere. A dim sharded over
    several axes (``("pod", "data")``) is split over each in the mesh's
    dim order, major first, as JAX lays it out; axis names the mesh does
    not have are ignored."""
    out = []
    for name in mesh.mesh_dim_names:
        where = [i for i, ax in enumerate(spec) if ax is not None and
                 name in (ax if isinstance(ax, tuple) else (ax,))]
        out.append(Shard(where[0]) if where else Replicate())
    return tuple(out)


def shard_act(x, spec: Sequence):
    """Best-effort activation sharding constraint: a DTensor under a mesh
    is redistributed to ``spec`` (cleaned for its shape); anything else
    comes back as it is."""
    mesh = current_mesh()
    if mesh is None or len(spec) != x.ndim or not isinstance(x, DTensor):
        return x
    want = placements(_clean_spec(x.device_mesh, spec, x.shape),
                      x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def local_apply(fn, specs: Sequence, *args, n_out: int = 1):
    """``fn(*args)``, on each rank's own shards where the arguments are
    DTensors: each DTensor argument is laid out by its spec in ``specs``
    (cleaned for its shape), other arguments pass as they are, and the
    ``n_out`` outputs come back as DTensors in the first argument's
    placements. The counterpart of GSPMD partitioning a computation that
    needs no collective (rows over ``data``, heads over ``model``): DTensor
    then neither plans each op nor meets ops it has no sharded rule for.
    With plain tensors it is ``fn(*args)``."""
    if not isinstance(args[0], DTensor):
        return fn(*args)
    mesh = args[0].device_mesh
    laid, pls = [], []
    for a, spec in zip(args, specs):
        pl = None
        if isinstance(a, DTensor):
            pl = placements(_clean_spec(mesh, spec, a.shape), mesh)
            if tuple(a.placements) != pl:
                a = a.redistribute(mesh, pl)
        laid.append(a)
        pls.append(pl)

    def local(*xs):
        return fn(*(_ContiguousGrad.apply(x) if isinstance(x, torch.Tensor)
                    and x.requires_grad else x for x in xs))

    return local_map(local, out_placements=(pls[0],) * n_out,
                     in_placements=tuple(pls), device_mesh=mesh)(*laid)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous: a local body's input
    gradients (an einsum's are permuted) go back into DTensor ops that
    ``view`` their local shards."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def replicate_dim(x, dim: Optional[int] = None):
    """A DTensor ``x`` with pending sums reduced and tensor dim ``dim``
    gathered wherever a mesh dim shards it (every dim with ``dim=None``),
    its other shards kept; anything else as it is. For the ops whose
    sharded form DTensor lacks or breaks."""
    if not isinstance(x, DTensor):
        return x
    want = tuple(Replicate() if p.is_partial() or (
        isinstance(p, Shard) and dim in (None, p.dim)) else p
        for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def leading_sharding(n: int, axis: str, mesh) -> Optional[Tuple[int, ...]]:
    """The mesh position of each of the ``n`` members of a leading axis
    split over ``axis``: member ``e`` on position ``e // (n // size)``,
    contiguous blocks, as a ``PartitionSpec(axis)`` lays them out.
    ``None`` when there is nothing to split: no mesh, a mesh without
    ``axis`` or of size 1, or a size that does not divide ``n`` (the
    reference replicates such a leaf)."""
    if mesh is None or axis not in mesh.shape or mesh.shape[axis] == 1:
        return None
    size = mesh.shape[axis]
    if n % size:
        return None
    return tuple(e // (n // size) for e in range(n))
