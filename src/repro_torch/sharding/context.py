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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
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


def local_apply(fn, specs: Sequence, *args, n_out: int = 1,
                out_specs: Optional[Sequence] = None):
    """``fn(*args)``, on each rank's own shards where the arguments are
    DTensors: each DTensor argument is laid out by its spec in ``specs``
    (cleaned for its shape; a spec of ``None`` keeps the argument's own
    placements), other arguments pass as they are, and the ``n_out``
    outputs come back as DTensors in the first argument's placements, or
    each in its spec of ``out_specs`` (an axis kept only where it shards
    an argument). The counterpart of GSPMD partitioning a computation
    that needs no collective (rows over ``data``, heads over ``model``):
    DTensor then neither plans each op nor meets ops it has no sharded
    rule for. A body that does need one issues it itself, over
    ``mesh.get_group(dim)``. With plain tensors it is ``fn(*args)``."""
    if not isinstance(args[0], DTensor):
        return fn(*args)
    mesh = args[0].device_mesh
    laid, pls = [], []
    for a, spec in zip(args, specs):
        pl = None
        if isinstance(a, DTensor):
            pl = (tuple(a.placements) if spec is None else
                  placements(_clean_spec(mesh, spec, a.shape), mesh))
            if tuple(a.placements) != pl:
                a = a.redistribute(mesh, pl)
        laid.append(a)
        pls.append(pl)
    # an argument whole on a mesh dim that splits another (a weight
    # beside split rows, K beside split query heads) gets on each rank
    # only that rank's share of its gradient: pending sums there
    split = {i for pl in pls if pl is not None
             for i, p in enumerate(pl) if isinstance(p, Shard)}
    for j, (a, pl) in enumerate(zip(laid, pls)):
        whole = tuple(i for i in sorted(split) if pl is not None
                      and not isinstance(pl[i], Shard))
        if whole and a.requires_grad:
            laid[j] = _PartialGrad.apply(a, whole)
    if out_specs is None:
        outs = (pls[0],) * n_out
    else:
        used = {name for pl in pls if pl is not None
                for name, p in zip(mesh.mesh_dim_names, pl)
                if isinstance(p, Shard)}
        outs = tuple(placements(tuple(_keep_axes(ax, used) for ax in spec),
                                mesh) for spec in out_specs)

    def local(*xs):
        return fn(*(_ContiguousGrad.apply(x) if isinstance(x, torch.Tensor)
                    and x.requires_grad else x for x in xs))

    return local_map(local, out_placements=outs,
                     in_placements=tuple(pls), device_mesh=mesh)(*laid)


def _keep_axes(ax: Optional[str | Tuple[str, ...]],
               used: Sequence[str]) -> Optional[str | Tuple[str, ...]]:
    """A spec entry with only the axis names in ``used``."""
    if ax is None:
        return None
    kept = tuple(a for a in (ax if isinstance(ax, tuple) else (ax,))
                 if a in used)
    return (kept if len(kept) > 1 else kept[0]) if kept else None


def local_value(x):
    """The whole value of ``x`` as a plain tensor on this rank: a
    DTensor's pending sums reduced and every shard gathered (its local
    tensor where it is replicated already); anything else as it is. For
    the small replicated operands (positions, a step counter) a rank-local
    body takes."""
    return replicate_dim(x).to_local() if isinstance(x, DTensor) else x


def all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """``x`` reduced (``"sum"`` or ``"max"``) over the ranks of ``group``
    (a ``ProcessGroup``), waited for: a collective a rank-local body
    issues itself. No gradient flows through it."""
    import torch.distributed._functional_collectives as funcol
    out = funcol.all_reduce(x, op, group)
    return out.wait() if hasattr(out, "wait") else out


def as_dtensor(x, mesh):
    """``x`` as a DTensor over ``mesh``: a plain tensor is taken as every
    rank's equal copy (replicated), as ``implicit_replication`` takes it."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def unshard_batch_axes(x):
    """FSDP's gather of a weight: a DTensor ``x`` with its splits over
    ``pod`` and ``data`` (``param_specs(fsdp=True)``) gathered and its
    ``model`` split kept, just before a product uses it. Its gradient
    comes back reduce-scattered to the split. Left alone, DTensor may
    keep the weight split and gather the activations instead, so every
    ``data`` rank computes the whole batch. Anything else as it is."""
    if not isinstance(x, DTensor):
        return x
    names = x.device_mesh.mesh_dim_names
    want = tuple(Replicate() if names[i] in ("pod", "data") and
                 isinstance(p, Shard) else p
                 for i, p in enumerate(x.placements))
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def shard_dims(x, dim: int) -> Tuple[int, ...]:
    """The mesh dims of more than one rank over which DTensor ``x``
    shards its tensor dim ``dim`` (major first); ``()`` for a plain
    tensor."""
    if not isinstance(x, DTensor):
        return ()
    dim %= x.ndim
    return tuple(i for i, p in enumerate(x.placements)
                 if isinstance(p, Shard) and p.dim == dim
                 and x.device_mesh.size(i) > 1)


def shard_index(mesh, dims: Sequence[int]) -> int:
    """This rank's block of a tensor dim split over mesh ``dims`` (major
    first), as ``Shard`` numbers the blocks: ``0`` with no dim."""
    coord = mesh.get_coordinate()
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + coord[i]
    return idx


def reduce_grad(x):
    """``x`` itself, whose gradient comes back with its pending sums
    reduced (a DTensor's ``Partial`` placements made ``Replicate``):
    Megatron's ``f`` at the input of a column-split projection, where the
    gradients of every head's or column's slice add up. Without it the
    pending sums flow down the residual stream, and a later product of
    such a gradient with a column-split weight has DTensor gather the
    weight and compute every column on every rank. A plain tensor comes
    back as it is."""
    return _ReduceGrad.apply(x) if isinstance(x, DTensor) else x


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return reduce_sums(grad)


def reduce_sums(x, dim: Optional[int] = None):
    """A DTensor ``x`` with its pending sums reduced (``Partial`` made
    ``Replicate``; with ``dim``, reduce-scattered onto tensor dim
    ``dim``), its shards kept; anything else as it is."""
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    to = Replicate() if dim is None else Shard(dim % x.ndim)
    return x.redistribute(x.device_mesh, tuple(
        to if p.is_partial() else p for p in x.placements))


class _PartialGrad(torch.autograd.Function):
    """Identity on a DTensor whose gradient, on each rank, is that rank's
    share only along mesh ``dims``: the gradient is handed on as pending
    sums (``Partial``) there, which DTensor reduces where it must."""

    @staticmethod
    def forward(ctx, x, dims):
        ctx.dims = dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        pls = tuple(Partial() if i in ctx.dims else p
                    for i, p in enumerate(grad.placements))
        return DTensor.from_local(grad.to_local(), grad.device_mesh, pls,
                                  run_check=False, shape=grad.shape,
                                  stride=grad.stride()), None


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
