"""Leading-axis sharding: the layout contract of banked expert serving.

The reference's ``leading_sharding`` splits every leaf's leading dim
over a mesh axis with a ``NamedSharding``: expert-stacked params, caches
and token planes all carry the expert index as dim 0, so one spec
places the whole bank. The port has no sharded array type; it keeps one
tensor per mesh position instead, so the contract reduces to which
position each member of the leading axis lives on.
"""
from __future__ import annotations

from typing import Optional, Tuple


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
