"""Path/name-based parameter specs, the reference's ``sharding/rules.py``.

Given a tree of param shapes (a model's ``param_shapes()``, or its
params) and a mesh, produce a matching tree of ``Spec``s. Rules are
keyed on the leaf name and expressed over the *trailing* dims
(layer-stacked params get leading ``None`` padding automatically). Every
sharded dim is checked for divisibility by the mesh-axis size; the first
valid candidate wins, else the leaf is replicated.

``fsdp=True`` additionally shards the largest replicated dim of every big
matrix over the ``data`` axis (ZeRO-3 / FSDP style).

A ``Spec`` is the port's ``PartitionSpec``: a tuple, one entry a tensor
dim, each ``None`` (replicated), an axis name, or a tuple of axis names
sharding that dim major first. ``placements`` turns one into DTensor
placements over a ``DeviceMesh`` and ``distribute`` lays a tree out by
its specs, the counterpart of ``named`` plus ``jax.device_put``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from ..tree import leaves, unflatten
from .context import Spec, mesh_shape, placements

# leaf name -> ordered candidates over trailing dims
_RULES: Dict[str, Sequence[Tuple]] = {
    # embeddings
    "embed": [("model", None), (None, "model")],
    "unembed": [(None, "model"), ("model", None)],
    "stub_proj": [(None, "model")],
    # attention
    "wq": [(None, "model")],
    "wk": [(None, "model")],
    "wv": [(None, "model")],
    "bq": [("model",)],
    "bk": [("model",)],
    "bv": [("model",)],
    "wo": [("model", None)],
    # dense mlp: trailing (D, F) / (F, D)
    "w_gate": [(None, "model")],
    "w_up": [(None, "model")],
    "w_down": [("model", None)],
    # moe experts: trailing (E, D, F) / (E, F, D) — expert-parallel over the
    # model axis when E divides it, else tensor-parallel within experts
    "moe/w_gate": [("model", None, None), (None, None, "model")],
    "moe/w_up": [("model", None, None), (None, None, "model")],
    "moe/w_down": [("model", None, None), (None, "model", None)],
    "router": [()],
    # mamba2
    "w_in_x": [(None, "model")],
    "w_in_z": [(None, "model")],
    "w_B": [()],
    "w_C": [()],
    "w_dt": [(None, "model")],
    "conv_x": [(None, "model")],
    "A_log": [("model",)],
    "D_skip": [("model",)],
    "dt_bias": [("model",)],
    "ssm_norm": [("model",)],
    "w_out": [("model", None)],
    # rwkv6
    "w_r": [(None, "model")],
    "w_kk": [(None, "model")],
    "w_vv": [(None, "model")],
    "w_g": [(None, "model")],
    "w_o2": [("model", None)],
    "decay_w0": [("model", None)],
    "first_u": [("model", None)],
    "w_ch_k": [(None, "model")],
    "w_ch_v": [("model", None)],
    "w_ch_r": [()],
}

_REPLICATED_SUFFIXES = (
    "ln", "scale", "bias", "norm", "mu", "lora", "maa", "pos_embed",
)


def divisible(dim: int, axes, mesh_shape: Dict[str, int]) -> bool:
    axes = axes if isinstance(axes, tuple) else (axes,)
    total = 1
    for a in axes:
        total *= mesh_shape.get(a, 1)
    return total <= dim and dim % total == 0


def _candidate_ok(shape, cand, mesh_shape) -> bool:
    if len(cand) > len(shape):
        return False
    trail = shape[len(shape) - len(cand):]
    for dim, ax in zip(trail, cand):
        if ax is not None and not divisible(dim, ax, mesh_shape):
            return False
    return True


def _apply_fsdp(shape, spec: Tuple, mesh_shape, min_size: int) -> Tuple:
    """Shard the largest un-sharded dim over 'data' for big params."""
    if int(np.prod(shape)) < min_size or "data" not in mesh_shape:
        return spec
    spec = list(spec)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if spec[i] is None and divisible(shape[i], "data", mesh_shape):
            spec[i] = "data"
            return tuple(spec)
    return tuple(spec)


def spec_for_leaf(name: str, shape, mesh_shape: Dict[str, int], *,
                  fsdp: bool = False, fsdp_min_size: int = 1 << 20) -> Spec:
    shape = tuple(shape)
    parts = name.split("/")
    leaf = parts[-1]
    qualified = "/".join(parts[-2:]) if len(parts) >= 2 else leaf
    spec: Optional[Tuple] = None
    if any(leaf.endswith(sfx) or sfx in leaf for sfx in _REPLICATED_SUFFIXES):
        spec = (None,) * len(shape)
    else:
        cands = _RULES.get(qualified) or _RULES.get(leaf)
        for cand in (cands or ()):
            if _candidate_ok(shape, cand, mesh_shape):
                spec = (None,) * (len(shape) - len(cand)) + tuple(cand)
                break
    if spec is None:
        spec = (None,) * len(shape)
    if fsdp:
        spec = _apply_fsdp(shape, spec, mesh_shape, fsdp_min_size)
    return Spec(*spec)


def _items(node):
    """(key, child) pairs in ``tree.leaves``'s order."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def leaf_paths(tree: Any) -> List[str]:
    """Each leaf's path, its dict keys and list indices joined by ``/``
    (the reference's ``_path_str``), in ``tree.leaves``'s order."""
    items = _items(tree)
    if items is None:
        return [""]
    return [f"{k}/{p}" if p else str(k)
            for k, child in items for p in leaf_paths(child)]


def map_with_path(fn, tree: Any) -> Any:
    """``fn(path, leaf)`` over every leaf, shaped as ``tree``."""
    return unflatten(tree, [fn(p, x) for p, x in
                            zip(leaf_paths(tree), leaves(tree))])


def param_specs(shape_tree: Any, mesh, *, fsdp: bool = False) -> Any:
    """Tree of ``Spec`` matching ``shape_tree`` (leaves with ``.shape``)."""
    ms = mesh_shape(mesh)
    return map_with_path(lambda path, x: spec_for_leaf(
        path, x.shape, ms, fsdp=fsdp), shape_tree)


def batch_spec(shape_tree: Any, mesh) -> Any:
    """Shard the leading (batch) dim over (pod, data); replicate the rest.
    Scalars and dims not divisible stay replicated."""
    ms = mesh_shape(mesh)
    baxes = tuple(a for a in ("pod", "data") if a in ms)

    def leaf(x):
        shape = tuple(x.shape)
        if not shape:
            return Spec()
        if baxes and divisible(shape[0], baxes, ms):
            return Spec(baxes if len(baxes) > 1 else baxes[0],
                        *([None] * (len(shape) - 1)))
        # long-context single-sequence caches: shard the seq dim over data
        if len(shape) >= 2 and "data" in ms and \
                divisible(shape[1], "data", ms):
            return Spec(None, "data", *([None] * (len(shape) - 2)))
        return Spec(*([None] * len(shape)))

    return unflatten(shape_tree, [leaf(x) for x in leaves(shape_tree)])


# ---------------------------------------------------------------------------
# Decode-cache specs (name + shape heuristics per cache family)
# ---------------------------------------------------------------------------

_CACHE_KV = ("k", "v", "xk", "xv", "attn_k", "attn_v")
_CACHE_HEADED = ("ssm", "S")  # (L, B, H, ...)


def cache_specs(shape_tree, mesh, batch_size: int):
    """Specs for decode caches.

    KV caches (L, B, C, KV, dh): batch over (pod, data); KV heads over
    model when divisible. For batch=1 long-context decode the *sequence*
    dim is sharded over data instead (sequence-parallel cache).
    SSM/WKV states (L, B, H, ...): batch over data, heads over model.
    """
    ms = mesh_shape(mesh)
    baxes = tuple(a for a in ("pod", "data") if a in ms)
    batch_ok = baxes and divisible(batch_size, baxes, ms)

    def leaf(path, x):
        name = path.split("/")[-1]
        shape = tuple(x.shape)
        nd = len(shape)
        if nd == 0 or name in ("pos", "attn_pos", "t"):
            return Spec(*([None] * nd))
        spec = [None] * nd
        if name in _CACHE_KV and nd == 5:  # (L, B, C, KV, dh)
            if batch_ok:
                spec[1] = baxes if len(baxes) > 1 else baxes[0]
            elif divisible(shape[2], "data", ms):
                spec[2] = "data"
            if divisible(shape[3], "model", ms):
                spec[3] = "model"
            elif spec[2] is None and divisible(shape[2], "model", ms):
                # GQA kv-heads don't divide the model axis: shard the cache
                # *sequence* dim instead (flash-style partial softmax)
                spec[2] = "model"
            elif spec[2] == "data" and divisible(
                    shape[2] // ms.get("data", 1), "model", ms):
                spec[2] = ("data", "model")
        elif nd >= 3:  # states: (L, B, H, ...), conv: (L, B, W-1, C)
            if batch_ok:
                spec[1] = baxes if len(baxes) > 1 else baxes[0]
            # shard the largest remaining dim over model if divisible
            rest = sorted(range(2, nd), key=lambda i: -shape[i])
            for i in rest:
                if divisible(shape[i], "model", ms):
                    spec[i] = "model"
                    break
        elif nd == 2 and batch_ok:  # (B, ...) token buffers
            if divisible(shape[0], baxes, ms):
                spec[0] = baxes if len(baxes) > 1 else baxes[0]
        return Spec(*spec)

    return map_with_path(leaf, shape_tree)


# ---------------------------------------------------------------------------
# Layout over a DeviceMesh
# ---------------------------------------------------------------------------


def distribute(tree: Any, specs: Any, mesh) -> Any:
    """``tree``'s leaves as DTensors laid out over ``mesh`` by ``specs``
    (a tree of the same structure). Every rank passes the same values;
    each keeps only its own shard."""
    return unflatten(tree, [
        distribute_tensor(x, mesh, placements(s, mesh))
        for x, s in zip(leaves(tree), leaves_of_specs(specs))])


def local_shape(shape, pls, mesh) -> Tuple[int, ...]:
    """One rank's shard of a ``shape`` laid out by placements ``pls`` over
    ``mesh`` (the specs split every dim evenly)."""
    out = list(shape)
    for i, p in enumerate(pls):
        if isinstance(p, Shard):
            out[p.dim] //= mesh.size(i)
    return tuple(out)


def laid_out(tree: Any, specs: Any, mesh, make, device=None) -> Any:
    """DTensors shaped as ``tree``'s leaves (tensors or ``meta`` tensors:
    their shapes and dtypes), laid out over ``mesh`` by ``specs``: each
    rank allocates only its shard, ``make(shape, dtype=, device=)``
    (``torch.zeros``, or ``torch.empty`` under a fake tensor mode). No
    collective and no data moves."""
    device = device or mesh.device_type

    def one(x, spec):
        pls = placements(spec, mesh)
        local = make(local_shape(x.shape, pls, mesh), dtype=x.dtype,
                     device=device)
        return DTensor.from_local(local, mesh, pls, run_check=False,
                                  shape=tuple(x.shape),
                                  stride=_strides(tuple(x.shape)))

    return unflatten(tree, [one(x, s) for x, s in
                            zip(leaves(tree), leaves_of_specs(specs))])


def zeros_laid_out(tree: Any, specs: Any, mesh, device=None) -> Any:
    """``laid_out`` with zeros."""
    return laid_out(tree, specs, mesh, torch.zeros, device)


def _strides(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    out, n = [], 1
    for d in reversed(shape):
        out.append(n)
        n *= max(d, 1)
    return tuple(reversed(out))


def leaves_of_specs(specs: Any) -> List[Spec]:
    """The ``Spec`` leaves of a spec tree in ``tree.leaves``'s order (a
    ``Spec`` is a tuple, so ``tree.leaves`` would walk into it)."""
    if isinstance(specs, Spec):
        return [specs]
    return [s for _, child in _items(specs) for s in leaves_of_specs(child)]


__all__ = ["Spec", "batch_spec", "cache_specs", "distribute", "divisible",
           "laid_out", "leaf_paths", "leaves_of_specs", "local_shape",
           "map_with_path", "param_specs", "placements", "spec_for_leaf",
           "zeros_laid_out"]
