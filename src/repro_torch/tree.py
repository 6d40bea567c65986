"""Trees of tensors (nested dicts, lists and tuples), walked in the
reference's leaf order — JAX flattens a dict by sorted key — so sums over
leaves (the global gradient norm) add in the same order, and the
gradient of a function of such a tree.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

import torch

Tree = Any


def _items(node):
    return [(k, node[k]) for k in sorted(node)]


def leaves(tree: Tree) -> List[torch.Tensor]:
    """The leaves of ``tree`` in the reference's order."""
    if isinstance(tree, dict):
        return [leaf for _, v in _items(tree) for leaf in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in leaves(v)]
    return [tree]


def unflatten(tree: Tree, flat) -> Tree:
    """``tree``'s structure (and dict key order) with its leaves replaced,
    in the order ``leaves`` gives them, by the items of ``flat``."""
    it: Iterator = iter(flat)

    def rec(node):
        if isinstance(node, dict):
            done = {k: rec(v) for k, v in _items(node)}
            return {k: done[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        return next(it)

    return rec(tree)


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over corresponding leaves of trees of one structure."""
    cols = [leaves(t) for t in (tree,) + rest]
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])


def value_and_grad(fn: Callable, params: Tree, *args
                   ) -> Tuple[Tuple[torch.Tensor, Any], Tree]:
    """``((loss, aux), grads)`` of ``fn(params, *args) -> (loss, aux)``,
    as ``jax.value_and_grad(fn, has_aux=True)``: the gradient of the
    scalar ``loss`` with respect to every leaf of ``params`` (zeros for a
    leaf ``loss`` does not use), shaped as ``params``. ``params`` is not
    modified: ``fn`` sees detached copies that record the graph; ``loss``
    and the tensors of ``aux`` come back detached from it."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    loss, aux = fn(unflatten(params, flat), *args)
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    return ((loss.detach(), tree_map(torch.Tensor.detach, aux)),
            unflatten(params, grads))
