"""Uniform model interface used by the serving and training paths.

Every family implements:
  init(generator, device=None) -> params   (device="meta": shapes only)
  prefill(params, batch, capacity=None) -> (last_logits (B, V), cache)
  decode(params, cache, batch) -> (logits (B, V), cache)
  init_cache(batch_size, capacity, device) -> zeroed cache
  loss(params, batch) -> (scalar loss, metrics)   (training)

and, shared, the dry run's shapes: ``cache_shapes``, ``input_shapes``
and ``supports``, and ``new_cache`` (a prefill's zeroed cache, laid out
over the mesh of a sharded prefill).

and, where ``supports_paged_kv``, the paged cache protocol
(``init_paged_pool``, ``paged_prefill``, ``paged_prefill_suffix``,
``paged_decode``); where ``supports_verify``, the speculative verify
protocol (``verify``, and ``paged_verify`` with the paged layout).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from .common import ArchConfig, ShapeConfig, dt


class BaseModel:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg

    def init(self, generator, device=None):
        raise NotImplementedError

    def param_shapes(self):
        """The params tree on the ``meta`` device: every leaf's shape and
        dtype, with no storage allocated and nothing drawn."""
        return self.init(None, device="meta")

    def prefill(self, params, batch, capacity=None):
        raise NotImplementedError

    def decode(self, params, cache, batch):
        raise NotImplementedError

    def init_cache(self, batch_size: int, capacity: int, device=None):
        raise NotImplementedError

    def loss(self, params, batch):
        raise NotImplementedError

    # -- paged KV cache protocol (opt-in per family) ------------------------
    @property
    def supports_paged_kv(self) -> bool:
        """Whether this family implements the paged cache protocol
        (``init_paged_pool`` / ``paged_prefill`` / ``paged_prefill_suffix``
        / ``paged_decode``)."""
        return False

    def init_paged_pool(self, n_pages: int, page: int, device=None):
        raise NotImplementedError(
            f"{type(self).__name__} does not support the paged KV layout")

    def paged_prefill(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} does not support the paged KV layout")

    def paged_prefill_suffix(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} does not support the paged KV layout")

    def paged_decode(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} does not support the paged KV layout")

    # -- speculative verify protocol (opt-in per family) ---------------------
    @property
    def supports_verify(self) -> bool:
        """Whether this family scores a (B, k+1) draft window in one pass
        (``verify`` / ``paged_verify``). Recurrent families do not: their
        state cannot roll back a rejected suffix."""
        return False

    def verify(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} does not implement the speculative "
            "verify protocol")

    def paged_verify(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} does not implement the speculative "
            "verify protocol")

    # -- shapes ------------------------------------------------------------
    def cache_capacity(self, seq_len: int) -> int:
        w = self.cfg.sliding_window
        return min(seq_len, w) if w else seq_len

    def cache_shapes(self, batch_size: int, capacity: int):
        """The cache tree on the ``meta`` device: shapes and dtypes only."""
        return self.init_cache(batch_size, capacity, device="meta")

    def new_cache(self, batch_size: int, capacity: int, like):
        """A prefill's zeroed cache: ``init_cache`` on ``like``'s device, or,
        where ``like`` (an activation of the prefill) is a DTensor,
        DTensors over its mesh laid out by ``cache_specs``, each rank
        holding only its shard."""
        if not isinstance(like, DTensor):
            return self.init_cache(batch_size, capacity, device=like.device)
        from ..sharding.rules import cache_specs, zeros_laid_out
        mesh = like.device_mesh
        shapes = self.cache_shapes(batch_size, capacity)
        return zeros_laid_out(shapes, cache_specs(shapes, mesh, batch_size),
                              mesh, like.to_local().device)

    def input_shapes(self, sc: ShapeConfig) -> Dict[str, torch.Tensor]:
        """Default token-LM inputs on the ``meta`` device; multimodal
        families override."""
        B, S = sc.global_batch, sc.seq_len

        def f(*shape):
            return torch.empty(shape, dtype=torch.int32, device="meta")

        if sc.mode == "train":
            return {"tokens": f(B, S), "labels": f(B, S)}
        if sc.mode == "prefill":
            return {"tokens": f(B, S)}
        return {"token": f(B, 1)}

    def supports(self, sc: ShapeConfig) -> Tuple[bool, str]:
        """Whether this (arch, shape) combo is runnable (long_500k gating)."""
        if sc.name == "long_500k" and self.cfg.family in (
                "dense", "moe", "vlm", "encdec"):
            if not self.cfg.sliding_window:
                return False, ("full-attention arch at 500k decode "
                               "(quadratic KV) — skipped per assignment; "
                               "use --swa-window variant")
        return True, ""


_REGISTRY = {}


def register_family(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def build_model(cfg: ArchConfig) -> BaseModel:
    from . import dense, encdec, rwkv6, zamba  # noqa: F401  (registration)
    if cfg.family not in _REGISTRY:
        raise ValueError(f"unknown family {cfg.family!r}")
    return _REGISTRY[cfg.family](cfg)
