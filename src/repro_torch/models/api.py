"""Uniform model interface used by the serving and training paths.

Every family implements:
  init(generator, device=None) -> params   (device="meta": shapes only)
  prefill(params, batch, capacity=None) -> (last_logits (B, V), cache)
  decode(params, cache, batch) -> (logits (B, V), cache)
  init_cache(batch_size, capacity, device) -> zeroed cache
  loss(params, batch) -> (scalar loss, metrics)   (training)

and, where ``supports_paged_kv``, the paged cache protocol
(``init_paged_pool``, ``paged_prefill``, ``paged_prefill_suffix``,
``paged_decode``); where ``supports_verify``, the speculative verify
protocol (``verify``, and ``paged_verify`` with the paged layout).
"""
from __future__ import annotations

from .common import ArchConfig


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
