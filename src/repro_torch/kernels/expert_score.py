"""Kernel 1: fused AE-bank routing score (the paper's coarse-match hot path).

For every row and every expert AE k of the bank:

    h    = relu(x @ W1_k + b1_k)        (eval BatchNorm folded into W1/b1)
    xhat = h @ W2_k + b2_k
    out[:, k] = sum((xhat - x)^2) / d_real

Source note:

* Replaces ``src/repro/kernels/expert_score.py:expert_score_pallas``
  (body ``_kernel``), reached through ``ops.expert_score`` /
  ``ops.expert_score_folded`` with the fold ``ops.fold_bank``.
* Bound on the H100 at the main path's shapes (B = 32 router rows,
  K = 6, D = 784, H = 128, f32): bytes, barely — 4.9 MB of inputs over
  3.35 TB/s (1.5 us) against 77 MFLOP of f32 FMA work over 67 TFLOP/s
  (1.15 us); the two are close, so it sits near the ridge.
* Design: a cluster of 8 blocks per (8-row tile, expert): each block
  computes 1/8 of h's columns, the cluster gathers h through distributed
  shared memory, then each block streams 1/8 of W2's columns and rank 0
  adds the partial errors; h and xhat never reach device memory. The
  TPU's 784 -> 896 lane padding is dropped (loops run to D = 784 =
  49 * 16) and the sum is divided by the real D.
* Measured time: see ``PERF.md`` (``chip_smoke.py`` on the H100).

CUDA source: ``csrc/expert_score.cu``. On a CPU tensor the wrapper runs
the plain PyTorch version below; on a CUDA tensor it launches the kernel
or raises.
"""
from __future__ import annotations

from typing import Dict

import torch

from .build import check, library

BN_EPS = 1e-5


def fold_bank(bank_params: Dict[str, torch.Tensor],
              bank_states: Dict[str, torch.Tensor],
              eps: float = BN_EPS) -> Dict[str, torch.Tensor]:
    """Fold eval-mode BN into (W1, b1): the eps is the autoencoder's.

    Returns dict(w1 (K, D, H), b1 (K, H), w2 (K, H, D), b2 (K, D)),
    contiguous; unlike the TPU fold, D is not lane-padded.
    """
    scale = bank_params["bn_scale"] * torch.rsqrt(
        bank_states["var"] + eps)                       # (K, H)
    w1 = bank_params["w_enc"] * scale[:, None, :]
    b1 = (bank_params["b_enc"] - bank_states["mean"]) * scale \
        + bank_params["bn_bias"]
    return {"w1": w1.contiguous(), "b1": b1.contiguous(),
            "w2": bank_params["w_dec"].contiguous(),
            "b2": bank_params["b_dec"].contiguous()}


def expert_score_plain(folded: Dict[str, torch.Tensor], x: torch.Tensor
                       ) -> torch.Tensor:
    """Plain PyTorch version: x (B, D) -> (B, K) per-row MSE."""
    w1, b1, w2, b2 = folded["w1"], folded["b1"], folded["w2"], folded["b2"]
    h = torch.relu(torch.einsum("bd,kdh->kbh", x, w1) + b1[:, None, :])
    xhat = torch.einsum("kbh,khd->kbd", h, w2) + b2[:, None, :]
    mse = (xhat - x[None]).square().sum(dim=-1) / x.shape[-1]
    return mse.T.contiguous()


def expert_score_folded(folded: Dict[str, torch.Tensor], x: torch.Tensor
                        ) -> torch.Tensor:
    """x: (B, D) f32 -> (B, K) reconstruction MSE under every folded AE."""
    if x.device.type == "cpu":
        return expert_score_plain(folded, x)
    if x.device.type != "cuda":
        raise ValueError(f"expert_score: unsupported device {x.device}")
    w1, b1, w2, b2 = folded["w1"], folded["b1"], folded["w2"], folded["b2"]
    B, D = x.shape
    K, D1, H = w1.shape
    if D1 != D or w2.shape != (K, H, D) or b1.shape != (K, H) \
            or b2.shape != (K, D):
        raise ValueError(f"expert_score: shape mismatch x {tuple(x.shape)} "
                         f"w1 {tuple(w1.shape)} w2 {tuple(w2.shape)}")
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2),
                    ("b2", b2)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"expert_score: {name} must be contiguous f32 "
                             f"on {x.device}")
    out = torch.empty((B, K), dtype=torch.float32, device=x.device)
    rc = library().expert_score_f32(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), B, D, H, K,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(rc, "expert_score")
    expert_score_folded.launches += 1
    return out


expert_score_folded.launches = 0


def expert_score(bank_params, x, bank_states=None) -> torch.Tensor:
    """Convenience entry used by ``MatcherConfig(use_kernel=True)``:
    fold the bank's BN statistics (identity stats when None), then score."""
    if bank_states is None:
        K, _, H = bank_params["w_enc"].shape
        z = bank_params["w_enc"].new_zeros((K, H))
        bank_states = {"mean": z, "var": torch.ones_like(z)}
    return expert_score_folded(fold_bank(bank_params, bank_states), x)
