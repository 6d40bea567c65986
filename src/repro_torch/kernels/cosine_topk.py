"""Kernel 2: fine-assignment cosine scores (the paper's FA metric).

    zn = z * rsqrt(sum(z^2) + eps),  cn likewise,  sim = zn @ cn^T,
    masked classes = -inf

Source note:

* Replaces ``src/repro/kernels/cosine_topk.py:cosine_scores_pallas``
  (body ``_kernel``), reached through ``ops.cosine_scores``. Despite the
  file name (kept so the two packages mirror), there is no top-k: the
  router takes the argmax.
* Bound on the H100 at the main path's shapes (one expert group's
  rows, a power-of-two bucket <= 32, h = 128, M = 10, f32): bytes, a few
  KB — far below a microsecond, so the launch itself dominates.
* Design: a CUDA kernel (one build route for the port's three kernels,
  no Triton dependency): one block normalises the M centroids into
  shared memory once, then one warp per row reduces its norm and its M
  dot products with shuffles. The normalisation keeps the TPU kernel's
  ``rsqrt(sum + eps)`` form, which differs from a ``max(norm,
  sqrt(eps))`` clamp near zero norm, where the router's zero padding rows
  sit.
* Measured time: see ``PERF.md`` (``chip_smoke.py`` on the H100).

CUDA source: ``csrc/cosine_scores.cu``. On a CPU tensor the wrapper runs
the plain PyTorch version below; on a CUDA tensor it launches the kernel
or raises.
"""
from __future__ import annotations

import torch

from .build import check, library

EPS = 1e-12


def cosine_scores_plain(z: torch.Tensor, centroids: torch.Tensor,
                        mask: torch.Tensor, eps: float = EPS
                        ) -> torch.Tensor:
    """Plain PyTorch version: z (B, h), centroids (M, h), mask (M,) ->
    (B, M) cosine similarity, masked classes exactly -inf."""
    zn = z * torch.rsqrt(z.square().sum(dim=-1, keepdim=True) + eps)
    cn = centroids * torch.rsqrt(
        centroids.square().sum(dim=-1, keepdim=True) + eps)
    sim = zn @ cn.T
    return torch.where(mask[None, :] > 0, sim,
                       torch.full_like(sim, float("-inf")))


def cosine_scores(z: torch.Tensor, centroids: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """(B, M) masked cosine scores of bottleneck rows vs class centroids."""
    if z.device.type == "cpu":
        return cosine_scores_plain(z, centroids, mask)
    if z.device.type != "cuda":
        raise ValueError(f"cosine_scores: unsupported device {z.device}")
    B, h = z.shape
    M = centroids.shape[0]
    mask = mask.to(torch.float32).contiguous()
    if centroids.shape != (M, h) or mask.shape != (M,):
        raise ValueError(f"cosine_scores: shape mismatch z {tuple(z.shape)} "
                         f"centroids {tuple(centroids.shape)} "
                         f"mask {tuple(mask.shape)}")
    for name, t in (("z", z), ("centroids", centroids), ("mask", mask)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != z.device:
            raise ValueError(f"cosine_scores: {name} must be contiguous f32 "
                             f"on {z.device}")
    out = torch.empty((B, M), dtype=torch.float32, device=z.device)
    rc = library().cosine_scores_f32(
        z.data_ptr(), centroids.data_ptr(), mask.data_ptr(), out.data_ptr(),
        B, M, h, EPS, torch.cuda.current_stream(z.device).cuda_stream)
    check(rc, "cosine_scores")
    cosine_scores.launches += 1
    return out


cosine_scores.launches = 0
