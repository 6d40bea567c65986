"""Kernel 2: fine-assignment cosine scores (the paper's FA metric).

    zn = z * rsqrt(sum(z^2) + eps),  cn likewise,  sim = zn @ cn^T,
    masked classes = -inf

Two entries, one kernel body:

* ``cosine_scores(z, centroids, mask)`` — the TPU kernel's signature:
  every row against one expert's centroids (M, h).
* ``cosine_fine(z, centroids, mask, expert)`` — every row against its
  own expert's centroids, read in place from the matcher's stacked
  (K, M, h) tensor, and the row's best class: the reference matcher's
  ``fine_scores`` / ``assign_fine`` (``centroids[expert_idx]``, then
  argmax) in one launch. The router sends a whole route chunk through
  it.

Source note:

* Replaces ``src/repro/kernels/cosine_topk.py:cosine_scores_pallas``
  (body ``_kernel``), reached through ``ops.cosine_scores``, and the
  argmax after it. Despite the file name (kept so the two packages
  mirror), there is no top-k.
* Bound on the H100 at the main path's shapes (a route chunk of ~40
  rows, K = 6, M = 10, h = 128, f32): bytes, ~40 KB, far below a
  microsecond, so the launch and the round trips to device memory are
  the cost.
* Design: a CUDA kernel, one warp per row, no shared memory and no
  barrier: a lane starts the loads of its z slice, its slice of each of
  the row's centroids and the mask before any arithmetic, and one
  reduce-scatter butterfly yields the row's z norm, centroid norms and
  dot products;
  the argmax is a warp max over order-preserving keys (ties to the
  lower index). The kernel scales the raw dot product, ``(z.c * rz) *
  rc``, where the plain version below (and the TPU kernel) normalise
  first; the two agree to f32 rounding. The norms keep the TPU kernel's
  ``rsqrt(sum + eps)`` form, which differs from a ``max(norm,
  sqrt(eps))`` clamp near zero norm, where the router's zero padding
  rows sit.
* Measured time: see ``PERF.md`` (``chip_smoke.py`` on the H100).

CUDA source: ``csrc/cosine_scores.cu``. On a CPU tensor each wrapper
runs the plain PyTorch version below; on a CUDA tensor it launches the
kernel or raises. Both count on ``cosine_scores.launches``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .build import check, library

EPS = 1e-12


def cosine_fine_plain(z: torch.Tensor, centroids: torch.Tensor,
                      mask: torch.Tensor, expert: torch.Tensor,
                      eps: float = EPS
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: z (R, h), centroids (K, M, h), mask (K, M),
    expert (R,) -> (scores (R, M), cls (R,) int64): each row's cosine
    against its own expert's centroids, masked classes exactly -inf, and
    the first index of the row's maximum."""
    e = expert.long()
    zn = z * torch.rsqrt(z.square().sum(dim=-1, keepdim=True) + eps)
    c = centroids[e]                                     # (R, M, h)
    cn = c * torch.rsqrt(c.square().sum(dim=-1, keepdim=True) + eps)
    sim = (cn * zn[:, None, :]).sum(dim=-1)
    sim = torch.where(mask[e] > 0, sim, torch.full_like(sim, float("-inf")))
    return sim, torch.argmax(sim, dim=-1)


def cosine_scores_plain(z: torch.Tensor, centroids: torch.Tensor,
                        mask: torch.Tensor, eps: float = EPS
                        ) -> torch.Tensor:
    """Plain PyTorch version: z (B, h), centroids (M, h), mask (M,) ->
    (B, M) cosine similarity, masked classes exactly -inf."""
    expert = torch.zeros(z.shape[0], dtype=torch.long, device=z.device)
    return cosine_fine_plain(z, centroids[None], mask[None], expert, eps)[0]


def _launch(fn: str, z: torch.Tensor, centroids: torch.Tensor,
            mask: torch.Tensor, expert: Optional[torch.Tensor],
            with_cls: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Check (R, h) z, (K, M, h) centroids, (K, M) mask and (R,) expert
    on one CUDA card, launch, and count the launch."""
    if z.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {z.device}")
    R, h = z.shape
    K, M = centroids.shape[:2]
    mask = mask.to(torch.float32).contiguous()
    if centroids.shape != (K, M, h) or mask.shape != (K, M) or (
            expert is not None and expert.shape != (R,)):
        raise ValueError(
            f"{fn}: shape mismatch z {tuple(z.shape)} centroids "
            f"{tuple(centroids.shape)} mask {tuple(mask.shape)}"
            + ("" if expert is None else f" expert {tuple(expert.shape)}"))
    for name, t in (("z", z), ("centroids", centroids), ("mask", mask)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != z.device:
            raise ValueError(f"{fn}: {name} must be contiguous f32 on "
                             f"{z.device}")
    if expert is not None:
        expert = expert.to(torch.int32).contiguous()
        if expert.device != z.device:
            raise ValueError(f"{fn}: expert must be on {z.device}")
    out = torch.empty((R, M), dtype=torch.float32, device=z.device)
    cls = (torch.empty((R,), dtype=torch.int64, device=z.device)
           if with_cls else None)
    # the library launches on the current device: the tensors' one
    with torch.cuda.device(z.device):
        rc = library().cosine_fine_f32(
            z.data_ptr(), centroids.data_ptr(), mask.data_ptr(),
            None if expert is None else expert.data_ptr(), out.data_ptr(),
            None if cls is None else cls.data_ptr(), R, K, M, h, EPS,
            torch.cuda.current_stream(z.device).cuda_stream)
    check(rc, fn)
    cosine_scores.launches += 1
    return out, cls


def cosine_fine(z: torch.Tensor, centroids: torch.Tensor,
                mask: torch.Tensor, expert: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores (R, M), cls (R,) int64) of bottleneck rows z (R, h), each
    against its own expert's centroids ``centroids[expert]`` of the
    stacked (K, M, h) tensor, with ``mask`` (K, M); ``expert`` (R,) holds
    indices in [0, K). ``cls`` is the first index of the row's maximum,
    0 for a row whose classes are all masked."""
    if z.device.type == "cpu":
        return cosine_fine_plain(z, centroids, mask, expert)
    return _launch("cosine_fine", z, centroids, mask, expert, True)


def cosine_scores(z: torch.Tensor, centroids: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """(B, M) masked cosine scores of bottleneck rows vs class centroids
    (M, h): ``cosine_fine``'s body with one expert."""
    if z.device.type == "cpu":
        return cosine_scores_plain(z, centroids, mask)
    return _launch("cosine_scores", z, centroids[None], mask[None], None,
                   False)[0]


cosine_scores.launches = 0
