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
  3.35 TB/s (1.47 us) against 77 MFLOP of f32 FMA work over 67 TFLOP/s
  (1.15 us); the two are close, so it sits near the ridge.
* Design: a thread-block cluster of ``n`` blocks per (tile of up to 32
  rows, expert), ``(n, rows) = expert_split(B, D, H, K, active)``, where
  ``active(n, rows)`` is the number of such clusters the card holds at
  once (``max_clusters``): 16 blocks per expert at the main path, 96 in
  all, one wave that reads every weight byte once; 8 at B = 64, where
  the card holds only 7 clusters of 10 to 16 blocks. Rank q owns a
  slice of D cut on 16-byte column groups (``expert_slices``); at entry
  it issues, as asynchronous copies, its x columns, W1 rows and b1
  (phase 1) and its W2 columns and b2 (phase 2), so W2 arrives while
  phase 1 computes.
  Phase 1 forms the slice's partial h; the ranks add the partials in
  rank order through distributed shared memory, each for 1/n of h, and
  send relu(h + b1) to every rank; phase 2 forms xhat on the slice and
  its squared error; rank 0 adds the ranks' per-row errors in rank
  order. h and xhat never reach device memory, and two launches give
  the same bits. The TPU's 784 -> 896 lane padding is dropped and the
  sum is divided by the real D; a ragged last slice or a D or H that
  is not a multiple of 4 takes 4-byte copies inside the kernel.
* Measured time: see ``PERF.md`` (``chip_smoke.py`` on the H100).

CUDA source: ``csrc/expert_score.cu``. On a CPU tensor the wrapper runs
the plain PyTorch version below; on a CUDA tensor it launches the kernel
or raises.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Callable, Dict, List, Tuple

import torch

from .build import check, library

BN_EPS = 1e-5
MAX_RANKS = 16          # blocks per cluster (the non-portable maximum)
MAX_ROWS = 32           # rows per tile
SLICE_FLOATS = 16384    # a rank's W1 (or W2) slice: at most 64 KB


def expert_split(B: int, D: int, H: int, K: int,
                 active: Callable[[int, int], int]) -> Tuple[int, int]:
    """(n, rows): the cluster of ``n`` blocks that shares one (row tile,
    expert)'s D columns, and the rows of a tile (the B rows cut into
    ``ceil(B / 32)`` near-equal tiles). ``active(n, rows)`` is how many
    clusters of ``n`` blocks the card holds at once (``max_clusters``;
    a cluster lives in one GPC, so this is not SMs / n). ``n`` is the
    largest cluster, at most 16 and at most the ``ceil(D / 4)`` 16-byte
    column groups, whose ``K * tiles`` clusters are all resident at once
    (one wave, every weight byte read once per tile), but never so small
    that a rank's W1 slice outgrows ``SLICE_FLOATS``; where no size gives
    one wave, the smallest allowed (the fewest blocks)."""
    tiles = -(-B // MAX_ROWS)
    rows = -(-B // tiles)
    groups = -(-D // 4)
    cap = min(MAX_RANKS, groups)
    per_rank = max(1, SLICE_FLOATS // (4 * (-(-H // 4) * 4)))
    least = min(cap, -(-groups // per_rank))
    for n in range(cap, least, -1):
        if K * tiles <= active(n, rows):
            return n, rows
    return least, rows


@lru_cache(maxsize=None)
def max_clusters(index: int, D: int, H: int, n: int, rows: int) -> int:
    """Clusters of ``n`` blocks at these sizes that CUDA device ``index``
    holds at once (``cudaOccupancyMaxActiveClusters``)."""
    with torch.cuda.device(index):
        count = library().expert_score_max_clusters(D, H, n, rows)
    check(max(0, -count), "expert_score_max_clusters")
    return count


def expert_slices(D: int, n: int) -> List[Tuple[int, int]]:
    """The columns [d0, d1) of D that each of the ``n`` ranks owns, as
    the kernel cuts them: near-equal runs of whole 16-byte groups (only
    the last slice may end on a partial group)."""
    groups = -(-D // 4)
    return [(4 * (q * groups // n), min(4 * ((q + 1) * groups // n), D))
            for q in range(n)]


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
    n, rows = expert_split(
        B, D, H, K, lambda n, r: max_clusters(x.device.index, D, H, n, r))
    out = torch.empty((B, K), dtype=torch.float32, device=x.device)
    # the library launches on the current device: the tensors' one
    with torch.cuda.device(x.device):
        rc = library().expert_score_f32(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), B, D, H, K, n, rows,
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
