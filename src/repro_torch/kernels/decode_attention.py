"""Kernel 3: GQA flash-decode of one query token per row against a ring
KV cache — one launch per layer of every decode step.

For each (row, kv head), the G = H / KV query heads take a softmax over
the S cache slots, masked by slot position: ``kv_pos >= 0``,
``kv_pos <= q_pos`` and, with a window, ``kv_pos > q_pos - window``.

Source note:

* Replaces ``src/repro/kernels/decode_attention.py:
  decode_attention_pallas`` (body ``_kernel``), reached through
  ``ops.decode_attention``. (The reference's serving decode calls its
  plain ``attention`` instead; the port's decode takes the kernel.)
* Bound on the H100 at the main path's shapes (``llama3_2_1b``: H 32,
  KV 8, dh 64, S = max_len 256, B = batch bucket <= 16, bf16): bytes —
  about 1 flop per byte of the live slots' K/V. The main path fills at
  most 79 of the 256 slots (a prompt bucket <= 64 plus 15 decode
  steps), so at B = 8 it must read 1.3 MB per launch, 0.39 us at
  3.35 TB/s: few enough bytes that memory latency, not bandwidth, sets
  the kernel's time.
* Design: the S axis is split over a thread-block cluster of
  ``decode_split(B, KV, S, n_sm)`` blocks per (row, kv head), so a long
  cache's tiles spread over the SMs (a 256-slot cache is not split).
  Each block reads ``kv_pos`` once, keeps one ballot word per 32-slot
  tile and deals the tiles with a live slot (every tile when none is)
  over the cluster's ranks; it stages its tiles' K/V in shared memory
  with 16-byte ``cp.async`` copies, three tiles deep, and runs the
  online softmax in f32; the ranks combine their partial (m, l, acc)
  through distributed shared memory in rank order, so the result is
  deterministic. bf16 or f32 in, f32 scores and accumulation, output in
  q's dtype. Slot order does not matter (positions, not slots, carry
  the mask).
* Measured time: see ``PERF.md`` (``chip_smoke.py`` on the H100).

CUDA source: ``csrc/decode_attention.cu``. On a CPU tensor the wrapper
runs the plain version (``attention(chunk=0)`` on one query token, as
the reference oracle has it); on a CUDA tensor it launches the kernel or
raises: q, k and v must start on 16 bytes.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.attention import attention
from .build import check, check_aligned, library, sm_count

SUPPORTED_DH = (32, 64, 128)
MAX_GROUP = 16
MAX_SPLIT = 8           # blocks per cluster (the portable maximum)
TILE = 32               # slots per tile
MIN_TILES = 8           # tiles of a full cache each rank must get


def decode_split(B: int, KV: int, S: int, n_sm: int) -> int:
    """Blocks of the cluster that shares one (row, kv head)'s S slots: the
    smallest power of two n with ``B * KV * n >= n_sm``, capped at
    ``MAX_SPLIT`` and so that each rank gets at least ``MIN_TILES`` of
    the ``ceil(S / 32)`` tiles. On an H100 the cluster barrier and the
    combine cost more than a split of fewer tiles saves (PERF.md), so a
    256-slot cache is not split. It depends on these four numbers only,
    so the paged kernel (``S = n_lp * page``) splits as the ring kernel
    does on the gathered view."""
    tiles = -(-S // TILE)
    n = 1
    while 2 * n <= MAX_SPLIT and 2 * n * MIN_TILES <= tiles \
            and B * KV * n < n_sm:
        n *= 2
    return n


def decode_attention_plain(q, k, v, q_pos, kv_pos, *, window: int = 0
                           ) -> torch.Tensor:
    """Plain version. q: (B, H, dh); k/v: (B, S, KV, dh); q_pos ()
    int32; kv_pos (S,) int32 -> (B, H, dh) in q.dtype."""
    o = attention(q[:, None], k, v, q_pos=q_pos.reshape(1), kv_pos=kv_pos,
                  window=window, chunk=0)
    return o[:, 0]


def decode_attention(q, k, v, q_pos, kv_pos, *, window: int = 0
                     ) -> torch.Tensor:
    """Flash-decode one query token per row over a ring cache."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, q_pos, kv_pos, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, H, dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    if k.shape != (B, S, KV, dh) or v.shape != k.shape \
            or q_pos.numel() != 1 or kv_pos.shape != (S,):
        raise ValueError(
            f"decode_attention: shape mismatch q {tuple(q.shape)} k "
            f"{tuple(k.shape)} v {tuple(v.shape)} kv_pos "
            f"{tuple(kv_pos.shape)}")
    if H % KV or H // KV > MAX_GROUP or dh not in SUPPORTED_DH:
        raise ValueError(f"decode_attention: unsupported H={H} KV={KV} "
                         f"dh={dh} (dh in {SUPPORTED_DH}, H/KV <= "
                         f"{MAX_GROUP})")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decode_attention: unsupported dtype {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"decode_attention: {name} must be contiguous "
                             f"{q.dtype} on {q.device}")
    for name, t in (("q_pos", q_pos), ("kv_pos", kv_pos)):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"decode_attention: {name} must be contiguous "
                             f"int32 on {q.device}")
    check_aligned("decode_attention", q=q, k=k, v=v)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    out = torch.empty_like(q)
    # the library launches on the current device: the tensors' one
    with torch.cuda.device(q.device):
        rc = library().decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr(), B, H, KV, S, dh, int(window),
            scale, int(q.dtype == torch.bfloat16),
            decode_split(B, KV, S, sm_count(q.device.index)),
            torch.cuda.current_stream(q.device).cuda_stream)
    check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
