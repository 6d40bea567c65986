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
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..models.attention import (NEG_INF, _edge_mask, _gqa_av,
                                _gqa_scores, attention)
from ..sharding.context import (all_reduce, local_apply, local_value,
                                shard_dims, shard_index)
from .build import (check, check_aligned, fake_launch, is_fake, library,
                    sm_count)

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


def decode_attention_plain(q, k, v, q_pos, kv_pos, *, window: int = 0,
                           return_lse: bool = False):
    """Plain version. q: (B, H, dh); k/v: (B, S, KV, dh); q_pos ()
    int32; kv_pos (S,) int32 -> (B, H, dh) in q.dtype. With
    ``return_lse``, also each (row, head)'s log-sum-exp of its masked,
    scaled scores, (B, H) f32."""
    if return_lse:
        return _plain_with_lse(q, k, v, q_pos, kv_pos, window)
    o = attention(q[:, None], k, v, q_pos=q_pos.reshape(1), kv_pos=kv_pos,
                  window=window, chunk=0)
    return o[:, 0]


def _plain_with_lse(q, k, v, q_pos, kv_pos, window):
    """(o, lse): attention's softmax of its masked scores (-1e30 where
    masked, so an empty row is uniform) and their log-sum-exp."""
    scale = float(np.float32(1.0) / np.sqrt(np.float32(q.shape[-1])))
    s = _gqa_scores(q[:, None], k)[:, 0] * scale               # (B, H, S)
    m = _edge_mask(q_pos.reshape(1), kv_pos, window)[0]        # (S,)
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    o = _gqa_av(torch.softmax(s, dim=-1)[:, None], v)[:, 0]
    return o.to(q.dtype), torch.logsumexp(s, dim=-1)


def decode_attention(q, k, v, q_pos, kv_pos, *, window: int = 0,
                     return_lse: bool = False):
    """Flash-decode one query token per row over a ring cache; with
    ``return_lse`` also each (row, head)'s log-sum-exp, (B, H) f32.
    DTensor arguments (a sharded decode) run on each rank's own shards
    (``sharded_decode_attention``)."""
    if isinstance(k, DTensor):
        return sharded_decode_attention(q, k, v, q_pos, kv_pos,
                                        window=window)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, q_pos, kv_pos, window=window,
                                      return_lse=return_lse)
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
    out = torch.empty_like(q)
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if is_fake(q):
        # a fake tensor (the dry run) holds no data to launch on: the
        # launch's outputs, shaped and placed, its work reported, nothing
        # counted
        fake_launch("decode_attention", 4.0 * B * H * S * dh)
        return (out, lse) if return_lse else out
    check_aligned("decode_attention", q=q, k=k, v=v)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    args = (B, H, KV, S, dh, int(window), scale,
            int(q.dtype == torch.bfloat16),
            decode_split(B, KV, S, sm_count(q.device.index)),
            torch.cuda.current_stream(q.device).cuda_stream)
    # the library launches on the current device: the tensors' one
    with torch.cuda.device(q.device):
        rc = library().decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None, *args)
    check(rc, "decode_attention")
    decode_attention.launches += 1
    return (out, lse) if return_lse else out


decode_attention.launches = 0


def sharded_decode_attention(q, k, v, q_pos, kv_pos, *, window: int = 0):
    """``decode_attention`` of a sharded decode: k, v (B, S, KV, dh)
    DTensors laid out as ``sharding.rules.cache_specs`` lays a cache's
    layer out (rows over ``pod`` x ``data``; KV heads over ``model``, or
    the slots where ``model`` does not divide the heads), q (B, H, dh),
    positions replicated. Each rank runs the kernel (its plain version on
    the CPU) on its own shards: with the heads split, on its rows and
    heads; with the slots split, on its rows, every head and its slots,
    then the ranks holding one row's slots combine their outputs by
    their log-sum-exps (one all-reduce of the max, one of the weighted
    sums, over each mesh dim that splits the slots)."""
    mesh = k.device_mesh
    slot_dims = shard_dims(k, 1)
    # q follows the cache: its rows, and its heads where those are split
    qpl = tuple(p if isinstance(p, Shard) and p.dim == 0 else
                Shard(1) if isinstance(p, Shard) and p.dim == 2 else
                Replicate() for p in k.placements)
    if not isinstance(q, DTensor):
        q = DTensor.from_local(q, mesh, (Replicate(),) * mesh.ndim,
                               run_check=False)
    q = q.redistribute(mesh, qpl)
    q_pos, kv_pos = local_value(q_pos), local_value(kv_pos)
    if not slot_dims:
        return local_apply(lambda q, k, v: decode_attention(
            q, k, v, q_pos, kv_pos, window=window), (None, None, None),
            q, k, v)
    n = k.shape[1] // int(np.prod([mesh.size(i) for i in slot_dims]))
    s0 = shard_index(mesh, slot_dims) * n
    groups = [mesh.get_group(i) for i in slot_dims]

    def local(q, k, v):
        o, lse = decode_attention(q, k, v, q_pos, kv_pos[s0:s0 + n],
                                  window=window, return_lse=True)
        top = lse
        for g in groups:
            top = all_reduce(top, "max", g)
        w = torch.exp(lse - top)                                   # (B, H)
        part = torch.cat([w[..., None] * o.float(), w[..., None]], dim=-1)
        for g in groups:
            part = all_reduce(part, "sum", g)
        return (part[..., :-1] / part[..., -1:]).to(q.dtype)

    return local_apply(local, (None, None, None), q, k, v)
