"""Kernel 4: GQA flash-decode of one query token per row, reading K/V
through a per-row page table into a shared page pool — one launch per
layer of every paged decode step.

The function is kernel 3's (``decode_attention``) on the row's logical
view: for each (row, kv head), the G = H / KV query heads take a softmax
over the ``n_lp * page`` logical slots, masked by slot position
(``kv_pos >= 0``, ``kv_pos <= q_pos`` and, with a window,
``kv_pos > q_pos - window``); logical page ``j`` of row ``b`` lives in
physical page ``table[b, j]`` of the pool.

Source note:

* Replaces ``src/repro/kernels/decode_attention.py:
  paged_decode_attention_pallas`` (body ``_paged_kernel``), reached
  through ``ops.paged_decode_attention``. (The reference's serving
  decode gathers a dense per-row copy and runs its plain ``attention``;
  the port's paged decode takes this kernel and never gathers.)
* Bound on the H100 at the main path's shapes (``llama3_2_1b``: H 32,
  KV 8, dh 64, page 8, 32 logical pages, B = batch bucket <= 16, bf16):
  bytes — about 1 flop per byte of the live slots' K/V, plus the table
  and ``kv_pos``.
* Design: the ring kernel's body, templated on the address of a slot
  (``csrc/decode_attention.cu``): a cluster of ``decode_split(B, KV,
  n_lp * page, n_sm)`` blocks per (row, kv head) shares the logical
  slots' 32-slot tiles. Each block stages its table row in shared memory
  beside the one pass over ``kv_pos``, so a page may be smaller or
  larger than a tile and the K/V copies (16-byte ``cp.async``) wait on
  no further read; only tiles with a live slot are copied. The ranks
  combine through distributed shared memory. On the gathered view the
  result equals ``decode_attention``'s bit for bit (same split, tiles,
  order and arithmetic).
* Measured time: see ``PERF.md`` (``chip_smoke.py`` on the H100).

Pool contract: ``k_pages``/``v_pages`` are one layer's view
``pool[:, i]`` of a ``(P1, L, page, KV, dh)`` pool (the page index
leading, so one copy-on-write moves a page for every layer). The page
axis may be strided — the wrapper passes ``stride(0)`` as the page
stride — but each page's ``(page, KV, dh)`` must be contiguous, q and
the pages must start on 16 bytes and the page stride must be a multiple
of 16 bytes; the wrapper raises otherwise and never copies the pool.
Physical page ``P1 - 1`` is the trash page. Table entries must lie in
``[0, P1)``: the engine builds them from its page allocator, and the
kernel does not check them.

On a CPU tensor the wrapper runs the plain version (``paged_gather``
followed by ``attention(chunk=0)``, as the reference oracle
``ref.paged_decode_attention_ref`` has it); on a CUDA tensor it launches
the kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.attention import paged_gather
from .build import check, check_aligned, library, sm_count
from .decode_attention import (MAX_GROUP, SUPPORTED_DH,
                               decode_attention_plain, decode_split)


def paged_decode_attention_plain(q, k_pages, v_pages, table, q_pos, kv_pos,
                                 *, window: int = 0) -> torch.Tensor:
    """Plain version. q: (B, H, dh); k/v_pages: (P1, page, KV, dh);
    table: (B, n_lp) int32; q_pos () int32; kv_pos (n_lp * page,) int32
    -> (B, H, dh) in q.dtype."""
    k, v = paged_gather(k_pages, v_pages, table)
    return decode_attention_plain(q, k, v, q_pos, kv_pos, window=window)


def paged_decode_attention(q, k_pages, v_pages, table, q_pos, kv_pos, *,
                           window: int = 0) -> torch.Tensor:
    """Flash-decode one query token per row through its page table."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, table,
                                            q_pos, kv_pos, window=window)
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_decode_attention: unsupported device {q.device}")
    B, H, dh = q.shape
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"paged_decode_attention: k/v pages must be (P1, page, KV, dh), "
            f"got {tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    P1, page, KV, dhk = k_pages.shape
    n_lp = table.shape[-1]
    if dhk != dh or table.shape != (B, n_lp) or q_pos.numel() != 1 \
            or kv_pos.shape != (n_lp * page,):
        raise ValueError(
            f"paged_decode_attention: shape mismatch q {tuple(q.shape)} "
            f"pages {tuple(k_pages.shape)} table {tuple(table.shape)} "
            f"kv_pos {tuple(kv_pos.shape)}")
    if H % KV or H // KV > MAX_GROUP or dh not in SUPPORTED_DH:
        raise ValueError(f"paged_decode_attention: unsupported H={H} "
                         f"KV={KV} dh={dh} (dh in {SUPPORTED_DH}, H/KV <= "
                         f"{MAX_GROUP})")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"paged_decode_attention: unsupported dtype {q.dtype}")
    if q.dtype != k_pages.dtype or q.dtype != v_pages.dtype \
            or not q.is_contiguous():
        raise ValueError(f"paged_decode_attention: q must be contiguous and "
                         f"q, k/v pages share one dtype (got {q.dtype}, "
                         f"{k_pages.dtype}, {v_pages.dtype})")
    inner = (KV * dh, dh, 1)
    page_stride = k_pages.stride(0)
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.device != q.device or t.stride()[1:] != inner \
                or t.stride(0) != page_stride \
                or page_stride < page * KV * dh:
            raise ValueError(
                f"paged_decode_attention: {name} needs contiguous (page, KV, "
                f"dh) pages on {q.device} with k and v at one page stride "
                f"(got strides {t.stride()})")
    for name, t in (("table", table), ("q_pos", q_pos), ("kv_pos", kv_pos)):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"paged_decode_attention: {name} must be "
                             f"contiguous int32 on {q.device}")
    check_aligned("paged_decode_attention", q=q, k_pages=k_pages,
                  v_pages=v_pages)
    if page_stride * q.element_size() % 16:
        raise ValueError(f"paged_decode_attention: the page stride "
                         f"({page_stride} elements) must be a multiple of "
                         f"16 bytes")
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    out = torch.empty_like(q)
    # the library launches on the current device: the tensors' one
    with torch.cuda.device(q.device):
        rc = library().paged_decode_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            table.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
            out.data_ptr(), B, H, KV, n_lp, page, page_stride,
            dh, int(window), scale, int(q.dtype == torch.bfloat16),
            decode_split(B, KV, n_lp * page, sm_count(q.device.index)),
            torch.cuda.current_stream(q.device).cuda_stream)
    check(rc, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
