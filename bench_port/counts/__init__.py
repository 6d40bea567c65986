"""Operations and bytes from shapes, and the H100's peaks
(``peaks.json``): what a call or a token needs, whatever the program's
implementation reads or computes. Each input byte is counted once and
each output byte written once; work that depends on the data (live
cache slots) is counted as these inputs need it.

A multiply-add is two operations. ``arch`` is the port's ``ArchConfig``
(its keys: d_model, n_heads, n_kv_heads, dh, d_ff, n_experts,
experts_per_token, vocab_size, rwkv_lora_dim, n_layers, family).
"""
from __future__ import annotations

import json
import math
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())

BF16 = 2
F32 = 4
I32 = 4


def decoder_token_flops(arch, pos: int) -> float:
    """One token of a dense or MoE decoder at absolute position ``pos``
    (it attends ``pos + 1`` keys), the unembedding included."""
    D, H, KV, dh, F = (arch.d_model, arch.n_heads, arch.n_kv_heads,
                       arch.dh, arch.d_ff)
    proj = D * H * dh + 2 * D * KV * dh + H * dh * D
    if arch.n_experts:
        ffn = D * arch.n_experts + arch.experts_per_token * 3 * D * F
    else:
        ffn = 3 * D * F
    attn = 2 * (pos + 1) * H * dh           # q.k and p.v, in multiply-adds
    return arch.n_layers * 2.0 * (proj + ffn + attn) \
        + 2.0 * D * arch.vocab_size


def rwkv_token_flops(arch) -> float:
    """One token of RWKV6 (arXiv:2404.05892): the five time-mix
    projections, the ddlerp and decay LoRAs, the WKV step (7 P^2 a head:
    k v^T, the bonus u k v^T, its add, r (S + ...), the decay and the
    state add) and the channel mix, the unembedding included."""
    D, F, R = arch.d_model, arch.d_ff, arch.rwkv_lora_dim
    H, P = arch.n_heads, arch.dh
    mm = 5 * D * D + 5 * D * R + 5 * R * D + 2 * D * R + 2 * R * D \
        + D * F + F * D + D * D
    return arch.n_layers * (2.0 * mm + 7.0 * H * P * P) \
        + 2.0 * D * arch.vocab_size


def request_flops(arch, prompt_len: int, padded_len: int, new: int) -> float:
    """The useful work of one served request: its real prompt tokens
    (positions 0 .. prompt_len - 1; the padding to its length bucket is
    not useful) and the ``new - 1`` decode steps after the first token,
    at positions padded_len .. padded_len + new - 2."""
    if arch.family == "rwkv":
        return (prompt_len + max(new - 1, 0)) * rwkv_token_flops(arch)
    f = sum(decoder_token_flops(arch, p) for p in range(prompt_len))
    f += sum(decoder_token_flops(arch, padded_len + j)
             for j in range(max(new - 1, 0)))
    return f


def paged_attention_call(arch, rows: int, bucket: int, live: int,
                         page: int):
    """One ``paged_decode_attention`` launch (one layer): ``rows`` real
    rows of a ``bucket``-row wave, each with ``live`` cache slots.
    Bytes: q read and o written for every row of the call, each real
    row's live K and V and its page-table entries; padding rows all map
    to one trash page, counted once. Returns (operations, bytes)."""
    H, KV, dh = arch.n_heads, arch.n_kv_heads, arch.dh
    flops = 4.0 * rows * H * live * dh
    kv = rows * live * KV * dh * BF16 * 2
    if bucket > rows:
        kv += page * KV * dh * BF16 * 2
    qo = bucket * H * dh * BF16 * 2
    table = rows * math.ceil(live / page) * I32
    return flops, float(kv + qo + table)


def wkv_call(arch, rows: int):
    """One ``wkv_step`` launch (one layer) over the ``rows`` real rows of
    its wave: the padding up to the batch bucket is not needed, whatever
    the kernel reads for it. Bytes: each real row's f32 state read and
    written, its r/k/v in bf16 and logw in f32, u once, its o written in
    f32. Returns (operations, bytes)."""
    H, P = arch.n_heads, arch.dh
    flops = 7.0 * rows * H * P * P
    state = rows * H * P * P * F32 * 2
    vecs = rows * H * P * (3 * BF16 + F32 + F32) + H * P * F32
    return flops, float(state + vecs)


def roofline_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over HBM bandwidth."""
    return max(flops / peak_flops, nbytes / PEAKS["hbm_bytes_per_s"])
