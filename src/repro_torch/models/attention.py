"""GQA attention: blockwise online-softmax (flash) for prefill, plain
masked attention for short queries, sliding-window support, the ring KV
cache and the paged KV cache protocol.

Prefill attention is plain PyTorch ops, as it is plain array code in
the reference; single-token decode goes through the hand-written
``kernels.decode_attention`` kernel, whose plain version is
``attention(chunk=0)`` on one query token.

Masking is position-id based throughout: every key slot carries an
absolute position (-1 = empty), which makes full caches and
sliding-window ring caches look identical to the attention math.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..sharding.context import (as_dtensor, local_apply, local_value,
                                mesh_shape, replicate_dim, shard_dims,
                                shard_index)

NEG_INF = -1e30
BATCH = ("pod", "data")


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, H, dh), k: (B, Sk, KV, dh) -> (B, Sq, H, Sk) in f32."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, dh)
    s = torch.einsum("bqkgd,bskd->bqkgs", qg.float(), k.float())
    return s.reshape(B, Sq, H, Sk)


def _gqa_av(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (B, Sq, H, Sk) f32, v: (B, Sk, KV, dh) -> (B, Sq, H, dh) f32."""
    B, Sq, H, Sk = p.shape
    KV, dh = v.shape[2], v.shape[3]
    G = H // KV
    pg = p.reshape(B, Sq, KV, G, Sk)
    o = torch.einsum("bqkgs,bskd->bqkgd", pg, v.float())
    return o.reshape(B, Sq, H, dh)


def _edge_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, window: int,
               causal: bool = True) -> torch.Tensor:
    """Allowed-edge mask. Shared positions — q_pos (Sq,), kv_pos (Sk,) —
    give an (Sq, Sk) mask; per-row positions — q_pos (B, Sq), kv_pos
    (B, Sk) — give (B, Sq, Sk). kv_pos == -1 marks an empty cache slot
    (always masked)."""
    qp = q_pos[..., :, None]
    kp = kv_pos[..., None, :]
    m = kp >= 0
    if causal:
        m = m & (kp <= qp)
    if window:
        m = m & (kp > qp - window)
    return m


def attention(q, k, v, *, q_pos, kv_pos, window: int = 0, chunk: int = 0,
              causal: bool = True) -> torch.Tensor:
    """Unified GQA attention.

    q: (B, Sq, H, dh); k, v: (B, Sk, KV, dh); q_pos: (Sq,) absolute query
    positions; kv_pos: (Sk,) absolute key positions (-1 empty). Per-row
    positions — q_pos (B, Sq) / kv_pos (B, Sk) — are accepted on the plain
    path only. Returns (B, Sq, H, dh) in q.dtype. ``chunk`` selects the
    blockwise online-softmax path when it tiles Sk.
    """
    if isinstance(q, DTensor):
        return _sharded_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                  window=window, chunk=chunk, causal=causal)
    Sq, Sk = q.shape[1], k.shape[1]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(q.shape[-1])))
    if chunk and Sq > 1 and Sk > chunk and Sk % chunk == 0:
        if q_pos.dim() != 1 or kv_pos.dim() != 1:
            raise ValueError("flash path requires shared (1-D) positions")
        return _flash(q, k, v, q_pos=q_pos, kv_pos=kv_pos, window=window,
                      chunk=chunk, scale=scale, causal=causal)
    m = _edge_mask(q_pos, kv_pos, window, causal)  # (Sq, Sk) | (B, Sq, Sk)
    m = m[None, :, None, :] if m.dim() == 2 else m[:, :, None, :]
    s = _gqa_scores(q, k) * scale  # (B, Sq, H, Sk)
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    # fully-masked rows (empty cache) give a uniform softmax, not NaN
    p = torch.softmax(s, dim=-1)
    o = _gqa_av(p, v)
    return o.to(q.dtype)


def heads_whole(x, n_heads: int):
    """``x`` (..., n_heads * dh), a DTensor whose last dim some mesh dims
    split, with that dim gathered where the split would cut a head: the
    projection before a (.., n_heads, dh) reshape (GQA's K and V when
    ``model`` does not divide the KV heads). Anything else as it is."""
    dims = shard_dims(x, -1)
    if not dims or n_heads % int(np.prod([x.device_mesh.size(i)
                                          for i in dims])) == 0:
        return x
    return replicate_dim(x, x.ndim - 1)


def _sharded_attention(q, k, v, *, q_pos, kv_pos, window, chunk, causal):
    """A sharded step's attention, on each rank's own rows. Query heads
    stay split over ``model`` where it divides them; K and V are split
    there too where it divides the KV heads, and are whole otherwise,
    each rank then attending with its query heads h against the KV heads
    h // G they map to (no rank computes another's heads)."""
    mesh = q.device_mesh
    model = mesh_shape(mesh).get("model", 1)
    H, KV = q.shape[2], k.shape[2]
    q_pos, kv_pos = local_value(q_pos), local_value(kv_pos)
    qspec = (BATCH, None, "model", None)
    kvspec = (BATCH, None, "model" if KV % model == 0 else None, None)

    def attend(q, k, v):
        return attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, window=window,
                         chunk=chunk, causal=causal)

    if H % model and q.shape[1] > 1 and q.shape[1] % model == 0 and \
            q_pos.dim() == 1:
        # the query heads do not split: the queries do (each rank its
        # slice of the sequence against every key), so that no rank
        # computes another's share
        n = q.shape[1] // model
        c = shard_index(mesh, [mesh.mesh_dim_names.index("model")])
        whole = (BATCH, None, None, None)
        return local_apply(lambda q, k, v: attention(
            q, k, v, q_pos=q_pos[c * n:(c + 1) * n], kv_pos=kv_pos,
            window=window, chunk=chunk, causal=causal),
            ((BATCH, "model", None, None), whole, whole), q, k, v)
    if H % model or KV % model == 0:
        return local_apply(attend, (qspec, kvspec, kvspec), q, k, v)
    # query heads split, KV heads whole: rank c holds query heads
    # c * Hl .. c * Hl + Hl - 1, which read KV heads h // G
    Hl, G = H // model, H // KV
    c = shard_index(mesh, [mesh.mesh_dim_names.index("model")])
    kv_of = [(c * Hl + j) // G for j in range(Hl)]
    lo, n = kv_of[0], kv_of[-1] - kv_of[0] + 1
    if Hl % n == 0 and all(kv_of[j] - lo == j // (Hl // n)
                           for j in range(Hl)):
        def local(q, k, v):     # a contiguous run of KV heads, G' each
            return attend(q, k[:, :, lo:lo + n], v[:, :, lo:lo + n])
    else:
        # kv_of on the device by arithmetic: a host list copied in would
        # be a pageable copy, which a captured step cannot hold
        idx = (torch.arange(Hl, device=k.device) + c * Hl) // G

        def local(q, k, v):     # one KV head a query head
            return attend(q, k.index_select(2, idx), v.index_select(2, idx))
    return local_apply(local, (qspec, kvspec, kvspec), q, k, v)


def merge_heads(o):
    """o (B, S, H, dh) -> (B, S, H * dh). A DTensor is merged on each rank
    (its split rows and heads stay split; a split sequence moves to the
    merged columns), so the gradient comes back in o's layout: a merge
    DTensor plans itself would hand a gradient split over ``model`` back
    to heads ``model`` does not divide."""
    def merge(o):
        return o.reshape(o.shape[0], o.shape[1], -1)

    out = local_apply(merge, (None,), o)
    seq = shard_dims(out, 1)
    if seq:
        # queries split by sequence (heads `model` does not divide): the
        # output projection wants its input split by columns instead
        mesh = out.device_mesh
        cols = out.shape[2] % int(np.prod([mesh.size(i) for i in seq])) == 0
        out = out.redistribute(mesh, tuple(
            (Shard(2) if cols else Replicate()) if i in seq else p
            for i, p in enumerate(out.placements)))
    return out


def _flash(q, k, v, *, q_pos, kv_pos, window, chunk, scale, causal=True):
    """Online-softmax loop over KV chunks; never materializes (Sq, Sk)."""
    B, Sq, H, dh = q.shape
    Sk = k.shape[1]
    m_run = torch.full((B, Sq, H), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((B, Sq, H), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, H, dh), dtype=torch.float32, device=q.device)
    for c0 in range(0, Sk, chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = _gqa_scores(q, kb) * scale  # (B, Sq, H, chunk) f32
        msk = _edge_mask(q_pos, kv_pos[c0:c0 + chunk], window, causal)
        s = torch.where(msk[None, :, None, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        l_run = l_run * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + _gqa_av(p, vb)
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache: dict {k, v, pos, t}
#   k, v: (B, C, KV, dh) where C = max_len (full) or window (ring)
#   pos:  (C,) absolute position held in each slot, -1 if empty
#   t:    () next absolute position to write
# ---------------------------------------------------------------------------


def init_kv_cache(batch, capacity, n_kv, dh, dtype, device=None):
    return {
        "k": torch.zeros((batch, capacity, n_kv, dh), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, capacity, n_kv, dh), dtype=dtype,
                         device=device),
        "pos": torch.full((capacity,), -1, dtype=torch.int32, device=device),
        "t": torch.zeros((), dtype=torch.int32, device=device),
    }


def cache_prefill(cache, k, v):
    """Write a full prefill of S tokens (positions 0..S-1) into the cache,
    in place. k, v: (..., S, KV, dh) against cache buffers (..., C, KV,
    dh) — one layer, or a leading layer axis for all layers at once. If
    the cache is a ring (capacity < S), keep the last ``capacity`` tokens
    at slot = absolute_pos % capacity. A DTensor cache (laid out by
    ``cache_specs``) is written rank-locally (``_prefill_sharded``)."""
    if isinstance(cache["k"], DTensor):
        return _prefill_sharded(cache, k, v)
    S = k.shape[-3]
    C = cache["k"].shape[-3]
    dev = cache["k"].device
    if S <= C:
        cache["k"][..., :S, :, :] = k.to(cache["k"].dtype)
        cache["v"][..., :S, :, :] = v.to(cache["v"].dtype)
        ar = torch.arange(C, dtype=torch.int32, device=dev)
        pos = torch.where(ar < S, ar, torch.full_like(ar, -1))
    else:
        abs_pos = torch.arange(S - C, S, dtype=torch.int32, device=dev)
        slots = (abs_pos % C).long()
        cache["k"][..., slots, :, :] = k[..., S - C:, :, :].to(
            cache["k"].dtype)
        cache["v"][..., slots, :, :] = v[..., S - C:, :, :].to(
            cache["v"].dtype)
        pos = torch.zeros((C,), dtype=torch.int32, device=dev)
        pos[slots] = abs_pos
    cache["pos"] = pos
    cache["t"] = torch.full((), S, dtype=torch.int32, device=dev)
    return cache


def _ring_positions(slots, S: int, C: int):
    """(absolute position, live) of ring ``slots`` after a prefill of S
    tokens into a capacity-C cache: slot j holds position j (live where j
    < S), or with S > C the one of the last C positions p with p % C ==
    j."""
    if S <= C:
        return slots.clamp(max=S - 1), slots < S
    return S - C + (slots - (S - C)) % C, torch.ones_like(slots,
                                                           dtype=torch.bool)


def _prefill_sharded(cache, k, v):
    """``cache_prefill`` into a DTensor cache, on each rank's own shard:
    k and v are laid out as the cache with the sequence whole (they come
    from the prefill split by rows, and by heads where the cache splits
    them), and each rank writes the positions its slots hold. No gather
    of the cache; ``pos`` and ``t`` become replicated DTensors."""
    ck = cache["k"]
    mesh = ck.device_mesh
    seq = ck.ndim - 3
    S, C = k.shape[-3], ck.shape[-3]
    dims = shard_dims(ck, seq)
    Cl = C // int(np.prod([mesh.size(i) for i in dims]))
    c0 = shard_index(mesh, dims) * Cl
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == seq else p
                 for p in ck.placements)
    k, v = (as_dtensor(x, mesh).redistribute(mesh, want) for x in (k, v))

    def write(ck, cv, k, v):
        slots = c0 + torch.arange(Cl, device=ck.device)
        at, live = _ring_positions(slots, S, C)
        live = live.view((Cl,) + (1,) * (ck.ndim - seq - 1))
        for dst, src in ((ck, k), (cv, v)):
            dst.copy_(torch.where(live, src.index_select(seq, at).to(
                dst.dtype), dst))
        return ck, cv

    local_apply(write, (None, None, None, None), ck, cache["v"], k, v,
                n_out=2)
    dev = ck.to_local().device
    at, live = _ring_positions(torch.arange(C, dtype=torch.int32,
                                            device=dev), S, C)
    cache["pos"] = as_dtensor(torch.where(live, at, torch.full_like(at, -1)),
                              mesh)
    cache["t"] = as_dtensor(torch.full((), S, dtype=torch.int32,
                                       device=dev), mesh)
    return cache


def ring_write(ck, cv, k1, v1, slot):
    """Write one token a row, k1, v1 (B, 1, KV, dh), at ring slot ``slot``
    (1,) of one layer's ck, cv (B, C, KV, dh), in place. A DTensor cache
    is written rank-locally: where its slots are split, only the rank
    holding ``slot`` changes it, and no rank reads ``slot`` on the
    host."""
    if not isinstance(ck, DTensor):
        ck.index_copy_(1, slot, k1.to(ck.dtype))
        cv.index_copy_(1, slot, v1.to(cv.dtype))
        return
    mesh = ck.device_mesh
    dims = shard_dims(ck, 1)
    Cl = ck.shape[1] // int(np.prod([mesh.size(i) for i in dims]))
    c0 = shard_index(mesh, dims) * Cl
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                 for p in ck.placements)
    k1, v1 = (as_dtensor(x, mesh).redistribute(mesh, want) for x in (k1, v1))
    slot = local_value(slot)

    def write(ck, cv, k1, v1):
        at = slot - c0
        inside = ((at >= 0) & (at < Cl)).view(1, 1, 1, 1)
        at = at.clamp(0, Cl - 1)
        for dst, src in ((ck, k1), (cv, v1)):
            dst.index_copy_(1, at, torch.where(
                inside, src.to(dst.dtype), dst.index_select(1, at)))
        return ck, cv

    local_apply(write, (None, None, None, None), ck, cv, k1, v1, n_out=2)


def cache_append(cache, k1, v1):
    """Append one token (k1, v1: (B, 1, KV, dh)) in place; ring-wraps
    automatically. ``t`` stays on the device (no host sync)."""
    C = cache["k"].shape[1]
    t = cache["t"]
    slot = (t % C).reshape(1).long()
    cache["k"].index_copy_(1, slot, k1.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v1.to(cache["v"].dtype))
    cache["pos"] = cache["pos"].index_copy(0, slot, t.reshape(1))
    cache["t"] = t + 1
    return cache


# ---------------------------------------------------------------------------
# Paged KV cache protocol (single-layer primitives)
#
# K/V live in a shared pool of fixed-size pages (n_pages + 1, page, KV,
# dh); the trailing page is the *trash page*, a write-discard target for
# rows whose computed KV is dropped (batch padding, deduplicated rows).
# Each row carries a page table (B, C // page) of physical page ids;
# prefix-sharing rows map leading logical pages to the same physical
# pages. pos/t tracking is the ring cache's: positions are logical-slot
# indexed and rows advance in lockstep. Allocation and refcounting are
# host-side (``serve.kvcache.PagePool``); these helpers are the device
# half. Where the reference returns a new pool, the port writes the
# pool's storage in place: the pool is the engine's largest buffer and
# the reference donates it on every call.
# ---------------------------------------------------------------------------


def paged_gather(k_pages, v_pages, table):
    """Materialise each row's logical KV view through its page table.

    k_pages, v_pages: (P1, page, KV, dh), possibly a strided layer view
    of a (P1, L, page, KV, dh) pool; table: (B, n) int32 physical page
    per logical page. Returns dense (B, n * page, KV, dh) copies. The
    serving decode never gathers: it reads the pool through
    ``paged_decode_attention``. Suffix prefill (``paged_prefill_suffix``)
    still gathers each row's prefix pages on every layer, as the
    reference does; the plain versions and the tests gather too.
    """
    B, n = table.shape
    page, KV, dh = k_pages.shape[1:]
    idx = table.long()
    k = k_pages[idx].reshape(B, n * page, KV, dh)
    v = v_pages[idx].reshape(B, n * page, KV, dh)
    return k, v


def last_writer(dest, n_dest):
    """For N writes to flat destinations ``dest`` (N,) in ``[0, n_dest)``:
    the index of the last write to each one's destination, in O(N +
    n_dest) and without a host sync. Writing ``src[last_writer(dest, n)]``
    gives every duplicate the last write's value, so the result is the
    sequential last-write-wins one (the CPU's, and XLA's) in whatever
    order the device applies the writes; a plain ``index_put_`` on CUDA
    lands an arbitrary one. Writes meet only on the trash page, which a
    real row reads only at masked slots but padding rows read as their
    prefix: in a capacity-dispatch MoE's prefill those rows take expert
    slots ahead of real tokens, so the page's contents must not depend
    on the order."""
    dest = dest.long()
    ar = torch.arange(dest.shape[0], device=dest.device)
    winner = torch.full((n_dest,), -1, dtype=torch.long, device=dest.device)
    return winner.scatter_reduce_(0, dest, ar, "amax")[dest]


def paged_scatter_pages(k_pages, v_pages, scatter_tbl, k, v):
    """Write whole prefill pages in place: k, v (B, S, KV, dh) with S a
    multiple of the page size; scatter_tbl (B, S // page) physical
    destinations. Rows whose compute is discarded point every entry at
    the trash page, where the last of the writes lands (``last_writer``).
    """
    B, S, KV, dh = k.shape
    npp = scatter_tbl.shape[1]
    page = S // npp
    idx = scatter_tbl.long()
    src = last_writer(idx.reshape(-1), k_pages.shape[0])
    k_pages[idx] = k.reshape(B * npp, page, KV, dh)[src].reshape(
        B, npp, page, KV, dh).to(k_pages.dtype)
    v_pages[idx] = v.reshape(B * npp, page, KV, dh)[src].reshape(
        B, npp, page, KV, dh).to(v_pages.dtype)
    return k_pages, v_pages


def suffix_attend(q, k_suf, v_suf, pk, pv, *, offset, window=0, chunk=0):
    """Suffix-prefill attention: queries at absolute positions
    ``offset .. offset + Ssuf - 1`` attend over the cached prefix KV
    (absolute positions ``0 .. offset - 1``, gathered through a page
    table with :func:`paged_gather`) concatenated with the suffix's own
    freshly computed KV.

    q, k_suf, v_suf: (B, Ssuf, ·, dh); pk, pv: (B, offset, KV, dh).
    Causal masking means prefix positions never attend to the suffix, so
    a greedy decode seeded from suffix logits matches the monolithic
    prefill's. Rows whose prefix table points at the trash page read
    finite garbage; the caller discards their outputs.
    """
    Ssuf = q.shape[1]
    dev = q.device
    positions = torch.arange(offset, offset + Ssuf, dtype=torch.int32,
                             device=dev)
    fk = torch.cat([pk.to(k_suf.dtype), k_suf], dim=1)
    fv = torch.cat([pv.to(v_suf.dtype), v_suf], dim=1)
    kv_pos = torch.cat([torch.arange(offset, dtype=torch.int32, device=dev),
                        positions])
    return attention(q, fk, fv, q_pos=positions, kv_pos=kv_pos,
                     window=window, chunk=chunk)


def paged_append(k_pages, v_pages, tbl_col, offset, k1, v1):
    """Write one decoded token per row in place: tbl_col (B,) physical
    pages, offset () in-page slot (shared: rows decode in lockstep), k1,
    v1 (B, 1, KV, dh). Padding rows all write the trash page at the same
    slot: the caller orders which lands by passing rows resolved with
    ``last_writer(tbl_col, n_pages)`` (once a step, not once a layer)."""
    idx = (tbl_col.long(), offset.long().expand(tbl_col.shape[0]))
    k_pages.index_put_(idx, k1[:, 0].to(k_pages.dtype))
    v_pages.index_put_(idx, v1[:, 0].to(v_pages.dtype))
    return k_pages, v_pages


def paged_append_rows(k_pages, v_pages, tbl_cols, offsets, kw, vw):
    """Write W tokens a row in place at *per-row* slots: the speculative
    verify's scatter, where each row's write window starts at its own
    ``t``. tbl_cols, offsets: (B, W) physical page / in-page slot of each
    written token; kw, vw: (B, W, KV, dh); (b, w) lands in
    ``pages[tbl_cols[b, w], offsets[b, w]]``. A row's window is owned by
    that row alone (the engine allocates it per row), so two writes meet
    only on the trash page, from padding rows; the last of them lands
    (``last_writer``)."""
    idx = (tbl_cols.long(), offsets.long())
    B, W = tbl_cols.shape
    src = last_writer((idx[0] * k_pages.shape[1] + idx[1]).reshape(-1),
                      k_pages.shape[0] * k_pages.shape[1])
    k_pages.index_put_(idx, kw.reshape((B * W,) + kw.shape[2:])[src]
                       .reshape(kw.shape).to(k_pages.dtype))
    v_pages.index_put_(idx, vw.reshape((B * W,) + vw.shape[2:])[src]
                       .reshape(vw.shape).to(v_pages.dtype))
    return k_pages, v_pages
