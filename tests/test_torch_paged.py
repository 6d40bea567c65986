"""The port's paged KV path against the reference: the plain version of
kernel 4 (``paged_decode_attention``) against the reference's Pallas
kernel in interpret mode and its oracle, on the grid of
tests/test_kernels.py (rtol = atol = 2e-5 f32, 2e-2 bf16); the paged
DecoderLM methods' logits against the reference's on the same bridged
weights, pool and tables (rtol 2e-5); and paged greedy tokens equal to
ring greedy tokens within the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro.configs import get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import paged_decode_attention_pallas
from repro.models import build_model
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config as tget
from repro_torch.kernels import ops as tops
from repro_torch.models import build_model as tbuild
from repro_torch.models.attention import paged_gather
from repro_torch.serve import ExpertEngine

PAGED_GRID = [   # tests/test_kernels.py:112-118
    (3, 8, 2, 64, 8, 8, 0, "float32"),
    (2, 4, 4, 64, 16, 4, 0, "float32"),
    (3, 8, 2, 64, 8, 8, 24, "float32"),    # sliding window
    (1, 16, 2, 128, 8, 4, 0, "float32"),
    (2, 8, 2, 64, 8, 8, 0, "bfloat16"),
]


def paged_inputs(B, H, KV, dh, page, nlp, seed, layers=None, pad=0):
    """Paged-decode inputs from a numpy seed, shared with the CUDA cases
    of tests/test_torch_kernels.py: q (B, H, dh); K/V pools of
    P1 = 3 * B * nlp + 1 pages, shaped (P1, page, KV, dh), or
    (P1, layers, page, KV, dh + pad) when ``layers`` is given; a table (B, nlp) int32 in which every row shares
    its first (prefix) page with row 0, its other written pages are
    distinct, and its tail maps to the trash page P1 - 1; q_pos and
    kv_pos (C,) of the decode step that wrote slot t - 1, t = C - C // 3
    (the last pages unwritten). All float32 numpy."""
    rng = np.random.default_rng(seed)
    C = nlp * page
    P1 = 3 * B * nlp + 1
    shape = (P1, page, KV, dh) if layers is None else \
        (P1, layers, page, KV, dh + pad)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    t = C - C // 3
    n_valid = -(-t // page)
    perm = rng.permutation(P1 - 1)
    tbl = np.full((B, nlp), P1 - 1, np.int32)
    for b in range(B):
        tbl[b, :n_valid] = perm[b * nlp:b * nlp + n_valid]
    tbl[1:, 0] = tbl[0, 0]
    kv_pos = np.where(np.arange(C) < t, np.arange(C), -1).astype(np.int32)
    return q, kp, vp, tbl, np.int32(t - 1), kv_pos


@pytest.mark.parametrize("B,H,KV,dh,page,nlp,win,dtype", PAGED_GRID)
def test_plain_paged_decode_matches_reference_kernel(B, H, KV, dh, page,
                                                     nlp, win, dtype):
    q, kp, vp, tbl, qp, kv_pos = paged_inputs(B, H, KV, dh, page, nlp,
                                              seed=nlp * page + H)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = (jnp.asarray(q, jd), jnp.asarray(kp, jd), jnp.asarray(vp, jd),
             jnp.asarray(tbl), jnp.asarray(qp), jnp.asarray(kv_pos))
    kernel = np.asarray(paged_decode_attention_pallas(*jargs, window=win),
                        np.float32)
    oracle = np.asarray(jref.paged_decode_attention_ref(*jargs, window=win),
                        np.float32)
    got = tops.paged_decode_attention(
        torch.from_numpy(q).to(td), torch.from_numpy(kp).to(td),
        torch.from_numpy(vp).to(td), torch.from_numpy(tbl),
        torch.tensor(qp), torch.from_numpy(kv_pos), window=win)
    assert got.dtype == td and got.shape == (B, H, dh)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for want in (kernel, oracle):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)


def test_plain_paged_decode_page_table_remap_invariance():
    """Remapping rows to other physical pages with identical contents
    leaves the output unchanged (tests/test_kernels.py:159)."""
    B, H, KV, dh, page, nlp = 2, 4, 2, 32, 8, 4
    C = nlp * page
    rng = np.random.default_rng(1)
    P1 = 2 * B * nlp + 1
    kp = torch.from_numpy(rng.standard_normal((P1, page, KV, dh))
                          .astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((P1, page, KV, dh))
                          .astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((B, H, dh)).astype(np.float32))
    kp[B * nlp:2 * B * nlp] = kp[:B * nlp]
    vp[B * nlp:2 * B * nlp] = vp[:B * nlp]
    tbl1 = torch.arange(B * nlp, dtype=torch.int32).reshape(B, nlp)
    tbl2 = tbl1.clone()
    tbl2[1] += B * nlp
    qp = torch.tensor(C - 1, dtype=torch.int32)
    kv_pos = torch.arange(C, dtype=torch.int32)
    a = tops.paged_decode_attention(q, kp, vp, tbl1, qp, kv_pos)
    b = tops.paged_decode_attention(q, kp, vp, tbl2, qp, kv_pos)
    assert torch.equal(a, b)
    want = np.asarray(jops.paged_decode_attention(
        jnp.asarray(q.numpy()), jnp.asarray(kp.numpy()),
        jnp.asarray(vp.numpy()), jnp.asarray(tbl1.numpy()),
        jnp.asarray(C - 1, jnp.int32), jnp.asarray(kv_pos.numpy())))
    np.testing.assert_allclose(a.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("page", [8, 16])
def test_layer_views_of_a_5d_pool(page):
    """Kernel 4's inputs on the serving path are layer views pool[:, i]
    of a (P1, L, page, KV, dh) pool, whose page axis is strided; each
    layer's result equals the reference oracle on that layer's pages."""
    B, H, KV, dh, nlp, L = 3, 8, 2, 64, 4, 3
    q, pool_k, pool_v, tbl, qp, kv_pos = paged_inputs(
        B, H, KV, dh, page, nlp, seed=page, layers=L)
    tk, tv = torch.from_numpy(pool_k), torch.from_numpy(pool_v)
    for i in range(L):
        view_k, view_v = tk[:, i], tv[:, i]
        assert not view_k.is_contiguous()
        assert view_k.stride(0) == L * page * KV * dh
        got = tops.paged_decode_attention(
            torch.from_numpy(q), view_k, view_v, torch.from_numpy(tbl),
            torch.tensor(qp), torch.from_numpy(kv_pos))
        want = np.asarray(jref.paged_decode_attention_ref(
            jnp.asarray(q), jnp.asarray(pool_k[:, i]),
            jnp.asarray(pool_v[:, i]), jnp.asarray(tbl), jnp.asarray(qp),
            jnp.asarray(kv_pos)))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
        # the gather used by the plain version reads the same layer
        gk, _ = paged_gather(view_k, view_v, torch.from_numpy(tbl))
        np.testing.assert_array_equal(
            gk.numpy(), pool_k[:, i][tbl].reshape(B, nlp * page, KV, dh))


# -- the paged DecoderLM methods against the reference ---------------------


@pytest.fixture(scope="module")
def models():
    jm = build_model(get_config("smollm_135m").reduced(name="paged-m"))
    params = jax.device_get(jm.init(jax.random.PRNGKey(3)))
    tm = tbuild(tget("smollm_135m").reduced(name="paged-m"))
    return jm, params, tm, to_torch(params, device="cpu")


def test_paged_model_methods_match_reference(models):
    """paged_prefill, paged_prefill_suffix and paged_decode on the same
    weights, pool and tables: logits at rtol 2e-5 and the pool written
    at the same pages."""
    jm, jp, tm, tp = models
    cfg = tm.cfg
    page, C, P = 8, 64, 40
    rng = np.random.default_rng(0)
    B, S = 3, 32
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    toks[2] = toks[1]
    # row 1 scatters to fresh pages, row 2 (a duplicate) to trash
    stbl = np.full((B, S // page), P, np.int32)
    stbl[0] = [3, 17, 5, 29]
    stbl[1] = [8, 0, 21, 13]
    jpool = jm.init_paged_pool(P, page)
    tpool = tm.init_paged_pool(P, page, device="cpu")
    assert tuple(tpool["k"].shape) == tuple(jpool["k"].shape) == (
        P + 1, cfg.n_layers, page, cfg.n_kv_heads, cfg.dh)
    assert not tpool["k"].any() and not tpool["v"].any()   # trash finite
    jl, jpool, jpos, jt = jm.paged_prefill(
        jp, {"tokens": jnp.asarray(toks)}, jpool, jnp.asarray(stbl),
        page=page, capacity=C)
    tl, tpool, tpos, tt = tm.paged_prefill(
        tp, {"tokens": torch.from_numpy(toks)}, tpool,
        torch.from_numpy(stbl), page=page, capacity=C)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    assert int(tt) == int(jt) == S
    live = sorted(set(stbl[:2].ravel()))
    np.testing.assert_allclose(tpool["k"][live].numpy(),
                               np.asarray(jpool["k"])[live], rtol=2e-5,
                               atol=2e-5)

    # suffix prefill: 16 more tokens over the two computed rows' prefixes
    suf = rng.integers(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    ptbl = stbl[:2].copy()
    sstbl = np.asarray([[30, 31], [32, 33]], np.int32)
    jl, jpool = jm.paged_prefill_suffix(
        jp, {"tokens": jnp.asarray(suf)}, jpool, jnp.asarray(ptbl),
        jnp.asarray(sstbl), offset=S, page=page)
    tl, tpool = tm.paged_prefill_suffix(
        tp, {"tokens": torch.from_numpy(suf)}, tpool,
        torch.from_numpy(ptbl), torch.from_numpy(sstbl), offset=S,
        page=page)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5,
                               atol=2e-5)

    # decode: rows 0-1 continue their 48-token prompts, row 2 is padding
    tbl = np.full((B, C // page), P, np.int32)
    tbl[:2, :6] = np.concatenate([ptbl, sstbl], axis=1)
    tbl[:2, 6] = [34, 35]
    pos = np.where(np.arange(C) < 48, np.arange(C), -1).astype(np.int32)
    jpos, jt = jnp.asarray(pos), jnp.asarray(48, jnp.int32)
    tpos, tt = torch.from_numpy(pos), torch.tensor(48, dtype=torch.int32)
    tok = rng.integers(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
    for _ in range(3):
        jl, jpool, jpos, jt = jm.paged_decode(
            jp, jpool, jnp.asarray(tbl), jpos, jt,
            {"token": jnp.asarray(tok)}, page=page)
        tl, tpool, tpos, tt = tm.paged_decode(
            tp, tpool, torch.from_numpy(tbl), tpos, tt,
            {"token": torch.from_numpy(tok)}, page=page)
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2],
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        assert int(tt) == int(jt)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    for pg in (34, 35):
        np.testing.assert_allclose(tpool["v"][pg].numpy(),
                                   np.asarray(jpool["v"])[pg], rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("chunk_len", [None, 16])
def test_paged_greedy_tokens_equal_ring_tokens(models, chunk_len):
    """Within the port: a paged engine (and a chunked one) generates the
    ring engine's tokens, duplicates and a wrap into prompt pages
    included; the pool's books balance afterwards."""
    _, _, tm, tp = models
    rng = np.random.default_rng(7)
    toks = rng.integers(0, tm.cfg.vocab_size, size=(4, 58)).astype(np.int32)
    toks[3] = toks[0]
    want = ExpertEngine(tm, tp, max_len=64, device="cpu").generate(toks, 9)
    eng = ExpertEngine(tm, tp, max_len=64, kv_layout="paged",
                       chunk_len=chunk_len, device="cpu")
    got = eng.generate(toks, 9)
    np.testing.assert_array_equal(got, want)
    st = eng.stats
    assert st.prefix_dup_rows == 1 and st.pages_copied >= 1, st
    eng.core.pool.check()
    assert eng.core.pool.counters()["used"] == 0     # wrap: no register


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_duplicate_pool_writes_land_the_last_writer(device):
    """Writes that meet on one page slot (the trash page, from padding
    rows) land the last writer's value, as a sequential scatter (the
    CPU's, XLA's) does, on any device: a capacity-dispatch MoE's padding
    rows read the trash page, so its contents must not depend on the
    order the device applies the writes in. Each helper against a Python
    loop over its writes; the ``cuda`` case repeats it on the card."""
    from repro_torch.models.attention import (last_writer, paged_append,
                                              paged_append_rows,
                                              paged_scatter_pages)
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device(device)
    assert last_writer(torch.tensor([3, 1, 3, 2, 1], device=dev),
                       5).tolist() == [2, 4, 2, 3, 4]
    gen = torch.Generator().manual_seed(0)
    P1, page, KV, dh, trash = 7, 4, 2, 8, 6

    def pools():
        return [torch.randn(P1, page, KV, dh, generator=gen).to(dev)
                for _ in range(2)]

    # prefill pages: rows 1 and 3 are discarded (every page -> trash)
    tbl = torch.tensor([[0, 1], [trash, trash], [2, 3], [trash, trash]],
                       dtype=torch.int32, device=dev)
    k, v = (torch.randn(4, 2 * page, KV, dh, generator=gen).to(dev)
            for _ in range(2))
    kp, vp = pools()
    want_k, want_v = kp.clone(), vp.clone()
    for b in range(4):
        for j in range(2):
            want_k[tbl[b, j]] = k[b, j * page:(j + 1) * page]
            want_v[tbl[b, j]] = v[b, j * page:(j + 1) * page]
    paged_scatter_pages(kp, vp, tbl, k, v)
    assert torch.equal(kp, want_k) and torch.equal(vp, want_v)
    # per-row windows (verify): rows 0 and 2 pad onto the trash page
    cols = torch.tensor([[trash, trash], [4, 4], [trash, trash]],
                        dtype=torch.int32, device=dev)
    offs = torch.tensor([[1, 2], [0, 1], [1, 2]], dtype=torch.int32,
                        device=dev)
    kw, vw = (torch.randn(3, 2, KV, dh, generator=gen).to(dev)
              for _ in range(2))
    kp, vp = pools()
    want_k = kp.clone()
    for b in range(3):
        for w in range(2):
            want_k[cols[b, w], offs[b, w]] = kw[b, w]
    paged_append_rows(kp, vp, cols, offs, kw, vw)
    assert torch.equal(kp, want_k)
    # one decoded token a row, resolved by the caller
    col = torch.tensor([trash, 5, trash, trash], dtype=torch.int32,
                       device=dev)
    k1, v1 = (torch.randn(4, 1, KV, dh, generator=gen).to(dev)
              for _ in range(2))
    kp, vp = pools()
    want_k = kp.clone()
    for b in range(4):
        want_k[col[b], 3] = k1[b, 0]
    rows = last_writer(col, P1)
    paged_append(kp, vp, col, torch.tensor(3, device=dev), k1[rows],
                 v1[rows])
    assert torch.equal(kp, want_k)
