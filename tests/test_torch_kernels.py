"""The port's kernels against the reference kernels.

On the CPU each wrapper runs its plain PyTorch version; those are held
to the reference's Pallas kernels (interpret mode, exactly as
tests/test_kernels.py runs them) on the same numpy inputs, at the
tolerances of tests/test_kernels.py: rtol 2e-5 for f32, 2e-2 for bf16.
The ``cuda`` cases hold each hand-written CUDA kernel to its plain
version on the card (bf16 decode at 4e-3, about 8x the largest error
measured on an H100; the wkv step at 1e-4, f32 sums in another order)
and skip elsewhere; the paged decode kernel must also equal the ring
decode kernel on the gathered view bit for bit, the decode kernel must
give the same bits twice at every cluster split, the wkv step gives
the same bits in place and into a new buffer, and the expert score the
same bits twice, ragged row tiles and unaligned D included.
(The paged kernel's plain version is held to the reference in
tests/test_torch_paged.py.)
"""
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.kernels import ops as tops


@pytest.fixture(scope="module")
def jref():
    """The reference kernels (JAX), imported only by the tests that
    compare against them."""
    import jax.numpy as jnp
    from repro.kernels import ops, ref
    return jnp, ops, ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bank(K, D, H, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    params = {
        "w_enc": (rng.standard_normal((K, D, H)) * 0.03).astype(f),
        "b_enc": (rng.standard_normal((K, H)) * 0.01).astype(f),
        "bn_scale": (1.0 + rng.standard_normal((K, H)) * 0.1).astype(f),
        "bn_bias": (rng.standard_normal((K, H)) * 0.05).astype(f),
        "w_dec": (rng.standard_normal((K, H, D)) * 0.03).astype(f),
        "b_dec": (rng.standard_normal((K, D)) * 0.01).astype(f),
    }
    states = {"mean": (rng.standard_normal((K, H)) * 0.1).astype(f),
              "var": (1.0 + rng.uniform(size=(K, H))).astype(f),
              "count": np.ones((K,), f)}
    return params, states


def _t(tree, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in tree.items()}


EXPERT_GRID = [(32, 784, 128, 6), (128, 512, 64, 10), (16, 100, 32, 3),
               (256, 100, 32, 3)]


@pytest.mark.parametrize("B,D,H,K", EXPERT_GRID)
def test_expert_score_matches_reference(jref, B, D, H, K):
    jnp, ops, _ = jref
    params, states = _bank(K, D, H, seed=B + K)
    x = np.random.default_rng(B).uniform(size=(B, D)).astype(np.float32)
    want = np.asarray(ops.expert_score(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in states.items()}))
    got = tops.expert_score(_t(params), torch.from_numpy(x), _t(states))
    assert got.shape == (B, K)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-6)


def test_fold_bank_matches_reference_without_lane_padding(jref):
    """The port folds eval BN exactly as the reference does, but keeps
    D = 784 (the reference's 784 -> 896 pad is a TPU lane artifact)."""
    jnp, ops, _ = jref
    params, states = _bank(5, 784, 128, seed=3)
    want = ops.fold_bank({k: jnp.asarray(v) for k, v in params.items()},
                         {k: jnp.asarray(v) for k, v in states.items()})
    got = tops.fold_bank(_t(params), _t(states))
    D = 784
    np.testing.assert_allclose(got["w1"].numpy(),
                               np.asarray(want["w1"])[:, :D], rtol=2e-5,
                               atol=1e-7)
    np.testing.assert_allclose(got["b1"].numpy(), np.asarray(want["b1"]),
                               rtol=2e-5, atol=1e-7)
    np.testing.assert_array_equal(got["w2"].numpy(),
                                  np.asarray(want["w2"])[:, :, :D])
    np.testing.assert_array_equal(got["b2"].numpy(),
                                  np.asarray(want["b2"])[:, :D])
    assert not np.asarray(want["w1"])[:, D:].any()   # the pad is zeros


def test_expert_score_identity_bn_default():
    """bank_states=None means identity BN statistics, as in the
    reference's convenience entry."""
    params, _ = _bank(3, 100, 32, seed=1)
    x = torch.rand(8, 100, generator=torch.Generator().manual_seed(0))
    ident = {"mean": torch.zeros(3, 32), "var": torch.ones(3, 32)}
    torch.testing.assert_close(tops.expert_score(_t(params), x),
                               tops.expert_score(_t(params), x, ident),
                               rtol=0, atol=0)


def _gpc_clusters(*gpcs):
    """Clusters of n blocks resident at once on a card whose GPCs hold
    these SM counts, one block per SM: a cluster lives in one GPC."""
    return lambda n, rows: sum(g // n for g in gpcs)


# cudaOccupancyMaxActiveClusters for this kernel on an H100 SXM (132
# SMs, one block per SM) at 7 to 16 blocks a cluster, as chip_smoke.py
# reads it; smaller clusters as on 8 GPCs of 16 SMs
H100_ACTIVE = {7: 15, 8: 15, 9: 9, 10: 7, 11: 7, 12: 7, 13: 7, 14: 7,
               15: 7, 16: 7}


def h100_active(n, rows):
    return H100_ACTIVE.get(n, 8 * (16 // n))


@pytest.mark.parametrize("B,D,H,K,n,rows", [
    (32, 784, 128, 6, 16, 32),   # the router bucket: 96 blocks
    (32, 784, 128, 4, 16, 32),   # serve_rwkv's bank
    (1, 784, 128, 6, 16, 1),
    (33, 784, 128, 6, 8, 17),    # a ragged pair of row tiles
    (64, 784, 128, 6, 8, 32),    # 12 clusters: 16 or 11 blocks is 2 waves
    (33, 98, 128, 6, 8, 17),     # rows that do not start on 16 bytes
    (128, 512, 64, 10, 3, 32),
    (16, 100, 32, 3, 16, 16),
    (256, 100, 32, 3, 5, 32),
    (4, 6, 8, 2, 2, 4),          # fewer column groups than ranks allowed
    (32, 784, 256, 20, 13, 32),  # wide h: the slice cap, not one wave
])
def test_expert_split_plan(B, D, H, K, n, rows):
    """The cluster size and row tile of the expert score: every row and
    column is covered once, every slice starts on a 16-byte column group
    and holds at most SLICE_FLOATS of W1, a rank never gets an empty
    slice, and the K x tiles clusters are all resident at once (one
    wave) unless no allowed size makes them so; n is the largest such
    size, or else the smallest allowed."""
    from repro_torch.kernels.expert_score import (MAX_RANKS, MAX_ROWS,
                                                  SLICE_FLOATS)
    assert tops.expert_split(B, D, H, K, h100_active) == (n, rows)
    for active in (h100_active, _gpc_clusters(*(16,) * 7, 2),
                   _gpc_clusters(16)):
        n, rows = tops.expert_split(B, D, H, K, active)
        tiles = -(-B // rows)
        assert 1 <= rows <= MAX_ROWS and (tiles - 1) * rows < B
        assert tiles == -(-B // MAX_ROWS)
        sl = tops.expert_slices(D, n)
        assert len(sl) == n and sl[0][0] == 0 and sl[-1][1] == D
        assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
        assert all(d0 % 4 == 0 and d1 > d0 for d0, d1 in sl)
        assert all(d1 % 4 == 0 for _, d1 in sl[:-1])
        widest = max(-(-(d1 - d0) // 4) * 4 for d0, d1 in sl)
        groups = -(-D // 4)
        hp = -(-H // 4) * 4
        assert 1 <= n <= min(MAX_RANKS, groups)
        fits = widest * hp <= SLICE_FLOATS
        assert fits or n == min(MAX_RANKS, groups)
        cap = min(MAX_RANKS, groups)
        if K * tiles > active(n, rows):    # more than one wave: forced
            assert all(K * tiles > active(m, rows)
                       for m in range(n + 1, cap + 1))
            assert n == 1 or not all(
                -(-(d1 - d0) // 4) * 4 * hp <= SLICE_FLOATS
                for d0, d1 in tops.expert_slices(D, n - 1))
        elif n < cap:                      # the largest one-wave cluster
            assert K * tiles > active(n + 1, rows)


@pytest.mark.parametrize("B,M,h", [(32, 10, 128), (64, 3, 64), (16, 17, 32)])
def test_cosine_scores_matches_reference_kernel(jref, B, M, h):
    """Held to the kernel's rsqrt(sum + eps) form, zero padding rows
    included; masked classes exactly -inf."""
    jnp, ops, _ = jref
    rng = np.random.default_rng(B + M)
    z = rng.standard_normal((B, h)).astype(np.float32)
    z[-1] = 0.0                         # a router zero-padding row
    c = rng.standard_normal((M, h)).astype(np.float32)
    mask = (np.arange(M) < max(M - 2, 1)).astype(np.float32)
    want = np.asarray(ops.cosine_scores(jnp.asarray(z), jnp.asarray(c),
                                        jnp.asarray(mask)))
    got = tops.cosine_scores(torch.from_numpy(z), torch.from_numpy(c),
                             torch.from_numpy(mask)).numpy()
    assert (np.isneginf(got) == (mask[None, :] == 0)).all()
    assert (np.isinf(got) == np.isinf(want)).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-5, atol=1e-6)


DECODE_GRID = [
    (4, 8, 2, 64, 512, 0, "float32"),
    (2, 4, 4, 64, 256, 0, "float32"),
    (4, 8, 2, 64, 512, 128, "float32"),
    (1, 16, 2, 128, 512, 0, "float32"),
    (2, 8, 2, 64, 512, 0, "bfloat16"),
]


def _decode_inputs(B, H, KV, dh, S, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, dh)).astype(np.float32)
    t = S - S // 3
    kv_pos = np.where(np.arange(S) <= t, np.arange(S), -1).astype(np.int32)
    return q, k, v, np.int32(t), kv_pos


@pytest.mark.parametrize("live", ["prefix", "none"])
def test_decode_attention_plain_log_sum_exp(live):
    """``return_lse``: the plain version's output equals the plain
    ``attention`` one, and its lse the float64 log-sum-exp of the masked
    scaled scores (an empty ring: -1e30 + log S); two halves of the slots
    combined by their lse's give the whole (the sharded decode's
    combine)."""
    B, H, KV, dh, S = 3, 8, 2, 32, 64
    q, k, v, t, kv_pos = (torch.from_numpy(np.asarray(a)) for a in
                          _decode_inputs(B, H, KV, dh, S, seed=7))
    if live == "none":
        kv_pos = torch.full_like(kv_pos, -1)
    o, lse = tops.decode_attention_plain(q, k, v, t, kv_pos, return_lse=True)
    torch.testing.assert_close(o, tops.decode_attention_plain(
        q, k, v, t, kv_pos), rtol=2e-6, atol=2e-6)
    s = torch.einsum("bhd,bshd->bhs", q.double(), k.double().repeat_interleave(
        H // KV, dim=2)) / np.sqrt(dh)
    s = torch.where((kv_pos >= 0) & (kv_pos <= t), s,
                    torch.full_like(s, -1e30))
    torch.testing.assert_close(lse.double(), torch.logsumexp(s, -1),
                               rtol=1e-6, atol=1e-5)
    half = [tops.decode_attention_plain(q, k[:, i:i + S // 2],
                                        v[:, i:i + S // 2], t,
                                        kv_pos[i:i + S // 2],
                                        return_lse=True)
            for i in (0, S // 2)]
    top = torch.maximum(half[0][1], half[1][1])
    w = [torch.exp(h[1] - top)[..., None] for h in half]
    comb = (w[0] * half[0][0] + w[1] * half[1][0]) / (w[0] + w[1])
    torch.testing.assert_close(comb, o, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("B,H,KV,dh,S,win,dtype", DECODE_GRID)
def test_decode_attention_matches_reference_kernel(jref, B, H, KV, dh, S,
                                                   win, dtype):
    jnp, ops, _ = jref
    q, k, v, t, kv_pos = _decode_inputs(B, H, KV, dh, S, seed=S + H)
    jd = getattr(jnp, dtype)
    want = np.asarray(ops.decode_attention(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        jnp.asarray(t), jnp.asarray(kv_pos), window=win, block_s=256),
        np.float32)
    td = getattr(torch, dtype)
    got = tops.decode_attention(
        torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
        torch.from_numpy(v).to(td), torch.tensor(t),
        torch.from_numpy(kv_pos), window=win)
    assert got.dtype == td and got.shape == (B, H, dh)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)


def test_decode_attention_ring_scramble_invariance(jref):
    """Scrambled (ring) slot order must not change the result; and the
    windowed ring agrees with the reference kernel."""
    jnp, ops, _ = jref
    B, H, KV, dh, S = 2, 4, 2, 32, 256
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, dh)).astype(np.float32)
    kv_pos = (np.arange(S) + 300 - S + 1).astype(np.int32)
    perm = rng.permutation(S)
    t = torch.tensor(300, dtype=torch.int32)
    got1 = tops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), t,
                                 torch.from_numpy(kv_pos), window=128)
    got2 = tops.decode_attention(
        torch.from_numpy(q), torch.from_numpy(np.ascontiguousarray(k[:, perm])),
        torch.from_numpy(np.ascontiguousarray(v[:, perm])), t,
        torch.from_numpy(kv_pos[perm]), window=128)
    torch.testing.assert_close(got1, got2, rtol=1e-5, atol=1e-6)
    want = np.asarray(ops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(300, jnp.int32), jnp.asarray(kv_pos), window=128,
        block_s=64))
    np.testing.assert_allclose(got1.numpy(), want, rtol=2e-5, atol=2e-5)


def test_cpu_calls_take_the_plain_path_and_count_nothing():
    """Launch counters move only where a CUDA kernel launches."""
    tops.reset_launches()
    params, states = _bank(2, 64, 16)
    tops.expert_score(_t(params), torch.rand(4, 64), _t(states))
    tops.cosine_scores(torch.rand(4, 16), torch.rand(3, 16), torch.ones(3))
    tops.cosine_fine(torch.rand(4, 16), torch.rand(2, 3, 16),
                     torch.ones(2, 3), torch.tensor([0, 1, 1, 0]))
    q, k, v, t, kv_pos = _decode_inputs(1, 4, 2, 32, 16, seed=0)
    tops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), torch.tensor(t),
                          torch.from_numpy(kv_pos))
    pages = torch.from_numpy(k).reshape(2, 8, 2, 32)
    tops.paged_decode_attention(torch.from_numpy(q), pages, pages,
                                torch.tensor([[1, 0]], dtype=torch.int32),
                                torch.tensor(t), torch.from_numpy(kv_pos))
    r, k, v, logw, u, S = (torch.from_numpy(a)
                           for a in _wkv_inputs(2, 4, 16, seed=0))
    tops.wkv_step(r, k, v, logw, u, S, out_state=S)
    assert tops.launches() == {"expert_score": 0, "cosine_scores": 0,
                               "decode_attention": 0,
                               "paged_decode_attention": 0, "wkv_step": 0}


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA card raises
    instead of silently taking a path."""
    q = torch.zeros(1, 4, 32, device="meta")
    k = torch.zeros(1, 8, 2, 32, device="meta")
    pos = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tops.decode_attention(q, k, k, pos[0], pos)
    with pytest.raises(ValueError, match="unsupported device"):
        tops.cosine_scores(q[0], q[0], pos[:4].float())
    with pytest.raises(ValueError, match="unsupported device"):
        tops.cosine_fine(q[0], q, pos[:4].float()[None], pos[:4])
    with pytest.raises(ValueError, match="unsupported device"):
        tops.paged_decode_attention(q, k[0], k[0], pos[None, :1], pos[0],
                                    pos)
    r = torch.zeros(1, 2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        S = torch.zeros(1, 2, 16, 16, device="meta")
        tops.wkv_step(r, r, r, r, r[0], S, out_state=S)


@pytest.mark.parametrize("B,KV,S,n", [
    (1, 8, 256, 1), (2, 8, 256, 1), (4, 8, 256, 1), (8, 8, 256, 1),
    (16, 8, 256, 1),  # the main path: 8 tiles, too few to split
    (4, 8, 100, 1),   # ragged S: 4 tiles
    (8, 8, 32, 1),    # one tile
    (1, 2, 4096, 8),  # a long ring, few (row, kv head) pairs
    (4, 8, 1000, 4),  # ragged, 32 tiles: 8 per rank
    (9, 8, 512, 2),
    (17, 8, 4096, 1),  # 136 blocks fill 132 SMs unsplit
])
def test_decode_split_plan(B, KV, S, n):
    """The planner returns a power of two <= 8 and <= ceil(S / 32), gives
    each rank at least 8 of a full cache's tiles, takes the smallest
    split whose B * KV * n blocks reach the SM count unless that cap
    stops it first, and gives the same split for a ring of S slots and a
    page table of n_lp * page = S slots."""
    assert tops.decode_split(B, KV, S, 132) == n      # an H100 SXM
    for n_sm in (132, 114, 16):
        n = tops.decode_split(B, KV, S, n_sm)
        tiles = -(-S // 32)
        cap = min(8, tiles)
        assert n >= 1 and n & (n - 1) == 0 and n <= cap
        assert n == 1 or 8 * n <= tiles
        if 2 * n <= cap and 16 * n <= tiles:
            assert B * KV * n >= n_sm
        assert n == 1 or B * KV * (n // 2) < n_sm
        for page in (1, 4, 8, 16):
            if S % page == 0:
                assert tops.decode_split(B, KV, (S // page) * page,
                                         n_sm) == n


def test_check_aligned_refuses_misaligned_starts():
    """The decode kernels copy K/V and load q as 16-byte vectors: a
    tensor that starts off 16 bytes raises before any launch."""
    from repro_torch.kernels.build import check_aligned
    base = torch.zeros(64)
    check_aligned("decode_attention", q=base[:16], k=base[4:20])
    with pytest.raises(ValueError, match="k must start on 16 bytes"):
        check_aligned("decode_attention", q=base[:16], k=base[1:17])
    with pytest.raises(ValueError, match="v must start on 16 bytes"):
        check_aligned("decode_attention", v=base.bfloat16()[4:12])


def _wkv_inputs(B, H, P, seed):
    """r/k/v/logw (B, H, P), u (H, P), state (B, H, P, P), as
    tests/test_kernels.py draws them (with numpy)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    r, k, v = (rng.standard_normal((B, H, P)).astype(f) for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, H, P)) * 0.5).astype(f)
    u = (rng.standard_normal((H, P)) * 0.2).astype(f)
    S = rng.standard_normal((B, H, P, P)).astype(f)
    return r, k, v, logw, u, S


@pytest.mark.parametrize("B,H,P,dtype,tol", [
    (2, 4, 32, "float32", 2e-5), (1, 8, 64, "float32", 2e-5),
    (4, 2, 16, "float32", 2e-5),
    (1, 2, 32, "float32", 5e-5), (3, 4, 32, "float32", 5e-5),
    (2, 8, 32, "float32", 5e-5), (1, 2, 32, "bfloat16", 5e-5),
    (3, 4, 32, "bfloat16", 5e-5), (2, 8, 32, "bfloat16", 5e-5)])
def test_wkv_step_plain_matches_reference_kernel(jref, B, H, P, dtype, tol):
    """The grid and tolerances of tests/test_kernels.py's wkv tests: bf16
    r/k/v/logw/u are upcast on both sides and the state stays f32, so the
    outputs agree to f32 rounding."""
    from repro.kernels.wkv_step import wkv_step_pallas
    jnp = jref[0]
    r, k, v, logw, u, S = _wkv_inputs(B, H, P, seed=B * 100 + H + P)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jo, js = wkv_step_pallas(*(jnp.asarray(a).astype(jd)
                               for a in (r, k, v, logw, u)),
                             jnp.asarray(S), interpret=True)
    to, ts = tops.wkv_step_plain(*(torch.from_numpy(a).to(td)
                                   for a in (r, k, v, logw, u)),
                                 torch.from_numpy(S))
    assert to.dtype == ts.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=tol, atol=tol)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=tol, atol=tol)


def test_wkv_step_wrapper_checks_and_aliasing():
    """The wrapper refuses dtypes the kernel does not take on every
    device; in place (``out_state=state``) and into a new buffer give the
    same values."""
    r, k, v, logw, u, S = (torch.from_numpy(a)
                           for a in _wkv_inputs(2, 4, 16, seed=1))
    o1, s1 = tops.wkv_step(r, k, v, logw, u, S,
                           out_state=torch.empty_like(S))
    S2 = S.clone()
    o2, s2 = tops.wkv_step(r, k, v, logw, u, S2, out_state=S2)
    assert s2 is S2 and s1 is not S
    torch.testing.assert_close(o1, o2, rtol=0, atol=0)
    torch.testing.assert_close(s1, s2, rtol=0, atol=0)
    h = torch.float16
    for args in ((r.to(h), k.to(h), v.to(h), logw, u, S),
                 (r, k.bfloat16(), v, logw, u, S),
                 (r, k, v, logw.bfloat16(), u, S),
                 (r, k, v, logw, u.double(), S),
                 (r, k, v, logw, u, S.bfloat16())):
        with pytest.raises(ValueError, match="wkv_step"):
            tops.wkv_step(*args, out_state=args[-1])
    with pytest.raises(ValueError, match="shape mismatch"):
        tops.wkv_step(r, k, v, logw, u[:1], S, out_state=S)


# -- on the card: each CUDA kernel against its plain version --------------


@pytest.mark.cuda
@pytest.mark.parametrize("B,D,H,K", EXPERT_GRID)
def test_cuda_expert_score_kernel(cuda, B, D, H, K):
    params, states = _bank(K, D, H, seed=B + K)
    folded = tops.fold_bank(_t(params, cuda), _t(states, cuda))
    x = torch.rand(B, D, device=cuda)
    n0 = tops.expert_score_folded.launches
    got = tops.expert_score_folded(folded, x)
    assert tops.expert_score_folded.launches == n0 + 1
    want = tops.expert_score_plain(folded, x)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("B,D,H,K,offset", [
    (1, 784, 128, 6, 0),      # one row
    (33, 784, 128, 6, 0),     # two row tiles, the second of 16 rows
    (33, 98, 128, 6, 0),      # x / W2 rows off 16 bytes: 4-byte copies
    (32, 784, 128, 6, 1),     # x itself starts 4 bytes past 16
    (5, 98, 30, 4, 0),        # H not a multiple of 4: 4-byte W1 copies
])
def test_cuda_expert_score_ragged_and_unaligned(cuda, B, D, H, K, offset):
    """Ragged row tiles and slices, and rows or tensors that do not start
    on 16 bytes, go through the kernel (never the plain version) and
    agree with the plain version; two launches give the same bits."""
    params, states = _bank(K, D, H, seed=B + D)
    folded = tops.fold_bank(_t(params, cuda), _t(states, cuda))
    flat = torch.rand(B * D + 4, device=cuda)
    x = flat[offset:offset + B * D].view(B, D)
    n0 = tops.expert_score_folded.launches
    got = tops.expert_score_folded(folded, x)
    assert tops.expert_score_folded.launches == n0 + 1
    torch.testing.assert_close(got, tops.expert_score_plain(folded, x),
                               rtol=2e-5, atol=1e-6)
    assert torch.equal(got, tops.expert_score_folded(folded, x))


@pytest.mark.cuda
@pytest.mark.parametrize("B,K", [(32, 6), (32, 8), (64, 6), (64, 4)])
def test_cuda_expert_split_fits_one_wave(cuda, B, K):
    """On the card the planner reads the occupancy query: the K x tiles
    clusters it plans are all resident at once, one more block per
    cluster would not keep them so, and fewer blocks per cluster never
    fit fewer clusters; the launch agrees with the plain version."""
    from repro_torch.kernels.expert_score import MAX_RANKS, max_clusters
    D, H = 784, 128
    n, rows = tops.expert_split(
        B, D, H, K, lambda n, r: max_clusters(cuda.index, D, H, n, r))
    active = [max_clusters(cuda.index, D, H, m, rows)
              for m in range(7, MAX_RANKS + 1)]
    assert all(a >= b for a, b in zip(active, active[1:]))
    tiles = -(-B // rows)
    assert K * tiles <= max_clusters(cuda.index, D, H, n, rows)
    if n < MAX_RANKS:
        assert K * tiles > max_clusters(cuda.index, D, H, n + 1, rows)
    params, states = _bank(K, D, H, seed=B * K)
    folded = tops.fold_bank(_t(params, cuda), _t(states, cuda))
    x = torch.rand(B, D, device=cuda)
    torch.testing.assert_close(tops.expert_score_folded(folded, x),
                               tops.expert_score_plain(folded, x),
                               rtol=2e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("B,M,h", [(32, 10, 128), (64, 3, 64), (16, 17, 32),
                                   (5, 10, 128)])
def test_cuda_cosine_scores_kernel(cuda, B, M, h):
    z = torch.randn(B, h, device=cuda)
    z[-1] = 0.0
    c = torch.randn(M, h, device=cuda)
    mask = (torch.arange(M, device=cuda) < max(M - 2, 1)).float()
    got = tops.cosine_scores(z, c, mask)
    want = tops.cosine_scores_plain(z, c, mask)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=2e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,dh,S,win,dtype", DECODE_GRID + [
    (16, 32, 8, 64, 256, 0, "bfloat16"),     # llama3_2_1b decode
    (3, 8, 8, 32, 100, 24, "float32"),       # ragged S, G = 1, window
])
def test_cuda_decode_attention_kernel(cuda, B, H, KV, dh, S, win, dtype):
    q, k, v, t, kv_pos = _decode_inputs(B, H, KV, dh, S, seed=S + H)
    td = getattr(torch, dtype)
    args = (torch.from_numpy(q).to(cuda, td), torch.from_numpy(k).to(cuda, td),
            torch.from_numpy(v).to(cuda, td),
            torch.tensor(t, device=cuda), torch.from_numpy(kv_pos).to(cuda))
    got = tops.decode_attention(*args, window=win)
    want = tops.decode_attention_plain(*args, window=win)
    tol = 4e-3 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("live", ["first", "last", "one", "middle"])
def test_cuda_decode_attention_skips_dead_tiles_exactly(cuda, live):
    """The kernel skips 32-slot tiles with no live slot; that must give
    what the plain version gives over the whole ring, wherever the live
    slots sit (at the front as after a prefill, behind dead tiles, a
    single slot, or between dead tiles)."""
    B, H, KV, dh, S = 3, 8, 2, 64, 200
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(B, H, dh, device=cuda, generator=g)
    k = torch.randn(B, S, KV, dh, device=cuda, generator=g)
    v = torch.randn(B, S, KV, dh, device=cuda, generator=g)
    t = torch.tensor(500, dtype=torch.int32, device=cuda)
    pos = torch.full((S,), -1, dtype=torch.int32, device=cuda)
    span = {"first": (0, 40), "last": (170, 200), "one": (101, 102),
            "middle": (64, 130)}[live]
    pos[span[0]:span[1]] = torch.arange(*span, dtype=torch.int32,
                                        device=cuda)
    if span[1] - span[0] > 1:
        pos[span[0]] = 600          # a slot ahead of q_pos is masked too
    torch.testing.assert_close(
        tops.decode_attention(q, k, v, t, pos),
        tops.decode_attention_plain(q, k, v, t, pos), rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_cuda_decode_attention_empty_and_scrambled_ring(cuda):
    """An all-empty cache averages V like the plain softmax, and slot
    order does not matter on the card either."""
    B, H, KV, dh, S = 2, 4, 2, 32, 96
    q = torch.randn(B, H, dh, device=cuda)
    k = torch.randn(B, S, KV, dh, device=cuda)
    v = torch.randn(B, S, KV, dh, device=cuda)
    t = torch.tensor(150, dtype=torch.int32, device=cuda)
    empty = torch.full((S,), -1, dtype=torch.int32, device=cuda)
    torch.testing.assert_close(
        tops.decode_attention(q, k, v, t, empty),
        tops.decode_attention_plain(q, k, v, t, empty), rtol=2e-5, atol=2e-5)
    kv_pos = (torch.arange(S, device=cuda) + 150 - S + 1).to(torch.int32)
    perm = torch.randperm(S, device=cuda)
    a = tops.decode_attention(q, k, v, t, kv_pos, window=64)
    b = tops.decode_attention(q, k[:, perm].contiguous(),
                              v[:, perm].contiguous(), t, kv_pos[perm],
                              window=64)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def _split_ring(kind, S, seed):
    """kv_pos (S,) and q_pos of a ring whose live slots are a prefix
    ("prefix"), one slot ("one": fewer live tiles than ranks), scattered
    32-slot tiles of a ring scrambled tile by tile and slot by slot
    ("scrambled"), or none ("empty")."""
    rng = np.random.default_rng(seed)
    pos = np.full(S, -1, np.int64)
    t = S // 3
    if kind == "prefix":
        pos[:t + 1] = np.arange(t + 1)
    elif kind == "one":
        pos[S // 2 + 5] = t
    elif kind == "scrambled":
        tiles = rng.permutation(S // 32)
        slots = (tiles[:, None] * 32 + rng.permutation(32)).reshape(-1)
        pos[slots] = np.arange(S)
    return pos.astype(np.int32), np.int32(t)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["prefix", "one", "scrambled", "empty"])
@pytest.mark.parametrize("B,H,KV,dh,S,dtype,n", [
    (17, 8, 8, 32, 256, "float32", 1),       # 8 tiles: no split
    (9, 32, 8, 64, 512, "bfloat16", 2),
    (5, 16, 8, 64, 1024, "float32", 4),
    (1, 8, 2, 128, 2048, "bfloat16", 8),
    (1, 32, 8, 64, 4096, "bfloat16", 8),     # 16 tiles per rank
])
def test_cuda_decode_attention_cluster_split(cuda, B, H, KV, dh, S, dtype, n,
                                             kind):
    """Each split the planner gives on an H100 (132 SMs) against the
    plain version, wherever the live slots sit; two launches give the
    same bits (the ranks combine in a fixed order)."""
    from repro_torch.kernels.build import sm_count
    assert tops.decode_split(B, KV, S, sm_count(cuda.index)) == n
    q, k, v, _, _ = _decode_inputs(B, H, KV, dh, S, seed=S + n)
    kv_pos, t = _split_ring(kind, S, seed=S + B)
    td = getattr(torch, dtype)
    args = (torch.from_numpy(q).to(cuda, td), torch.from_numpy(k).to(cuda, td),
            torch.from_numpy(v).to(cuda, td),
            torch.tensor(t, device=cuda), torch.from_numpy(kv_pos).to(cuda))
    got = tops.decode_attention(*args)
    want = tops.decode_attention_plain(*args)
    tol = 4e-3 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(got, tops.decode_attention(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["prefix", "empty"])
@pytest.mark.parametrize("B,H,KV,dh,S,dtype", [
    (8, 64, 8, 128, 2048, "bfloat16"),       # a qwen2_72b slot shard
    (9, 32, 8, 64, 512, "bfloat16"),         # split over 2
    (1, 8, 2, 128, 2048, "float32"),         # split over 8
])
def test_cuda_decode_attention_log_sum_exp(cuda, B, H, KV, dh, S, dtype,
                                           kind):
    """``return_lse`` on the card (the sharded decode's combine reads
    it): the lse within 1e-4 of the plain version's, unsplit and over a
    cluster, an empty ring's included; the output bit-equal to the
    launch without it."""
    q, k, v, _, _ = _decode_inputs(B, H, KV, dh, S, seed=S + B)
    kv_pos, t = _split_ring(kind, S, seed=S)
    td = getattr(torch, dtype)
    args = (torch.from_numpy(q).to(cuda, td), torch.from_numpy(k).to(cuda, td),
            torch.from_numpy(v).to(cuda, td),
            torch.tensor(t, device=cuda), torch.from_numpy(kv_pos).to(cuda))
    got, lse = tops.decode_attention(*args, return_lse=True)
    _, want = tops.decode_attention_plain(*args, return_lse=True)
    torch.testing.assert_close(lse, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, tops.decode_attention(*args))


@pytest.mark.cuda
def test_cuda_decode_attention_refuses_misaligned(cuda):
    """q, k, v or a page pool that starts off 16 bytes, or a page stride
    that is not a multiple of 16 bytes, raises instead of launching."""
    B, H, KV, dh, S = 2, 8, 2, 64, 64
    q = torch.randn(B, H, dh, device=cuda)
    k = torch.randn(B, S, KV, dh, device=cuda)
    t = torch.tensor(10, dtype=torch.int32, device=cuda)
    pos = torch.arange(S, dtype=torch.int32, device=cuda)
    flat = torch.zeros(k.numel() + 4, device=cuda)
    off = flat[1:1 + k.numel()].view(k.shape)
    n0 = tops.decode_attention.launches
    for args in ((q, off, k), (q, k, off),
                 (torch.zeros(q.numel() + 4, device=cuda)[2:2 + q.numel()]
                  .view(q.shape), k, k)):
        with pytest.raises(ValueError, match="start on 16 bytes"):
            tops.decode_attention(*args, t, pos)
    page, P1 = 8, 5
    tbl = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device=cuda)
    ppos = torch.arange(2 * page, dtype=torch.int32, device=cuda)
    step = page * KV * dh
    pool = torch.zeros(P1 * (step + 1) + 4, device=cuda)
    odd = pool.as_strided((P1, page, KV, dh), (step + 1, KV * dh, dh, 1))
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        tops.paged_decode_attention(q, odd, odd, tbl, t, ppos)
    shifted = pool[1:1 + P1 * step].view(P1, page, KV, dh)
    with pytest.raises(ValueError, match="start on 16 bytes"):
        tops.paged_decode_attention(q, shifted, shifted, tbl, t, ppos)
    assert tops.decode_attention.launches == n0


def _paged_case(cuda, B, H, KV, dh, page, nlp, L, dtype, seed, pad=0):
    """Layer view L // 2 of a (P1, L, page, KV, dh + pad) pool on the
    card, with the scrambled table of tests/test_torch_paged.py."""
    from test_torch_paged import paged_inputs
    q, kp, vp, tbl, qp, kv_pos = paged_inputs(B, H, KV, dh, page, nlp, seed,
                                              layers=L, pad=pad)
    td = getattr(torch, dtype)
    i = L // 2

    def card(a):
        return torch.from_numpy(a).to(cuda)

    return (card(q).to(td), card(kp).to(td)[:, i, ..., :dh],
            card(vp).to(td)[:, i, ..., :dh], card(tbl),
            torch.tensor(int(qp), dtype=torch.int32, device=cuda),
            card(kv_pos))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,dh,page,nlp,win,dtype", [
    (3, 8, 2, 64, 8, 8, 0, "float32"),
    (2, 4, 4, 64, 16, 4, 0, "float32"),
    (3, 8, 2, 64, 8, 8, 24, "float32"),
    (1, 16, 2, 128, 8, 4, 0, "float32"),
    (2, 8, 2, 64, 8, 8, 0, "bfloat16"),
    (16, 32, 8, 64, 8, 32, 0, "bfloat16"),   # llama3_2_1b paged decode
    (4, 32, 8, 64, 16, 16, 100, "bfloat16"),
])
def test_cuda_paged_decode_attention_kernel(cuda, B, H, KV, dh, page, nlp,
                                            win, dtype):
    args = _paged_case(cuda, B, H, KV, dh, page, nlp, 3, dtype,
                       seed=page * nlp + H)
    n0 = tops.paged_decode_attention.launches
    got = tops.paged_decode_attention(*args, window=win)
    assert tops.paged_decode_attention.launches == n0 + 1
    want = tops.paged_decode_attention_plain(*args, window=win)
    tol = 4e-3 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # the ring kernel on the gathered (contiguous) view: same tiles, same
    # order, same arithmetic
    from repro_torch.models.attention import paged_gather
    q, kp, vp, tbl, qp, kv_pos = args
    kd, vd = paged_gather(kp, vp, tbl)
    ring = tops.decode_attention(q, kd.contiguous(), vd.contiguous(), qp,
                                 kv_pos, window=win)
    assert torch.equal(got, ring)


@pytest.mark.cuda
def test_cuda_paged_decode_attention_refuses_copies(cuda):
    """Pages whose (page, KV, dh) is not contiguous raise instead of
    being copied."""
    args = _paged_case(cuda, 2, 8, 2, 64, 8, 4, 2, "float32", seed=0, pad=8)
    with pytest.raises(ValueError, match="contiguous"):
        tops.paged_decode_attention(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,P,dtype", [
    (3, 4, 16, "float32"), (2, 8, 32, "float32"), (2, 4, 64, "float32"),
    (1, 2, 32, "bfloat16"), (8, 64, 64, "bfloat16"),     # rwkv6_7b decode
    (32, 64, 64, "bfloat16"),                            # a large bucket
])
def test_cuda_wkv_step_kernel(cuda, B, H, P, dtype):
    """Kernel against plain, f32 sums in another order (and an FMA in the
    state update): rtol = atol = 1e-4. In place and into a new buffer the
    kernel gives the same bits, and so do two launches into new
    buffers."""
    td = getattr(torch, dtype)
    r, k, v, logw, u, S = (torch.from_numpy(a).to(cuda)
                           for a in _wkv_inputs(B, H, P, seed=B + H + P))
    r, k, v = r.to(td), k.to(td), v.to(td)
    n0 = tops.wkv_step.launches
    o, s_new = tops.wkv_step(r, k, v, logw, u, S,
                             out_state=torch.empty_like(S))
    assert tops.wkv_step.launches == n0 + 1
    wo, ws = tops.wkv_step_plain(r, k, v, logw, u, S)
    torch.testing.assert_close(o, wo, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s_new, ws, rtol=1e-4, atol=1e-4)
    S2 = S.clone()
    o2, s2 = tops.wkv_step(r, k, v, logw, u, S2, out_state=S2)
    assert s2 is S2
    assert torch.equal(o2, o) and torch.equal(S2, s_new)
    o3, s3 = tops.wkv_step(r, k, v, logw, u, S, out_state=torch.empty_like(S))
    assert torch.equal(o3, o) and torch.equal(s3, s_new)


@pytest.mark.cuda
def test_cuda_wkv_step_chain_and_refusals(cuda):
    """64 chained in-place kernel steps against 64 plain steps, at the
    decode's tolerance; other head sizes and overlapping buffers raise."""
    B, H, P = 4, 8, 64
    rng = np.random.default_rng(2)
    S = torch.zeros(B, H, P, P, device=cuda)
    want = S.clone()
    u = torch.from_numpy(rng.standard_normal((H, P)).astype(np.float32)
                         * 0.2).to(cuda)
    for _ in range(64):
        r, k, v, logw, _, _ = (torch.from_numpy(a).to(cuda)
                               for a in _wkv_inputs(B, H, P,
                                                    seed=int(rng.integers(
                                                        1 << 30))))
        r, k, v = r.bfloat16(), k.bfloat16(), v.bfloat16()
        o, _ = tops.wkv_step(r, k, v, logw, u, S, out_state=S)
        wo, want = tops.wkv_step_plain(r, k, v, logw, u, want)
        torch.testing.assert_close(o, wo, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(S, want, rtol=1e-4, atol=1e-4)
    r, k, v, logw, u, S = (torch.from_numpy(a).to(cuda)
                           for a in _wkv_inputs(1, 2, 48, seed=0))
    with pytest.raises(ValueError, match="head size"):
        tops.wkv_step(r, k, v, logw, u, S, out_state=S)
    r, k, v, logw, u, S = (torch.from_numpy(a).to(cuda)
                           for a in _wkv_inputs(2, 2, 16, seed=0))
    big = torch.zeros(2 * S.numel() + 16, device=cuda)
    with pytest.raises(ValueError, match="overlaps"):
        tops.wkv_step(r, k, v, logw, u, big[:S.numel()].view_as(S),
                      out_state=big[16:16 + S.numel()].view_as(S))


@pytest.mark.cuda
def test_cuda_wkv_step_refuses_misaligned_state(cuda):
    """The kernel moves the state as 16-byte vectors: a state or
    out_state that starts off 16 bytes raises before any launch."""
    r, k, v, logw, u, S = (torch.from_numpy(a).to(cuda)
                           for a in _wkv_inputs(2, 2, 16, seed=0))
    off = torch.zeros(S.numel() + 4, device=cuda)[1:1 + S.numel()].view_as(S)
    n0 = tops.wkv_step.launches
    with pytest.raises(ValueError, match="state must start on 16 bytes"):
        tops.wkv_step(r, k, v, logw, u, off, out_state=off)
    with pytest.raises(ValueError, match="out_state must start on 16 bytes"):
        tops.wkv_step(r, k, v, logw, u, S, out_state=off)
    assert tops.wkv_step.launches == n0
