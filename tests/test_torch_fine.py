"""The grouped fine-match entry, ``cosine_fine``: every row against its
own expert's centroids of the stacked (K, M, h) tensor, and the row's
best class.

On the CPU the plain version is held to the reference: per expert
group, ``repro.kernels.ops.cosine_scores`` (the Pallas kernel in
interpret mode, as tests/test_kernels.py runs it) then ``jnp.argmax``,
scattered back to the rows, at rtol 2e-5 / atol 1e-6 with equal classes;
the inputs hold zero padding rows, an expert whose classes are all
masked (class 0) and two bit-identical centroids (the lower index
wins). The router makes one ``cosine_fine`` call per route chunk. The
``cuda`` cases hold the kernel to the plain version on the card, the
grouped launch bit-equal to per-group ``cosine_scores`` launches and to
itself, over several (K, M, h), h above 128 on both load paths (300
and 256), an h that is not a multiple of 4 and a z that does not start
on 16 bytes; they skip elsewhere.
"""
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.kernels import ops as tops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _grouped(K, M, h, seed):
    """z (R, h) of K expert groups (rows of expert e: 1 + e % 4 real ones,
    then zero padding up to a power of two, as the router pads), the
    stacked centroids (K, M, h) and mask (K, M), and expert (R,) int32.
    When K > 1, expert 0's classes are all masked; expert 1 (and the
    last, when K > 2) has centroids 1 and 3 bit-identical, with a row on
    each that ties them."""
    rng = np.random.default_rng(seed)
    f = np.float32
    c = rng.standard_normal((K, M, h)).astype(f)
    mask = (rng.random((K, M)) < 0.75).astype(f)
    if K > 1:
        mask[0] = 0.0
    zs, es = [], []
    for e in range(K):
        n = 1 + e % 4
        nb = 1 << (n - 1).bit_length()
        z = np.zeros((nb, h), f)
        z[:n] = rng.standard_normal((n, h)).astype(f)
        if e in (1, K - 1) and e > 0:
            c[e, 3] = c[e, 1]
            mask[e, 1] = mask[e, 3] = 1.0
            z[0] = 2.0 * c[e, 1]
        zs.append(z)
        es.append(np.full(nb, e, np.int32))
    return np.concatenate(zs), c, mask, np.concatenate(es)


GRID = [(6, 10, 128), (3, 17, 64), (2, 40, 32)]


@pytest.mark.parametrize("K,M,h", GRID)
def test_cosine_fine_plain_matches_reference(K, M, h):
    import jax.numpy as jnp
    from repro.kernels import ops
    z, c, mask, expert = _grouped(K, M, h, seed=K * 100 + M)
    want = np.zeros((len(z), M), np.float32)
    want_cls = np.zeros(len(z), np.int64)
    for e in range(K):
        rows = np.flatnonzero(expert == e)
        sim = ops.cosine_scores(jnp.asarray(z[rows]), jnp.asarray(c[e]),
                                jnp.asarray(mask[e]))
        want[rows] = np.asarray(sim)
        want_cls[rows] = np.asarray(jnp.argmax(sim, axis=-1))
    got, cls = tops.cosine_fine(*(torch.from_numpy(a)
                                  for a in (z, c, mask, expert)))
    got = got.numpy()
    assert (np.isneginf(got) == np.isneginf(want)).all()
    assert np.isneginf(got[expert == 0]).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(cls.numpy(), want_cls)
    assert (want_cls[expert == 0] == 0).all()
    tie = np.flatnonzero(expert == 1)[0]
    assert want_cls[tie] == 1 and got[tie, 1] == got[tie, 3]


def test_router_makes_one_fine_call_per_route_chunk(monkeypatch):
    """A route chunk's expert groups go through one ``cosine_fine``
    call; ``score_calls`` still counts groups; a repeat hits the LRU and
    scores nothing."""
    from repro_torch.core import build_matcher, init_ae
    from repro_torch.serve import router as rmod
    rng = np.random.default_rng(0)
    names = ["a", "b", "c"]
    aes = [init_ae(torch.Generator().manual_seed(i), device="cpu")
           for i in range(len(names))]
    data = [(rng.random((64, 784), dtype=np.float32), np.arange(64) % 4)
            for _ in names]
    matcher = build_matcher(aes, names, data, device="cpu")
    calls = []

    def counted(z, centroids, mask, expert):
        calls.append(expert.numpy().copy())
        return tops.cosine_fine(z, centroids, mask, expert)

    monkeypatch.setattr(rmod, "cosine_fine", counted)
    router = rmod.Router(matcher, max_rows=16)
    feats = rng.random((40, 784), dtype=np.float32) \
        ** rng.uniform(0.2, 5.0, (40, 1)).astype(np.float32)
    res = router.route(feats)
    assert len(calls) == 3                         # 16 + 16 + 8 misses
    groups = sum(len(np.unique(res.coarse[lo:lo + 16, 0]))
                 for lo in range(0, 40, 16))
    assert router.stats["score_calls"] == groups > len(calls)
    for e in calls:                               # groups stacked in order
        assert (np.diff(e) >= 0).all()
    want = matcher.assign_fine(torch.from_numpy(feats),
                               torch.from_numpy(res.coarse[:, 0])).numpy()
    np.testing.assert_array_equal(res.fine, want)
    router.route(feats[:20])
    assert len(calls) == 3


# -- on the card -----------------------------------------------------------


def _on(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


def _check(got, want, cls, want_cls):
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=2e-5, atol=1e-6)
    assert torch.equal(cls, want_cls)


@pytest.mark.cuda
@pytest.mark.parametrize("K,M,h", GRID + [(6, 10, 64), (4, 33, 128),
                                          (2, 10, 30), (1, 5, 300),
                                          (2, 10, 300), (3, 12, 256)])
def test_cuda_cosine_fine_kernel(cuda, K, M, h):
    """Against the plain version (ties and all-masked rows included);
    one launch counted per call; two launches and per-group
    ``cosine_scores`` launches give the same bits."""
    z, c, mask, expert = _on(cuda, *_grouped(K, M, h, seed=K + M + h))
    n0 = tops.cosine_scores.launches
    got, cls = tops.cosine_fine(z, c, mask, expert)
    assert tops.cosine_scores.launches == n0 + 1
    want, want_cls = tops.cosine_fine_plain(z, c, mask, expert)
    _check(got, want, cls, want_cls)
    if K > 1:
        assert (cls[expert == 0] == 0).all()
        assert cls[(expert == 1).nonzero()[0, 0]] == 1
    else:
        assert torch.isfinite(got).any()
    again, cls2 = tops.cosine_fine(z, c, mask, expert)
    assert torch.equal(again, got) and torch.equal(cls2, cls)
    for e in range(K):
        rows = (expert == e).nonzero()[:, 0]
        one = tops.cosine_scores(z[rows].contiguous(), c[e], mask[e])
        assert torch.equal(one, got[rows])


@pytest.mark.cuda
def test_cuda_cosine_fine_unaligned(cuda):
    """A z that starts 4 bytes past 16 takes 4-byte loads and agrees
    with the plain version."""
    z, c, mask, expert = _grouped(6, 10, 128, seed=5)
    flat = torch.zeros(z.size + 4, device=cuda)
    zd = flat[1:1 + z.size].view(z.shape)
    zd.copy_(torch.from_numpy(z))
    c, mask, expert = _on(cuda, c, mask, expert)
    got, cls = tops.cosine_fine(zd, c, mask, expert)
    want, want_cls = tops.cosine_fine_plain(zd, c, mask, expert)
    _check(got, want, cls, want_cls)
