"""The port's matcher and router against the reference on a small
JAX-trained AE bank: scores within rtol 2e-5, expert and class indices
equal."""
import jax
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro.core import MatcherConfig, build_matcher, train_bank
from repro.core.autoencoder import bank_scores
from repro.data import load_benchmark
from repro.serve.router import Router
from repro_torch import core as tcore
from repro_torch.bridge import to_torch
from repro_torch.core.autoencoder import bank_scores as t_bank_scores
from repro_torch.serve.router import Router as TRouter


@pytest.fixture(scope="module")
def bench():
    return load_benchmark(names=["mnist", "har"], n_per_dataset=400, seed=0)


@pytest.fixture(scope="module")
def trained(bench):
    names = list(bench)
    aes, _ = train_bank([(n, bench[n]["server"][0]) for n in names],
                        epochs=4, batch_size=64)
    cents = [(bench[n]["server"][0], bench[n]["server"][1]) for n in names]
    return aes, names, cents


def _pair(trained, **cfg):
    aes, names, cents = trained
    jm = build_matcher(aes, names, cents, MatcherConfig(**cfg))
    tm = tcore.ExpertMatcher(
        to_torch(jax.device_get(jm.bank_params), device="cpu"),
        to_torch(jax.device_get(jm.bank_states), device="cpu"), names,
        to_torch(np.asarray(jm.centroids), device="cpu"),
        to_torch(np.asarray(jm.centroid_mask), device="cpu"),
        tcore.MatcherConfig(**cfg))
    return jm, tm


@pytest.fixture(scope="module")
def feats(bench):
    return np.concatenate([bench[n]["client_a"][0][:48] for n in bench])


def test_bank_scores(trained, feats):
    jm, tm = _pair(trained)
    want = np.asarray(bank_scores(jm.bank_params, jm.bank_states, feats))
    got = t_bank_scores(tm.bank_params, tm.bank_states,
                        torch.from_numpy(feats))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("cfg", [{"metric": "mse"}, {"metric": "cosine"},
                                 {"use_kernel": True}],
                         ids=["mse", "cosine", "kernel"])
def test_coarse_scores_and_assignment(trained, feats, cfg):
    jm, tm = _pair(trained, **cfg)
    x = torch.from_numpy(feats)
    want = np.asarray(jm.coarse_scores(feats))
    np.testing.assert_allclose(tm.coarse_scores(x).numpy(), want,
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(tm.assign_coarse(x).numpy(),
                                  np.asarray(jm.assign_coarse(feats)))


def test_fine_scores_and_assignment(trained, feats):
    jm, tm = _pair(trained)
    e = np.array(jm.assign_coarse(feats))
    want = np.asarray(jm.fine_scores(feats, e))
    got = tm.fine_scores(torch.from_numpy(feats),
                         torch.from_numpy(e)).numpy()
    assert (np.isneginf(got) == np.isneginf(want)).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(
        tm.assign_fine(torch.from_numpy(feats)).numpy(),
        np.asarray(jm.assign_fine(feats)))


@pytest.mark.parametrize("top_k", [1, 2])
def test_route(trained, feats, top_k):
    jm, tm = _pair(trained, top_k=top_k)
    want = jm.route(feats)
    got = tm.route(torch.from_numpy(feats))
    np.testing.assert_array_equal(got["coarse"].numpy(),
                                  np.asarray(want["coarse"]))
    np.testing.assert_array_equal(got["fine"].numpy(),
                                  np.asarray(want["fine"]))
    np.testing.assert_allclose(got["coarse_score"].numpy(),
                               np.asarray(want["coarse_score"]), rtol=2e-5,
                               atol=1e-6)


def test_build_matcher_centroids(trained):
    """The port's build_matcher on bridged AEs computes the reference's
    class centroids and masks."""
    aes, names, cents = trained
    jm = build_matcher(aes, names, cents)
    taes = [tuple(to_torch(jax.device_get(t), device="cpu") for t in ae)
            for ae in aes]
    tm = tcore.build_matcher(taes, names, cents, device="cpu")
    np.testing.assert_allclose(tm.centroids.numpy(), np.asarray(jm.centroids),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(tm.centroid_mask.numpy(),
                                  np.asarray(jm.centroid_mask))


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain-coarse", "kernel-coarse"])
def test_router_matches_reference(trained, feats, use_kernel):
    """Every RouteResult field equals the reference Router's on the same
    features — fine assignment through the cosine kernel, bucketed and
    chunked rows, LRU hits on the repeat."""
    jm, tm = _pair(trained, use_kernel=use_kernel)
    jr, tr = Router(jm, max_rows=32), TRouter(tm, max_rows=32)
    for x in (feats[:40], feats[20:70]):      # second call: partial hits
        want, got = jr.route(x), tr.route(x)
        np.testing.assert_array_equal(got.coarse, want.coarse)
        np.testing.assert_array_equal(got.fine, want.fine)
        np.testing.assert_allclose(got.coarse_score, want.coarse_score,
                                   rtol=2e-5, atol=1e-6)
        assert got.cache_hits == want.cache_hits
    assert tr.stats == jr.stats
    assert dict(tr.expert_hits) == dict(jr.expert_hits)
