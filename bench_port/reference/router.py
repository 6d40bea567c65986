"""Plain reference of the ExpertMatcher's routing (the paper's Fig. 2): the
coarse match by least reconstruction error under each AE of the bank,
the fine match by the largest cosine between the request's bottleneck
under its expert and that expert's class centroids (the per-class mean
bottleneck of the expert's training set).

Computed in float64 on the host for the reference; ``dtype`` gives the
control's lower precision. Everything is worked out from the bank's AE
weights and the training sets, which the benchmark made.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

BN_EPS = 1e-5
COS_EPS = 1e-8


def _t(a, dtype):
    return torch.as_tensor(np.asarray(a)).to(dtype)


def encode(ae, x, dtype):
    p, s = ae
    h = x @ _t(p["w_enc"], dtype) + _t(p["b_enc"], dtype)
    hn = (h - _t(s["mean"], dtype)) * torch.rsqrt(_t(s["var"], dtype)
                                                  + BN_EPS)
    return torch.relu(hn * _t(p["bn_scale"], dtype) + _t(p["bn_bias"], dtype))


def coarse_scores(aes, x: np.ndarray, dtype=torch.float64) -> np.ndarray:
    """(N, K) reconstruction MSE of each fingerprint under each AE."""
    xt = _t(x, dtype)
    out = []
    for ae in aes:
        xhat = encode(ae, xt, dtype) @ _t(ae[0]["w_dec"], dtype) \
            + _t(ae[0]["b_dec"], dtype)
        out.append((xhat - xt).square().mean(-1))
    return torch.stack(out, 1).double().numpy()


def centroids(aes, data: Sequence[Tuple[np.ndarray, np.ndarray]],
              dtype=torch.float64) -> Tuple[np.ndarray, np.ndarray]:
    """(K, M, 128) class centroids and (K, M) validity over the experts'
    training sets (M the most classes any set has)."""
    m = max(int(y.max()) + 1 for _, y in data)
    cent = np.zeros((len(aes), m, 128))
    mask = np.zeros((len(aes), m), bool)
    for e, (ae, (x, y)) in enumerate(zip(aes, data)):
        z = encode(ae, _t(x, dtype), dtype).double().numpy()
        for c in range(int(y.max()) + 1):
            if (y == c).any():
                cent[e, c] = z[y == c].mean(0)
                mask[e, c] = True
    return cent, mask


def fine_scores(aes, cent, mask, x: np.ndarray, expert: np.ndarray,
                dtype=torch.float64) -> np.ndarray:
    """(N, M) cosine of each fingerprint's bottleneck under ``expert[i]``
    against that expert's centroids; -inf at invalid classes."""
    out = np.full((len(x), cent.shape[1]), -np.inf)
    for e in np.unique(expert):
        rows = np.flatnonzero(expert == e)
        z = encode(aes[int(e)], _t(x[rows], dtype), dtype).double().numpy()
        c = cent[int(e)]
        num = z @ c.T
        den = np.linalg.norm(z, axis=1)[:, None] * np.linalg.norm(c, axis=1)
        cos = num / np.maximum(den, COS_EPS)
        out[rows] = np.where(mask[int(e)][None], cos, -np.inf)
    return out


def route_errors(aes, data, x: np.ndarray, expert: np.ndarray,
                 score: np.ndarray, fine: np.ndarray,
                 dtype=torch.float64) -> np.ndarray:
    """Each request's routing error against the reference: the larger of
    (a) how far the served coarse score lies from the reference's best,
    as a share of that best (the score's own error where the expert is
    right, the gap to the right expert where it is not), and (b) how
    far the reference's cosine of the served fine class lies below the
    best class's, under the served expert."""
    cs = coarse_scores(aes, x, dtype)
    best = cs.min(1)
    err_c = np.abs(score - best) / np.maximum(best, 1e-30)
    cent, mask = centroids(aes, data, dtype)
    fs = fine_scores(aes, cent, mask, x, expert, dtype)
    got = fs[np.arange(len(x)), np.clip(fine, 0, fs.shape[1] - 1)]
    got = np.where((fine >= 0) & (fine < fs.shape[1]), got, -np.inf)
    return np.maximum(err_c, fs.max(1) - got)


def answers(aes, data, x: np.ndarray, dtype) -> Tuple[np.ndarray,
                                                       np.ndarray, np.ndarray]:
    """The routing computed in ``dtype``, as the system would serve it:
    (expert, its coarse score, fine class). The control's answers."""
    cs = coarse_scores(aes, x, dtype)
    expert = cs.argmin(1)
    cent, mask = centroids(aes, data, dtype)
    fine = fine_scores(aes, cent, mask, x, expert, dtype).argmax(1)
    return expert, cs[np.arange(len(x)), expert], fine
