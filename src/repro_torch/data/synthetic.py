"""Synthetic generative analogues of the paper's 6 benchmark datasets.

The port's own copy of the reference's ``repro.data.synthetic``: the
same numpy draws, bit for bit. STL-10 / MNIST / HAR / Reuters / NLOS / DR
are generated, never downloaded. Each generator reproduces the *statistics the paper's
claims depend on* (Table 1): sample counts, class counts, LC/SC class skew,
input dimensionality and modality structure — with per-dataset distinct
generative processes so reconstruction error separates them, and
within-dataset class structure so fine-grained matching is non-trivial.

All generators return (x (N, raw_dim...), y (N,)) in numpy; preprocessing
(resize->784 / adaptive-avg-pool->784) lives in ``preprocess.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    kind: str          # image | sensor | text
    n_classes: int
    n_samples: int
    raw_dim: Tuple[int, ...]
    lc_sc: Tuple[float, float]  # largest/smallest class percentage


SPECS: Dict[str, DatasetSpec] = {
    "stl10": DatasetSpec("stl10", "image", 10, 13_000, (32, 32), (10.0, 10.0)),
    "mnist": DatasetSpec("mnist", "image", 10, 10_000, (28, 28), (11.35, 8.92)),
    "har": DatasetSpec("har", "sensor", 6, 10_299, (561,), (19.0, 14.0)),
    "reuters": DatasetSpec("reuters", "text", 4, 10_000, (2000,), (43.12, 8.14)),
    "nlos": DatasetSpec("nlos", "image", 3, 45_096, (28, 28), (33.33, 33.33)),
    "db": DatasetSpec("db", "image", 3, 3_540, (28, 28), (33.33, 33.33)),
}


def _class_sizes(spec: DatasetSpec, n: int) -> np.ndarray:
    """Interpolate class sizes between SC and LC percentages."""
    lc, sc = spec.lc_sc
    fracs = np.linspace(sc, lc, spec.n_classes)
    fracs = fracs / fracs.sum()
    sizes = np.floor(fracs * n).astype(int)
    sizes[-1] += n - sizes.sum()
    return sizes


def _smooth2d(img: np.ndarray, it: int = 2) -> np.ndarray:
    for _ in range(it):
        img = (img + np.roll(img, 1, -1) + np.roll(img, -1, -1)
               + np.roll(img, 1, -2) + np.roll(img, -1, -2)) / 5.0
    return img


def _norm01(x: np.ndarray) -> np.ndarray:
    lo = x.min(axis=tuple(range(1, x.ndim)), keepdims=True)
    hi = x.max(axis=tuple(range(1, x.ndim)), keepdims=True)
    return (x - lo) / np.maximum(hi - lo, 1e-6)


def gen_mnist(spec: DatasetSpec, n: int, seed: int):
    """Digit-like strokes: per-class smooth prototype + elastic jitter."""
    rng = np.random.default_rng(seed)
    H, W = spec.raw_dim
    protos = _smooth2d(rng.normal(size=(spec.n_classes, H, W)), 3)
    protos = (protos > np.quantile(protos, 0.8, axis=(1, 2),
                                   keepdims=True)).astype(np.float32)
    protos = _smooth2d(protos, 1)
    xs, ys = [], []
    for c, sz in enumerate(_class_sizes(spec, n)):
        shift = rng.integers(-2, 3, size=(sz, 2))
        base = np.stack([np.roll(np.roll(protos[c], sx, 0), sy, 1)
                         for sx, sy in shift])
        noise = rng.normal(0, 0.15, size=base.shape)
        xs.append(np.clip(base + noise, 0, 1))
        ys.append(np.full(sz, c))
    return (np.concatenate(xs).astype(np.float32),
            np.concatenate(ys).astype(np.int32))


def gen_stl10(spec: DatasetSpec, n: int, seed: int):
    """Object-like textures: per-class frequency signature + phase noise."""
    rng = np.random.default_rng(seed)
    H, W = spec.raw_dim
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    xs, ys = [], []
    for c, sz in enumerate(_class_sizes(spec, n)):
        fx, fy = 0.3 + 0.25 * c, 0.2 + 0.15 * ((c * 3) % spec.n_classes)
        ph = rng.uniform(0, 2 * np.pi, size=(sz, 2, 1, 1))
        img = (np.sin(fx * xx + ph[:, 0]) * np.cos(fy * yy + ph[:, 1])
               + rng.normal(0, 0.4, size=(sz, H, W)))
        xs.append(_norm01(img))
        ys.append(np.full(sz, c))
    return (np.concatenate(xs).astype(np.float32),
            np.concatenate(ys).astype(np.int32))


def gen_har(spec: DatasetSpec, n: int, seed: int):
    """Accelerometer-feature-like: per-class band-limited sinusoid mixes."""
    rng = np.random.default_rng(seed)
    (D,) = spec.raw_dim
    t = np.linspace(0, 6 * np.pi, D, dtype=np.float32)
    xs, ys = [], []
    for c, sz in enumerate(_class_sizes(spec, n)):
        f = 1.0 + 0.7 * c
        amp = rng.uniform(0.5, 1.5, size=(sz, 1))
        phase = rng.uniform(0, 2 * np.pi, size=(sz, 1))
        sig = (amp * np.sin(f * t + phase)
               + 0.3 * np.sin(2.3 * f * t + 2 * phase)
               + rng.normal(0, 0.2, size=(sz, D)))
        xs.append(_norm01(sig))
        ys.append(np.full(sz, c))
    return (np.concatenate(xs).astype(np.float32),
            np.concatenate(ys).astype(np.int32))


def gen_reuters(spec: DatasetSpec, n: int, seed: int):
    """Zipfian bag-of-words: per-class topic distribution over 2000 terms."""
    rng = np.random.default_rng(seed)
    (V,) = spec.raw_dim
    zipf = 1.0 / np.arange(1, V + 1) ** 1.1
    xs, ys = [], []
    for c, sz in enumerate(_class_sizes(spec, n)):
        topic = np.roll(zipf, 137 * c) * rng.gamma(2.0, 1.0, size=V)
        topic = topic / topic.sum()
        counts = rng.multinomial(200, topic, size=sz).astype(np.float32)
        xs.append(np.log1p(counts))
        ys.append(np.full(sz, c))
    x = np.concatenate(xs).astype(np.float32)
    return _norm01(x), np.concatenate(ys).astype(np.int32)


def gen_nlos(spec: DatasetSpec, n: int, seed: int):
    """Non-line-of-sight-like: diffuse shadow projections of 3 scene types.
    Classes are *coarsely similar* (Fig. 3 caption) — same global blur,
    different occluder geometry."""
    rng = np.random.default_rng(seed)
    H, W = spec.raw_dim
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32) / H
    xs, ys = [], []
    for c, sz in enumerate(_class_sizes(spec, n)):
        cx = rng.uniform(0.3, 0.7, size=(sz, 1, 1))
        cy = rng.uniform(0.3, 0.7, size=(sz, 1, 1))
        if c == 0:  # vertical bar occluder
            occ = np.exp(-((xx - cx) ** 2) / 0.01)
        elif c == 1:  # disk occluder
            occ = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2)) / 0.02)
        else:  # corner wedge
            occ = ((xx > cx) & (yy > cy)).astype(np.float32)
        img = _smooth2d(1.0 - 0.8 * occ + rng.normal(0, 0.05,
                                                     size=(sz, H, W)), 3)
        xs.append(_norm01(img))
        ys.append(np.full(sz, c))
    return (np.concatenate(xs).astype(np.float32),
            np.concatenate(ys).astype(np.int32))


def gen_db(spec: DatasetSpec, n: int, seed: int):
    """Fundus-like: circular retina field + grade-dependent lesion density.
    Hardest fine-grained case (paper FA accuracy 41-44%)."""
    rng = np.random.default_rng(seed)
    H, W = spec.raw_dim
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    cx, cy = W / 2, H / 2
    rad = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    field = (rad < 0.45 * W).astype(np.float32)
    xs, ys = [], []
    for c, sz in enumerate(_class_sizes(spec, n)):
        n_lesions = 2 + 4 * c  # severity grade
        img = np.repeat(field[None] * 0.6, sz, axis=0)
        for _ in range(n_lesions):
            lx = rng.uniform(0.3 * W, 0.7 * W, size=(sz, 1, 1))
            ly = rng.uniform(0.3 * H, 0.7 * H, size=(sz, 1, 1))
            img += 0.35 * np.exp(-(((xx - lx) ** 2 + (yy - ly) ** 2)) / 3.0)
        img += rng.normal(0, 0.05, size=img.shape)
        xs.append(_norm01(_smooth2d(img, 1)))
        ys.append(np.full(sz, c))
    return (np.concatenate(xs).astype(np.float32),
            np.concatenate(ys).astype(np.int32))


_GENERATORS: Dict[str, Callable] = {
    "mnist": gen_mnist, "stl10": gen_stl10, "har": gen_har,
    "reuters": gen_reuters, "nlos": gen_nlos, "db": gen_db,
}


def generate(name: str, n: int | None = None, seed: int = 0):
    """Generate dataset ``name``; n=None uses the paper's sample count.

    The generator's seed adds ``hash(name)``, as the reference's does:
    Python salts string hashes per process (unless ``PYTHONHASHSEED`` is
    set), so two processes draw different samples for one ``seed``."""
    spec = SPECS[name]
    n = n if n is not None else spec.n_samples
    x, y = _GENERATORS[name](spec, n, seed + hash(name) % 10_000)
    perm = np.random.default_rng(seed).permutation(len(x))
    return x[perm], y[perm]
