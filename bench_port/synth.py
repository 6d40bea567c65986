"""Client fingerprints for the benchmark's traffic and the AE bank it
trains: the six synthetic stand-ins for the paper's datasets (Table 1),
as numpy draws, and the paper's preprocessing to 784 features.

A frozen copy of the port's ``repro_torch.data.synthetic`` generators and
``repro_torch.data.preprocess``, so that what the benchmark feeds the
system cannot change under it. One departure: ``draw`` seeds each
dataset from the caller's seed alone. The port's ``generate`` adds
``hash(name)``, which Python salts per process, so two runs of one seed
would draw other fingerprints.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

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


def draw(name: str, n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` samples of dataset ``name`` as (x (n, 784) float32, y (n,)
    int32), shuffled; the same ``seed`` gives the same samples. Small
    draws come from a set of at least 8 a class, so every class can
    appear."""
    spec = SPECS[name]
    x, y = _GENERATORS[name](spec, max(n, 8 * spec.n_classes), seed)
    perm = np.random.default_rng(seed).permutation(len(x))[:n]
    return to_784(x[perm]), y[perm]


def resize_image(x: np.ndarray, out_hw=(28, 28)) -> np.ndarray:
    """Bilinear-ish resize via area averaging. x: (N, H, W)."""
    N, H, W = x.shape
    oh, ow = out_hw
    if (H, W) == (oh, ow):
        return x
    ys = np.linspace(0, H - 1, oh)
    xs = np.linspace(0, W - 1, ow)
    yi = np.clip(ys.astype(int), 0, H - 2)
    xi = np.clip(xs.astype(int), 0, W - 2)
    fy = (ys - yi)[None, :, None]
    fx = (xs - xi)[None, None, :]
    a = x[:, yi][:, :, xi]
    b = x[:, yi + 1][:, :, xi]
    c = x[:, yi][:, :, xi + 1]
    d = x[:, yi + 1][:, :, xi + 1]
    return ((1 - fy) * (1 - fx) * a + fy * (1 - fx) * b
            + (1 - fy) * fx * c + fy * fx * d)


def adaptive_avg_pool_1d(x: np.ndarray, out_dim: int = 784) -> np.ndarray:
    """Torch-style AdaptiveAvgPool1d. x: (N, D) -> (N, out_dim)."""
    N, D = x.shape
    if D == out_dim:
        return x
    if D < out_dim:  # upsample by linear interpolation
        pos = np.linspace(0, D - 1, out_dim)
        lo = np.clip(pos.astype(int), 0, D - 2)
        f = pos - lo
        return (1 - f) * x[:, lo] + f * x[:, lo + 1]
    starts = (np.arange(out_dim) * D) // out_dim
    ends = ((np.arange(out_dim) + 1) * D + out_dim - 1) // out_dim
    out = np.empty((N, out_dim), x.dtype)
    for j in range(out_dim):
        out[:, j] = x[:, starts[j]:ends[j]].mean(axis=1)
    return out


def to_784(x: np.ndarray) -> np.ndarray:
    """Any raw modality -> (N, 784) float32 (the matcher's input space)."""
    if x.ndim == 3:  # image (N, H, W)
        return resize_image(x).reshape(len(x), -1).astype(np.float32)
    if x.ndim == 2:
        return adaptive_avg_pool_1d(x).astype(np.float32)
    raise ValueError(f"unsupported raw shape {x.shape}")
