"""Paper Sec. 4 preprocessing: images resized to 28x28 and flattened to 784;
1-D modalities (HAR, Reuters) adaptive-avg-pooled to 784."""
from __future__ import annotations

import numpy as np


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
