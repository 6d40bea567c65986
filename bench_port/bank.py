"""The AE bank the router scores with: one autoencoder (784 -> 128 -> 784,
BatchNorm on the bottleneck, the paper's Sec. 4 model) a dataset, trained
by the benchmark itself in plain PyTorch, so that the system under test
and the reference are handed the same bank and neither made it.

The layout is the port's: params ``w_enc (784, 128)``, ``b_enc``,
``bn_scale``, ``bn_bias``, ``w_dec (128, 784)``, ``b_dec``; BatchNorm
state ``mean``, ``var`` (biased), ``count``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

BN_EPS = 1e-5
BN_MOMENTUM = 0.9


def _encode(p, s, x, train: bool):
    h = x @ p["w_enc"] + p["b_enc"]
    if train:
        mu, var = h.mean(0), h.var(0, correction=0)
    else:
        mu, var = s["mean"], s["var"]
    hn = (h - mu) * torch.rsqrt(var + BN_EPS) * p["bn_scale"] + p["bn_bias"]
    return torch.relu(hn), mu, var


def train_ae(x: np.ndarray, gen: torch.Generator, *, epochs: int,
             batch: int, lr: float, decay_every: int, order_seed: int
             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One AE on ``x`` (n, 784), the paper's recipe: Adam at ``lr``,
    divided by 10 every ``decay_every`` epochs, MSE reconstruction,
    batches from a numpy permutation per epoch (the last partial batch
    dropped). Returns (params, bn_state) on ``gen``'s device."""
    dev = gen.device
    d, h = x.shape[1], 128
    p = {
        "w_enc": torch.randn(d, h, generator=gen, device=dev) / np.sqrt(d),
        "b_enc": torch.zeros(h, device=dev),
        "bn_scale": torch.ones(h, device=dev),
        "bn_bias": torch.zeros(h, device=dev),
        "w_dec": torch.randn(h, d, generator=gen, device=dev) / np.sqrt(h),
        "b_dec": torch.zeros(d, device=dev),
    }
    s = {"mean": torch.zeros(h, device=dev), "var": torch.ones(h, device=dev),
         "count": torch.zeros((), device=dev)}
    for v in p.values():
        v.requires_grad_(True)
    opt = torch.optim.Adam(p.values(), lr=lr)
    xd = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
    rng = np.random.default_rng(order_seed)
    bsz = min(batch, len(x))
    for ep in range(epochs):
        for grp in opt.param_groups:
            grp["lr"] = lr * 0.1 ** (ep // decay_every)
        idx = torch.from_numpy(rng.permutation(len(x))).to(dev)
        for i in range(0, len(x) - bsz + 1, bsz):
            xb = xd[idx[i:i + bsz]]
            z, mu, var = _encode(p, s, xb, train=True)
            loss = ((z @ p["w_dec"] + p["b_dec"] - xb) ** 2).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            with torch.no_grad():
                s["mean"].mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mu)
                s["var"].mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
                s["count"].add_(1)
    return ({k: v.detach() for k, v in p.items()}, s)


def train_bank(datasets: Sequence[Tuple[str, np.ndarray]], seed: int, *,
               epochs: int, batch: int, lr: float, decay_every: int, device
               ) -> List[Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]]:
    """One AE a (name, x) dataset, each from its own stream of ``seed``."""
    out = []
    for i, (_, x) in enumerate(datasets):
        gen = torch.Generator(device=device).manual_seed(
            int(np.random.SeedSequence([seed, 7, i]).generate_state(1)[0]))
        out.append(train_ae(x, gen, epochs=epochs, batch=batch, lr=lr,
                            decay_every=decay_every,
                            order_seed=seed + 31 * i))
    return out
