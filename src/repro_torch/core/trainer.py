"""Training loops for the matcher artifacts (paper Sec. 4 recipe):
Adam, lr 1e-2 decayed x0.1 every 15 epochs, 45 epochs, BatchNorm.

Each trainer inits from a seed and runs its loop (``fit_ae``,
``fit_mlp``) from the given (params, BN state, optimizer state), on the
device the params live on. The batches are the reference's: a numpy
``default_rng(seed)`` permutation per epoch, the last partial batch
dropped; each epoch's permutation goes to the device once, and a step
reads nothing back, so the host runs ahead of the card.
"""
from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..optim import adamw_init, adamw_update, step_decay
from ..tree import value_and_grad
from . import autoencoder as ae
from . import mlp_baseline as mlp


def _batches(n: int, batch_size: int, rng: np.random.Generator,
             device) -> Iterator[torch.Tensor]:
    idx = torch.from_numpy(rng.permutation(n)).to(device)
    for i in range(0, n - batch_size + 1, batch_size):
        yield idx[i:i + batch_size]


def _lr_fn(n: int, batch_size: int, base_lr: float, lr_decay_epochs: int):
    steps_per_epoch = max(1, n // batch_size)
    return step_decay(base_lr, every_steps=lr_decay_epochs * steps_per_epoch)


def train_ae(x: np.ndarray, *, generator=None, epochs: int = 45,
             batch_size: int = 256, base_lr: float = 1e-2,
             lr_decay_epochs: int = 15, seed: int = 0,
             in_dim: int = 784, hid_dim: int = 128, device=None):
    """Train one autoencoder on one dataset. Returns (params, bn_state)
    on ``device`` (``cuda`` unless ``device="cpu"``); the init draws from
    ``generator``, else from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    params, bn_state = ae.init_ae(generator, in_dim, hid_dim, device=dev)
    params, bn_state, _ = fit_ae(
        x, params, bn_state, adamw_init(params), epochs=epochs,
        batch_size=batch_size, base_lr=base_lr,
        lr_decay_epochs=lr_decay_epochs, seed=seed)
    return params, bn_state


def fit_ae(x: np.ndarray, params, bn_state, opt, *, epochs: int = 45,
           batch_size: int = 256, base_lr: float = 1e-2,
           lr_decay_epochs: int = 15, seed: int = 0):
    """``train_ae``'s loop from (params, bn_state, opt): returns the three
    after ``epochs`` epochs on ``x``."""
    dev = params["w_enc"].device
    xd = torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    lr_fn = _lr_fn(len(x), batch_size, base_lr, lr_decay_epochs)
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        for bidx in _batches(len(x), min(batch_size, len(x)), rng, dev):
            (_, bn_state), grads = value_and_grad(ae.loss_fn, params,
                                                  bn_state, xd[bidx])
            params, opt = adamw_update(grads, opt, params,
                                       lr_fn(opt["step"]))
    return params, bn_state, opt


def train_bank(datasets: Sequence[Tuple[str, np.ndarray]], **kw):
    """Train one AE per (name, x) dataset, the i-th from seed 1000 + i.
    Returns (aes, names)."""
    aes, names = [], []
    for i, (name, x) in enumerate(datasets):
        aes.append(train_ae(x, seed=1000 + i, **kw))
        names.append(name)
    return aes, names


def train_mlp(xs: np.ndarray, ys: np.ndarray, *, n_classes: int,
              epochs: int = 45, batch_size: int = 256,
              base_lr: float = 1e-2, lr_decay_epochs: int = 15,
              seed: int = 0, in_dim: int = 784, device=None):
    """Train the MLP-softmax dataset classifier baseline. Returns (params,
    bn_states) on ``device`` (``cuda`` unless ``device="cpu"``)."""
    dev = resolve_device(device)
    params, states = mlp.init_mlp(
        torch.Generator(device=dev).manual_seed(seed), in_dim, n_classes,
        device=dev)
    params, states, _ = fit_mlp(
        xs, ys, params, states, adamw_init(params), epochs=epochs,
        batch_size=batch_size, base_lr=base_lr,
        lr_decay_epochs=lr_decay_epochs, seed=seed)
    return params, states


def fit_mlp(xs: np.ndarray, ys: np.ndarray, params, states, opt, *,
            epochs: int = 45, batch_size: int = 256, base_lr: float = 1e-2,
            lr_decay_epochs: int = 15, seed: int = 0):
    """``train_mlp``'s loop from (params, states, opt): returns the three
    after ``epochs`` epochs on (xs, ys)."""
    dev = params["w_out"].device
    xd = torch.from_numpy(np.asarray(xs, np.float32)).to(dev)
    yd = torch.from_numpy(np.asarray(ys, np.int64)).to(dev)
    lr_fn = _lr_fn(len(xs), batch_size, base_lr, lr_decay_epochs)
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        for bidx in _batches(len(xs), min(batch_size, len(xs)), rng, dev):
            (_, states), grads = value_and_grad(mlp.loss_fn, params, states,
                                                xd[bidx], yd[bidx])
            params, opt = adamw_update(grads, opt, params,
                                       lr_fn(opt["step"]))
    return params, states, opt
