"""The paper's baseline: MLP softmax dataset classifier
(784 -> 256 -> 128 -> C) with BatchNorm (Table 2, "MLP-Softmax")."""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..models.common import dense_init, softmax_xent
from .autoencoder import batch_norm


def init_mlp(generator, in_dim: int = 784, n_classes: int = 4,
             device=None):
    """(params, bn_states) from ``generator`` (a ``torch.Generator`` on
    the target device, or an int seed for one); ``cuda`` unless
    ``device="cpu"``. Draws in the reference's order: ``w_out``, then
    each layer's ``w``."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    f32 = torch.float32
    dims = [in_dim, 256, 128]
    params = {"layers": [],
              "w_out": dense_init(generator, (128, n_classes), f32),
              "b_out": torch.zeros((n_classes,), dtype=f32, device=dev)}
    states = []
    for i in range(len(dims) - 1):
        n = dims[i + 1]
        params["layers"].append({
            "w": dense_init(generator, (dims[i], n), f32),
            "b": torch.zeros((n,), dtype=f32, device=dev),
            "bn_scale": torch.ones((n,), dtype=f32, device=dev),
            "bn_bias": torch.zeros((n,), dtype=f32, device=dev),
        })
        states.append({"mean": torch.zeros((n,), dtype=f32, device=dev),
                       "var": torch.ones((n,), dtype=f32, device=dev)})
    return params, states


def forward(params, states, x, train: bool = False, momentum: float = 0.9):
    """x (B, in_dim) -> (logits (B, C), new_states)."""
    new_states = []
    h = x
    for lp, st in zip(params["layers"], states):
        h, new_st = batch_norm(h @ lp["w"] + lp["b"], lp, st, train,
                               momentum)
        new_states.append(new_st)
        h = torch.relu(h)
    logits = h @ params["w_out"] + params["b_out"]
    return logits, new_states


def loss_fn(params, states, x, y):
    logits, new_states = forward(params, states, x, train=True)
    return softmax_xent(logits, y), new_states


def predict(params, states, x):
    logits, _ = forward(params, states, x, train=False)
    return torch.argmax(logits, dim=-1)
