"""The paper's autoencoder: 784 -> 128 -> 784 single-layer MLP enc/dec
with BatchNorm, trained with MSE reconstruction loss (Sec. 4). A *bank*
of K such AEs (one per expert dataset) is stored with params stacked on
a leading K axis, as in the reference.

``encode``, ``decode``, ``recon_mse`` and the bank functions are eval
mode (BatchNorm from the running statistics) and take one AE or a bank;
``forward(..., train=True)`` and ``loss_fn`` are the training side, on
one AE: BatchNorm from the batch's statistics, returning the updated
running statistics.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from ..device import resolve_device
from ..models.common import dense_init

IN_DIM = 784
HID_DIM = 128
BN_EPS = 1e-5

Params = Dict[str, torch.Tensor]


def init_ae(generator, in_dim: int = IN_DIM, hid_dim: int = HID_DIM,
            device=None) -> Tuple[Params, Params]:
    """(params, bn_state) from ``generator`` (a ``torch.Generator`` on the
    target device, or an int seed for one); ``cuda`` unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    f32 = torch.float32
    params = {
        "w_enc": dense_init(generator, (in_dim, hid_dim), f32),
        "b_enc": torch.zeros((hid_dim,), dtype=f32, device=dev),
        "bn_scale": torch.ones((hid_dim,), dtype=f32, device=dev),
        "bn_bias": torch.zeros((hid_dim,), dtype=f32, device=dev),
        "w_dec": dense_init(generator, (hid_dim, in_dim), f32),
        "b_dec": torch.zeros((in_dim,), dtype=f32, device=dev),
    }
    bn_state = {"mean": torch.zeros((hid_dim,), dtype=f32, device=dev),
                "var": torch.ones((hid_dim,), dtype=f32, device=dev),
                "count": torch.zeros((), dtype=f32, device=dev)}
    return params, bn_state


def batch_norm(h, params, state, train: bool = False,
               momentum: float = 0.9):
    """BatchNorm over the rows of ``h`` with ``params`` {bn_scale,
    bn_bias} and running statistics ``state`` {mean, var[, count]}.
    Returns (out, new_state). Eval mode normalises by the running
    statistics and returns ``state``; train mode by the batch's mean and
    biased variance (``jnp.var``'s), and returns the running statistics
    moved by ``1 - momentum`` towards them (``count`` + 1 where ``state``
    keeps one), outside the autograd graph."""
    if train:
        mu = h.mean(dim=0)
        var = h.var(dim=0, correction=0)
        new_state = {
            "mean": momentum * state["mean"] + (1 - momentum) * mu.detach(),
            "var": momentum * state["var"] + (1 - momentum) * var.detach(),
        }
        if "count" in state:
            new_state["count"] = state["count"] + 1
    else:
        mu, var = state["mean"], state["var"]
        new_state = state
    hn = (h - mu) * torch.rsqrt(var + BN_EPS)
    return hn * params["bn_scale"] + params["bn_bias"], new_state


def encode(params, state, x):
    """x: (B, in_dim) -> bottleneck (B, hid). Params may carry a leading
    bank axis K (then x broadcasts and the result is (K, B, hid))."""
    if params["w_enc"].dim() == 3:
        h = torch.einsum("bd,kdh->kbh", x, params["w_enc"]) \
            + params["b_enc"][:, None, :]
        st = {k: v[:, None, :] for k, v in state.items() if v.dim() == 2}
        pr = {k: params[k][:, None, :] for k in ("bn_scale", "bn_bias")}
        return torch.relu(batch_norm(h, pr, st)[0])
    h = x @ params["w_enc"] + params["b_enc"]
    return torch.relu(batch_norm(h, params, state)[0])


def decode(params, z):
    if params["w_dec"].dim() == 3:
        return torch.einsum("kbh,khd->kbd", z, params["w_dec"]) \
            + params["b_dec"][:, None, :]
    return z @ params["w_dec"] + params["b_dec"]


def recon_mse(params, state, x):
    """Per-sample reconstruction MSE: (B,), or (K, B) for a bank."""
    xhat = decode(params, encode(params, state, x))
    return (xhat - x).square().mean(dim=-1)


def forward(params, state, x, train: bool = False):
    """One AE: x (B, in_dim) -> (xhat, bottleneck z, new_bn_state)."""
    h = x @ params["w_enc"] + params["b_enc"]
    h, new_state = batch_norm(h, params, state, train)
    z = torch.relu(h)
    return decode(params, z), z, new_state


def loss_fn(params, state, x):
    """Scalar training loss (mean MSE over the batch) in train mode:
    (loss, new_bn_state)."""
    xhat, _, new_state = forward(params, state, x, train=True)
    return (xhat - x).square().mean(dim=-1).mean(), new_state


# ---------------------------------------------------------------------------
# AE bank: stacked params over K experts
# ---------------------------------------------------------------------------


def stack_bank(aes: Sequence[Tuple[Params, Params]]
               ) -> Tuple[Params, Params]:
    """List of (params, bn_state) -> (stacked_params, stacked_state)."""
    params = {k: torch.stack([a[0][k] for a in aes]) for k in aes[0][0]}
    states = {k: torch.stack([a[1][k] for a in aes]) for k in aes[0][1]}
    return params, states


def bank_scores(bank_params, bank_states, x) -> torch.Tensor:
    """Reconstruction MSE of every sample under every AE: (B, K)."""
    return recon_mse(bank_params, bank_states, x).T


def bank_encode(bank_params, bank_states, x) -> torch.Tensor:
    """Bottleneck features under every AE: (K, B, hid)."""
    return encode(bank_params, bank_states, x)
