"""Weight bridge: reference parameter pytrees (as numpy) <-> port tensors.

The reference package's parameters come out of ``jax.device_get`` as
nested dicts of numpy arrays with the layouts the port keeps: every
model family's params under the reference's names (``DecoderLM``'s
``embed``, ``layers/*`` stacked on a leading ``L`` axis, ``ln_f``; RWKV6's
and Zamba2's; ``EncDecLM``'s ``enc_layers/*`` and ``dec_layers/*``, each
stacked on its own ``L``, ``ln_enc``, ``ln_f``, ``unembed``), the AE bank's ``(bank_params, bank_states)`` stacked on a
leading ``K`` axis, and the matcher's ``centroids`` / ``centroid_mask``.
``to_torch`` maps any such tree onto tensors on a device; ``to_numpy``
maps back; ``copy_to_torch`` copies such a tree into tensors that already
exist, in place — a speculative draft's engine state
(``EngineCore.draft_state``, which a captured verify graph reads at fixed
addresses) takes the reference engine's state this way.

bfloat16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` rejects; they cross as a bit-identical ``uint16``
view (the same trick the reference's npz checkpoints use), so a round
trip gives back the same bits.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .device import resolve_device


def _leaf_to_torch(a, device: torch.device) -> torch.Tensor:
    # a writable host copy: device_get hands out read-only buffers
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def to_torch(tree: Any, device=None) -> Any:
    """Nested dicts/lists of numpy arrays -> the same structure of tensors
    on ``device`` (``cuda`` unless ``device="cpu"``)."""
    dev = resolve_device(device)

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        return _leaf_to_torch(node, dev)

    return rec(tree)


def to_numpy(tree: Any) -> Any:
    """Tensors -> numpy on the host. bfloat16 tensors come back as their
    bit-identical ``uint16`` view (numpy has no bfloat16 of its own)."""
    def rec(node):
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        t = node.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    return rec(tree)


def copy_to_torch(dst: Any, src: Any) -> None:
    """Copy the numpy tree ``src`` into the tensor tree ``dst`` of the
    same structure, leaf by leaf and in place (each leaf keeps its
    storage, device and dtype). Raises if a key, a length or a shape
    differs. A reference draft's state comes across this way:
    ``copy_to_torch(core.draft_state, jax.device_get(jax_core.draft_state))``
    (``jax.random`` draws cannot be reproduced by a torch generator)."""
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"keys differ: {sorted(dst)} vs {sorted(src)}")
        for k in dst:
            copy_to_torch(dst[k], src[k])
        return
    if isinstance(dst, (list, tuple)):
        if len(dst) != len(src):
            raise ValueError(f"lengths differ: {len(dst)} vs {len(src)}")
        for d, s in zip(dst, src):
            copy_to_torch(d, s)
        return
    t = _leaf_to_torch(src, torch.device("cpu"))
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"shapes differ: {tuple(dst.shape)} vs "
                         f"{tuple(t.shape)}")
    dst.copy_(t)
