"""Device resolution for the port's entry points.

Every entry point (``RoutedServer``, ``ExpertEngine``, ``build_matcher``,
a model's ``init``) runs on ``cuda`` unless the caller passes
``device="cpu"``. There is no silent fallback: asking for CUDA on a
machine without a card raises.
"""
from __future__ import annotations

import contextlib
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; raise if CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    # TF32 keeps about three decimal digits; the port's float32 paths are
    # held to rtol 2e-5 against the reference, so both switches are set
    # off explicitly wherever device state is built
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device for the block (nothing on the
    CPU): a ctypes launch and a graph capture run on the current one."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()
