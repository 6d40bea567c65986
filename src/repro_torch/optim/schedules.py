"""Learning-rate schedules as ``step -> lr`` callables, the reference's
``repro.optim.schedules``: ``step`` is the optimizer's int32 step tensor
(read before the update increments it) and the rate a 0-d float32
tensor on its device, computed in f32 as the reference computes it."""
from __future__ import annotations

import math

import torch


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def constant_lr(lr: float):
    return lambda step: _f32(lr, step)


def step_decay(base_lr: float, *, decay: float = 0.1, every_steps: int):
    """The paper's AE/MLP recipe: lr /= 10 every 15 epochs."""
    def fn(step):
        n = torch.div(step, every_steps, rounding_mode="floor").float()
        return _f32(base_lr, step) * _f32(decay, step) ** n
    return fn


def cosine_warmup(base_lr: float, *, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    def fn(step):
        step = step.float()
        warm = step / max(warmup_steps, 1)
        prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        prog = torch.clamp(prog, 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return _f32(base_lr, step) * torch.where(step < warmup_steps, warm,
                                                 cos)
    return fn
