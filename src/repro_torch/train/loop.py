"""LM training substrate, the reference's ``repro.train.loop``.

``make_train_step(model, ...)`` builds the step

    state, metrics = train_step(state, batch)

with state = {params, opt, step}: gradient microbatching (the gradients
of each microbatch summed into f32 zeros, then divided by their count)
and global-norm clipping included. It runs eagerly on the device the
params live on; nothing in a step reads back to the host.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.api import BaseModel
from ..optim import adamw_init, adamw_update, cosine_warmup
from ..tree import leaves, tree_map, value_and_grad


def make_train_step(model: BaseModel, *, lr_fn=None,
                    weight_decay: float = 0.0,
                    clip_norm: Optional[float] = 1.0,
                    microbatches: Optional[int] = None):
    lr_fn = lr_fn or cosine_warmup(3e-4, warmup_steps=100, total_steps=10_000)
    mb = microbatches or model.cfg.train_microbatches or 1

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        bdim = leaves(batch)[0].shape[0]
        if mb > 1 and bdim % mb == 0:
            gsum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
            for i in range(mb):
                mbatch = {k: v.reshape((mb, bdim // mb) + v.shape[1:])[i]
                          for k, v in batch.items()}
                (loss, _), grads = value_and_grad(model.loss, params, mbatch)
                tree_map(lambda s, g: s.add_(g), gsum, grads)
                lsum = lsum + loss
            grads = tree_map(lambda g: g / mb, gsum)
            loss = lsum / mb
        else:
            (loss, _), grads = value_and_grad(model.loss, params, batch)
        lr = lr_fn(opt["step"])
        new_params, new_opt = adamw_update(
            grads, opt, params, lr, weight_decay=weight_decay,
            clip_norm=clip_norm)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, "lr": lr}

    return train_step


def init_train_state(model: BaseModel, generator, device=None) -> Dict:
    """{params, opt, step} from ``generator`` (a ``torch.Generator`` on
    the target device, or an int seed for one); ``cuda`` unless
    ``device="cpu"``."""
    params = model.init(generator, device=device)
    return {"params": params, "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves(params)[0].device)}


class Trainer:
    """Single-host convenience trainer (launcher / integration tests):
    ``cosine_warmup`` over ``total_steps`` with ``min(100, total_steps //
    10)`` warm-up steps; ``cuda`` unless ``device="cpu"``."""

    def __init__(self, model: BaseModel, *, lr: float = 3e-4,
                 total_steps: int = 1000, seed: int = 0, device=None,
                 **step_kw):
        self.model = model
        self.device = resolve_device(device)
        lr_fn = cosine_warmup(lr, warmup_steps=min(100, total_steps // 10),
                              total_steps=total_steps)
        self.state = init_train_state(
            model, torch.Generator(device=self.device).manual_seed(seed),
            device=self.device)
        self._step = make_train_step(model, lr_fn=lr_fn, **step_kw)
        self.history = []

    def fit(self, stream: Iterator[Dict[str, np.ndarray]], steps: int,
            log_every: int = 50, callback: Optional[Callable] = None):
        """Run ``steps`` steps on batches from ``stream``; the loss is read
        back (one host sync) every ``log_every`` steps and at the last,
        into ``history`` as (step, loss)."""
        for i in range(steps):
            batch = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                     for k, v in next(stream).items()}
            self.state, metrics = self._step(self.state, batch)
            if i % log_every == 0 or i == steps - 1:
                self.history.append((i, float(metrics["loss"])))
                if callback:
                    callback(i, metrics)
        return self.history
