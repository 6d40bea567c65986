"""LM training substrate, the reference's ``repro.train.loop``.

``make_train_step(model, ...)`` builds the step

    state, metrics = train_step(state, batch)

with state = {params, opt, step}: gradient microbatching (the gradients
of each microbatch summed into f32 zeros, then divided by their count)
and global-norm clipping included. It runs eagerly on the device the
params live on; nothing in a step reads back to the host.

Sharded training (the reference's ``jit`` with ``in_shardings`` /
``out_shardings`` over a ``data`` x ``model`` mesh): lay the state and
the batch out as DTensors with ``shard_train_state`` and
``shard_batch``, then call the same step under ``mesh_context(mesh)``,
which the models' ``shard_act`` constraints and the MoE's token groups
read. A step on a DTensor state runs under DTensor's implicit
replication, so the plain tensors the models make (positions, rope
tables, masks) meet the params as replicated values, and puts every leaf
of the new state back in its input placements, as ``out_shardings`` pins
them. Its loss is a replicated DTensor: read it with ``full_tensor()``.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..device import resolve_device
from ..models.api import BaseModel
from ..optim import adamw_init, adamw_update, cosine_warmup
from ..sharding.context import Spec
from ..sharding.rules import batch_spec, distribute, param_specs
from ..tree import leaves, tree_map, value_and_grad


def make_train_step(model: BaseModel, *, lr_fn=None,
                    weight_decay: float = 0.0,
                    clip_norm: Optional[float] = 1.0,
                    microbatches: Optional[int] = None):
    lr_fn = lr_fn or cosine_warmup(3e-4, warmup_steps=100, total_steps=10_000)
    mb = microbatches or model.cfg.train_microbatches or 1

    def train_step(state, batch):
        if not isinstance(state["step"], DTensor):
            return _step(state, batch)
        with implicit_replication():
            new_state, metrics = _step(state, batch)
        return tree_map(lambda new, old: new.redistribute(
            old.device_mesh, old.placements), new_state, state), metrics

    def _step(state, batch):
        params, opt = state["params"], state["opt"]
        bdim = leaves(batch)[0].shape[0]
        if mb > 1 and bdim % mb == 0:
            gsum = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            lsum = torch.zeros_like(state["step"], dtype=torch.float32)
            for i in range(mb):
                # rows i*n .. (i+1)*n, the reference's reshape(mb, n)[i]; a
                # slice, which DTensor takes whether or not mb divides the
                # data axis (the reshape it refuses then)
                n = bdim // mb
                mbatch = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
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


def shard_train_state(state: Dict, mesh, *, fsdp: bool = False) -> Dict:
    """``state`` as DTensors over ``mesh``: params and both moments laid
    out by ``param_specs`` (``fsdp`` as there), both ``step`` counters
    replicated. Every rank passes the same state."""
    ps = param_specs(state["params"], mesh, fsdp=fsdp)
    specs = {"params": ps, "opt": {"m": ps, "v": ps, "step": Spec()},
             "step": Spec()}
    return distribute(state, specs, mesh)


def shard_batch(batch: Dict, mesh) -> Dict:
    """``batch`` as DTensors over ``mesh``, laid out by ``batch_spec``
    (rows over ``pod`` x ``data``)."""
    return distribute(batch, batch_spec(batch, mesh), mesh)


def init_train_state(model: BaseModel, generator, device=None) -> Dict:
    """{params, opt, step} from ``generator`` (a ``torch.Generator`` on
    the target device, or an int seed for one); ``cuda`` unless
    ``device="cpu"``."""
    params = model.init(generator, device=device)
    return {"params": params, "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves(params)[0].device)}


def train_state_shapes(model: BaseModel) -> Dict:
    """The {params, opt, step} tree of ``init_train_state`` on the ``meta``
    device: shapes and dtypes, no storage, nothing drawn."""
    params = model.param_shapes()
    return {"params": params, "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


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
