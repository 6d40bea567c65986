"""The 1-D ``expert`` mesh that banked serving places experts on.

The reference's ``launch/mesh.py`` builds JAX meshes; its ``expert``
mesh spans every visible device, and ``serve.placement`` shards each
bank's stacked params, caches and token planes along it. Here a mesh is
a plain tuple of devices: a bank's members are independent experts and
no collective crosses the axis, so one process drives every position,
each with its own tensors and its own captured steps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


def _as_device(d) -> torch.device:
    """A device, a device string, or a CUDA ordinal (as ``torch.device``
    reads an int)."""
    if isinstance(d, (int, np.integer)):
        return torch.device("cuda", int(d))
    return torch.device(d)


@dataclasses.dataclass(frozen=True)
class ExpertMesh:
    """A 1-D mesh over an ``expert`` axis: position ``i`` is
    ``devices[i]``. It carries the two attributes the reference's
    placement reads: ``shape`` (``{"expert": n}``) and ``devices``.

    Positions may repeat one device: ``ExpertMesh(("cpu",) * 4)`` or
    ``ExpertMesh((torch.device("cuda", 0),) * 3)`` is the port's
    counterpart of the reference's forced host device count
    (``--xla_force_host_platform_device_count``), and runs the sharded
    code path, one set of tensors and captured steps per position, on
    one device.
    """
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        devs = tuple(_as_device(d) for d in self.devices)
        if not devs:
            raise ValueError("an ExpertMesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"an ExpertMesh spans one device type, got "
                             f"{[str(d) for d in devs]}")
        object.__setattr__(self, "devices", devs)

    @property
    def shape(self) -> Dict[str, int]:
        return {"expert": len(self.devices)}


def make_expert_mesh(device: DeviceLike = None) -> ExpertMesh:
    """1-D mesh over an ``expert`` axis spanning every visible CUDA
    device (``launch/mesh.py``'s ``make_expert_mesh``). Raises without a
    card unless ``device="cpu"``, which gives one CPU position; an
    explicit ``ExpertMesh`` repeats a device instead."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return ExpertMesh((dev,))
    return ExpertMesh(tuple(torch.device("cuda", i)
                            for i in range(torch.cuda.device_count())))
