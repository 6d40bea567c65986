"""Meshes: the ``data`` x ``model`` (x ``pod``) meshes of training and
the 1-D ``expert`` mesh that banked serving places experts on.

The reference's ``launch/mesh.py`` builds JAX meshes. Its production
meshes (16 x 16 over ``data``, ``model``; 2 x 16 x 16 with ``pod``) and
its 1 x 1 host mesh become ``torch.distributed`` ``DeviceMesh``es with
the same dim names, over which ``sharding.rules`` lays params out as
DTensors. A ``DeviceMesh`` spans the ranks of a process group: the
caller starts the group (``torch.distributed.init_process_group`` with
its own address, world size and rank), except for the host mesh, which
starts a one-rank group itself.

The ``expert`` mesh spans every visible device, and ``serve.placement``
shards each bank's stacked params, caches and token planes along it.
There a mesh is a plain tuple of devices: a bank's members are
independent experts and no collective crosses the axis, so one process
drives every position, each with its own tensors and its own captured
steps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import DeviceLike, resolve_device


#: Per-card constants of the roofline (``launch/dryrun.py``): NVIDIA H100
#: 80GB HBM3 (SXM), 700 W power limit.
HW = {
    # dense bf16 tensor-core peak, FLOP/s (H100 SXM datasheet; the bound
    # PERF.md's kernel table uses); NVIDIA H100 80GB HBM3, 700 W
    "peak_flops_bf16": 989e12,
    # HBM3 bandwidth, B/s (H100 SXM datasheet); NVIDIA H100 80GB HBM3, 700 W
    "hbm_bw": 3.35e12,
    # one card's inter-node link, B/s: the production `model` axis of 16
    # spans two 8-card NVLink nodes, so its collectives cross the slower
    # link: a 400 Gb/s ConnectX-7 NDR InfiniBand port a card (DGX H100
    # datasheet: eight such ports a node of eight cards) = 50 GB/s a
    # direction; NVIDIA H100 80GB HBM3, 700 W
    "link_bw": 50e9,
    # device memory, bytes: torch.cuda.get_device_properties(0)
    # .total_memory of an NVIDIA H100 80GB HBM3, 700 W, torch
    # 2.11.0+cu128 (read on the card; chip_smoke.py's dryrun phase
    # prints it beside this figure)
    "hbm_bytes": 85_017_493_504,
}


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


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: DeviceLike = None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with dim names ``axes`` over the
    ranks of the default process group (``compat_make_mesh``): on
    ``cuda``, or on the CPU when ``device="cpu"``."""
    dev = resolve_device(device)
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def mesh_devices_required(multi_pod: bool) -> int:
    return 512 if multi_pod else 256


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> DeviceMesh:
    """(data 16, model 16), or (pod 2, data 16, model 16) with
    ``multi_pod``: the reference's production meshes, over a process
    group of ``mesh_devices_required(multi_pod)`` ranks."""
    need = mesh_devices_required(multi_pod)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise ValueError(
            f"the {'multi-pod' if multi_pod else 'single-pod'} production "
            f"mesh needs a process group of mesh_devices_required("
            f"{multi_pod}) = {need} ranks, found {have}")
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(device: DeviceLike = None) -> DeviceMesh:
    """1 x 1 ``data`` x ``model`` mesh (everything replicated), on
    ``cuda`` unless ``device="cpu"``. Without a process group it starts
    a one-rank group on an in-process store (gloo on the CPU, NCCL on
    the card); ``torch.distributed.destroy_process_group()`` ends it."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    return make_mesh((1, 1), ("data", "model"), dev)
