"""Mesh context, activation constraints and parameter specs: the
``data`` x ``model`` layout of training (DTensors over a ``DeviceMesh``)
and the leading-axis placement of banked serving."""
from .context import (axis_size, current_mesh, leading_sharding,
                      mesh_context, shard_act)
from .rules import batch_spec, divisible, param_specs

__all__ = [
    "axis_size",
    "current_mesh",
    "leading_sharding",
    "mesh_context",
    "shard_act",
    "param_specs",
    "batch_spec",
    "divisible",
]
