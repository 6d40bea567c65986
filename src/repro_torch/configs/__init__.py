"""Architecture config registry: one module per assigned architecture.

``get_config(name)`` returns the exact full-size config; every config also
has ``.reduced()`` for CPU smoke tests. ``ALL_ARCHS`` lists the assigned
pool; the paper's own expert-matcher config lives in repro_torch.core.
The modules are the port's own copies of the reference configs (pure
data); every family builds in this package.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.common import ArchConfig

ALL_ARCHS: List[str] = [
    "rwkv6_7b",
    "zamba2_7b",
    "seamless_m4t_large_v2",
    "smollm_135m",
    "internvl2_26b",
    "qwen2_72b",
    "mixtral_8x22b",
    "olmoe_1b_7b",
    "qwen2_5_14b",
    "llama3_2_1b",
]

_ALIASES = {a.replace("_", "-"): a for a in ALL_ARCHS}
_ALIASES.update({
    "rwkv6-7b": "rwkv6_7b",
    "zamba2-7b": "zamba2_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "smollm-135m": "smollm_135m",
    "internvl2-26b": "internvl2_26b",
    "qwen2-72b": "qwen2_72b",
    "mixtral-8x22b": "mixtral_8x22b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen2.5-14b": "qwen2_5_14b",
    "llama3.2-1b": "llama3_2_1b",
})


def get_config(name: str) -> ArchConfig:
    mod_name = _ALIASES.get(name, name)
    mod = importlib.import_module(f".{mod_name}", __package__)
    return mod.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ALL_ARCHS}
