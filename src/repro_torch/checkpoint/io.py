"""Minimal sharded checkpointing: a tree of tensors -> npz shards + a json
index, and the expert store built on it.

Leaves are flattened by tree path (dict keys sorted, list items by
index) into npz shards of at most ``shard_bytes``; ``index.json`` records
each leaf's shard, key, shape and dtype string. npz cannot hold
bfloat16 (or float8), so such a leaf is stored as its bit-identical
unsigned view under its own dtype string and viewed back on load. The
format is the reference package's, so a store written by either package
reads in the other.

On top sits the **expert store**, the cold tier of the expert hub
(``serve/hub.py``): one directory per expert under a store root, each
holding its params checkpoint and a ``meta.json``. The hub stages
experts from here into host memory and installs them into device slots
on demand, so the catalog can outgrow device memory.

Leaves written may be tensors on any device or numpy arrays; leaves read
are CPU tensors. Reading makes no CUDA call.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

PyTree = Any

# dtype string -> (the unsigned view npz stores, the torch dtype)
_VIEW = {"bfloat16": (np.uint16, torch.bfloat16),
         "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
         "float8_e5m2": (np.uint8, torch.float8_e5m2)}
# a view's signed twin on both sides (torch.from_numpy takes no uint16)
_SIGNED = {np.uint16: (np.int16, torch.int16), np.uint8: (np.int8, torch.int8)}
_TORCH_NAME = {torch.bfloat16: "bfloat16",
               torch.float8_e4m3fn: "float8_e4m3fn",
               torch.float8_e5m2: "float8_e5m2"}


def _stored(leaf) -> Tuple[np.ndarray, str]:
    """(array npz can hold, dtype string) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = _TORCH_NAME.get(t.dtype)
        if name is None:
            a = t.numpy()
            return a, str(a.dtype)
        view = _VIEW[name][0]
        return t.view(_SIGNED[view][1]).numpy().view(view), name
    a = np.asarray(leaf)
    name = a.dtype.name
    if name in _VIEW:                   # e.g. an ml_dtypes bfloat16 array
        return a.view(_VIEW[name][0]), name
    return a, str(a.dtype)


def _paths(tree) -> Dict[str, Any]:
    flat = {}

    def rec(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(node[k], f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, f"{prefix}/{i}")
        else:
            flat[prefix] = node

    rec(tree, "")
    return flat


def save_pytree(tree: PyTree, directory: str,
                shard_bytes: int = 512 << 20) -> None:
    os.makedirs(directory, exist_ok=True)
    index, shard, size, sid = {}, {}, 0, 0

    def flush():
        nonlocal shard, size, sid
        if shard:
            np.savez(os.path.join(directory, f"shard{sid}.npz"), **shard)
            sid += 1
            shard, size = {}, 0

    for key, leaf in _paths(tree).items():
        arr, dtype = _stored(leaf)
        if size + arr.nbytes > shard_bytes and shard:
            flush()
        safe = key.replace("/", "__")
        shard[safe] = arr
        index[key] = {"shard": sid, "key": safe,
                      "shape": list(arr.shape), "dtype": dtype}
        size += arr.nbytes
    flush()
    with open(os.path.join(directory, "index.json"), "w") as f:
        json.dump(index, f)


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if not arr.flags.writeable:      # npz members come back read-only
        arr = arr.copy()
    if dtype in _VIEW:
        view, tdt = _VIEW[dtype]
        return torch.from_numpy(arr.view(_SIGNED[view][0])).view(tdt)
    return torch.from_numpy(arr)


def load_pytree(directory: str, like: PyTree = None) -> PyTree:
    """Load as CPU tensors; if ``like`` is given, its tree structure must
    match the checkpoint's."""
    with open(os.path.join(directory, "index.json")) as f:
        index = json.load(f)
    shards = {}
    flat = {}
    for key, meta in index.items():
        sid = meta["shard"]
        if sid not in shards:
            shards[sid] = np.load(
                os.path.join(directory, f"shard{sid}.npz"))
        flat[key] = _tensor(shards[sid][meta["key"]], meta["dtype"])
    if like is None:
        return _unflatten(flat)
    ref = _paths(like)
    if set(ref) != set(flat):
        raise ValueError("checkpoint/pytree structure mismatch")
    return _unflatten({k: flat[k] for k in ref})


# ---------------------------------------------------------------------------
# Expert store: <root>/<name>/{index.json, shard*.npz, meta.json}
# ---------------------------------------------------------------------------


_NAME_OK = re.compile(r"[A-Za-z0-9][A-Za-z0-9._\-@+]*\Z")


def _expert_dir(root: str, name: str) -> str:
    # expert names become directory names; munging a bad name would let
    # two distinct experts collide onto one directory (one overwriting
    # the other's weights), so refuse it instead
    if not _NAME_OK.match(name):
        raise ValueError(
            f"expert name {name!r} is not a safe store directory name "
            "(want [A-Za-z0-9][A-Za-z0-9._-@+]*)")
    return os.path.join(root, name)


def save_expert(root: str, name: str, params: PyTree,
                meta: Optional[Dict[str, Any]] = None,
                shard_bytes: int = 512 << 20) -> str:
    """Write one expert's params (and json-able ``meta``) under the store
    root; returns the expert's directory."""
    d = _expert_dir(root, name)
    save_pytree(params, d, shard_bytes=shard_bytes)
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump({"name": name, **(meta or {})}, f)
    return d


def load_expert(root: str, name: str, like: PyTree = None) -> PyTree:
    """Stage one expert's params from the store into host memory."""
    return load_pytree(_expert_dir(root, name), like=like)


def load_expert_meta(root: str, name: str) -> Dict[str, Any]:
    with open(os.path.join(_expert_dir(root, name), "meta.json")) as f:
        return json.load(f)


def list_experts(root: str) -> List[str]:
    """Expert names present in the store, sorted."""
    if not os.path.isdir(root):
        return []
    out = []
    for entry in sorted(os.listdir(root)):
        if os.path.isfile(os.path.join(root, entry, "meta.json")):
            with open(os.path.join(root, entry, "meta.json")) as f:
                out.append(json.load(f)["name"])
    return out


def expert_nbytes(root: str, name: str) -> int:
    """On-disk checkpoint size of one expert."""
    d = _expert_dir(root, name)
    return sum(os.path.getsize(os.path.join(d, f))
               for f in os.listdir(d) if f.endswith(".npz"))


def _unflatten(flat: Dict[str, Any]) -> PyTree:
    root: Dict = {}
    for key, arr in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def fix(node):
        if isinstance(node, dict):
            keys = list(node)
            if keys and all(k.isdigit() for k in keys):
                return [fix(node[str(i)]) for i in range(len(keys))]
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)
