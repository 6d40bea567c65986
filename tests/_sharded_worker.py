"""One sharded ``make_train_step`` step of each reduced case, on a
``data`` x ``model`` mesh of ranks: the multi-rank half of
``tests/test_torch_distributed.py``, and of ``chip_smoke.py``'s
``train_sharded`` phase on a host with four cards.

    PYTHONPATH=src python tests/_sharded_worker.py IN.npz OUT.npz cpu 4x2

``IN.npz`` holds ``meta`` (the JSON of ``CASES``) and, for each case,
its init (``<case>/init/<leaf path>``) and its batch
(``<case>/batch/<key>``: tokens, labels, and an encoder-decoder's
frames). One ``torch.multiprocessing`` spawn of one rank a
mesh position (gloo on the CPU, or NCCL with one card a rank) lays each
state out as DTensors by ``case_specs``, runs one step (constant lr
1e-3, clip 1.0) under ``mesh_context`` and has rank 0 write to
``OUT.npz``: the loss, the new params and both new moments in full, each
param's placements, and whether every state leaf came back in the
placements it went in with.

Each case of ``SERVE`` (where ``IN.npz`` has its ``<case>/prompt/<key>``)
then serves too: the case's init laid out by ``param_specs``, a sharded
prefill of the prompt into a cache of ``SERVE_CAPACITY`` slots laid out
by ``cache_specs``, and ``SERVE_STEPS`` greedy decode steps; rank 0
writes each step's logits in full (``<case>/serve/logits``, prefill
first) and the tokens (``<case>/serve/tokens``).
"""
import json
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: case -> (arch, reduced widths, microbatches, fsdp specs)
CASES = {
    "llama": ("llama3.2-1b", dict(n_layers=2, d_model=64, n_heads=4,
                                  n_kv_heads=2, d_ff=128, vocab_size=256),
              2, False),
    "olmoe": ("olmoe_1b_7b", dict(moe_capacity_factor=0.5), 1, True),
    # one KV head: `model` does not divide it (K and V made whole, query
    # heads kept split; the decode cache split over its slots)
    "llama_kv1": ("llama3.2-1b", dict(n_layers=2, d_model=64, n_heads=4,
                                      n_kv_heads=1, d_ff=128,
                                      vocab_size=256), 2, False),
    # the recurrent families: RWKV6's chunked WKV and token shift, Zamba2's
    # SSD scan beside its shared attention, each on rows and heads
    "rwkv6": ("rwkv6_7b", {}, 1, False),
    "zamba2": ("zamba2_7b", {}, 1, False),
    # the encoder-decoder: frames in, cross-attention caches out
    "seamless": ("seamless_m4t_large_v2", {}, 1, False),
}

#: the cases that also prefill and decode greedily, sharded
SERVE = ("llama", "olmoe", "llama_kv1", "rwkv6", "zamba2", "seamless")
SERVE_CAPACITY = 20
SERVE_STEPS = 3


def case_specs(params, mesh, fsdp: bool):
    """The params' spec tree: ``param_specs``, or with ``fsdp`` the
    reference's ``spec_for_leaf(..., fsdp=True, fsdp_min_size=1)``, since
    ``_apply_fsdp`` only shards leaves of ``1 << 20`` elements and more
    and no leaf of a reduced model is that large."""
    from repro_torch.sharding.context import mesh_shape
    from repro_torch.sharding.rules import (map_with_path, param_specs,
                                            spec_for_leaf)
    if not fsdp:
        return param_specs(params, mesh)
    ms = mesh_shape(mesh)
    return map_with_path(lambda p, x: spec_for_leaf(
        p, x.shape, ms, fsdp=True, fsdp_min_size=1), params)


def run(rank, world, port, src, out, device, shape):
    if device == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        work(rank, src, out, device, shape)
    finally:
        dist.destroy_process_group()


def work(rank, src, out, device, shape):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init, constant_lr
    from repro_torch.sharding import mesh_context
    from repro_torch.sharding.context import Spec
    from repro_torch.sharding.rules import distribute, leaf_paths
    from repro_torch.train import make_train_step, shard_batch
    from repro_torch.tree import leaves, unflatten

    data = np.load(src)
    meta = json.loads(str(data["meta"]))
    mesh = make_mesh(shape, ("data", "model"), device)
    where = torch.device("cuda", rank) if device == "cuda" else "cpu"
    res = {}
    for case, (arch, widths, mb, fsdp) in meta.items():
        model = build_model(get_config(arch).reduced(**widths))
        shapes = model.param_shapes()
        paths = leaf_paths(shapes)
        params = unflatten(shapes, [
            torch.from_numpy(data[f"{case}/init/{p}"]).to(where)
            for p in paths])
        state = {"params": params, "opt": adamw_init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=where)}
        batch = inputs(data, f"{case}/batch/", where)
        ps = case_specs(params, mesh, fsdp)
        state = distribute(state, {
            "params": ps, "opt": {"m": ps, "v": ps, "step": Spec()},
            "step": Spec()}, mesh)
        step = make_train_step(model, lr_fn=constant_lr(1e-3),
                               clip_norm=1.0, microbatches=mb)
        with mesh_context(mesh):
            new, metrics = step(state, shard_batch(batch, mesh))
        res[f"{case}/loss"] = metrics["loss"].full_tensor().cpu().numpy()
        for part, tree in (("new", new["params"]), ("m", new["opt"]["m"]),
                           ("v", new["opt"]["v"])):
            for p, x in zip(paths, leaves(tree)):
                res[f"{case}/{part}/{p}"] = x.full_tensor().cpu().numpy()
        res[f"{case}/kept"] = np.array(all(
            tuple(a.placements) == tuple(b.placements)
            for a, b in zip(leaves(new), leaves(state))))
        res[f"{case}/placements"] = np.array(json.dumps({
            p: str(tuple(x.placements)) for p, x in
            zip(paths, leaves(new["params"]))}))
        prompt = inputs(data, f"{case}/prompt/", where)
        if case in SERVE and prompt:
            res.update(serve(model, params, prompt, mesh, case))
    if rank == 0:
        np.savez(out, **res)


def inputs(data, prefix, where):
    """The arrays of ``data`` under ``prefix``, by the rest of their
    names, as tensors on ``where``."""
    return {k[len(prefix):]: torch.from_numpy(data[k]).to(where)
            for k in data.files if k.startswith(prefix)}


def serve(model, params, prompt, mesh, case):
    """The sharded prefill of ``prompt`` (its tokens, and frames where the
    model encodes them) and ``SERVE_STEPS`` greedy decode
    steps: {``<case>/serve/logits`` (steps + 1, B, V), ``.../tokens`` (B,
    steps + 1)}, each step's logits gathered whole."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.sharding import mesh_context
    from repro_torch.sharding.rules import distribute, param_specs
    from repro_torch.train import shard_batch

    sparams = distribute(params, param_specs(params, mesh), mesh)
    logits, toks = [], []
    with mesh_context(mesh), implicit_replication():
        out, cache = model.prefill(
            sparams, shard_batch(prompt, mesh),
            capacity=SERVE_CAPACITY)
        for _ in range(SERVE_STEPS + 1):
            full = out.full_tensor()
            logits.append(full.cpu().numpy())
            tok = torch.argmax(full, dim=-1).to(torch.int32)[:, None]
            toks.append(tok.cpu().numpy())
            if len(toks) > SERVE_STEPS:
                break
            out, cache = model.decode(sparams, cache, {"token": tok})
    return {f"{case}/serve/logits": np.stack(logits),
            f"{case}/serve/tokens": np.concatenate(toks, axis=1)}


if __name__ == "__main__":
    src, out, device, shape = sys.argv[1:5]
    shape = tuple(int(n) for n in shape.split("x"))
    world = shape[0] * shape[1]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(run, args=(world, port, src, out, device, shape), nprocs=world)
