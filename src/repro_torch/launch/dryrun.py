"""Dry run: lay out every (arch x shape x mesh) combo's step on the
production meshes with no hardware, the reference's ``launch/dryrun.py``.

The reference lowers and compiles each step on 256 / 512 forced host
devices and reads XLA's per-device program. Here a fake process group
(``torch.testing._internal.distributed.fake_pg``: backend ``"fake"``,
every collective returns at once, with its result's shape) of
``mesh_devices_required(multi_pod)`` ranks stands for the devices, this
process is its rank 0, and the step runs eagerly on fake tensors
(``FakeTensorMode``: shape, dtype and device, no storage): params,
optimizer state, cache and batch are DTensors over
``make_production_mesh`` laid out by ``param_specs``, ``cache_specs`` and
``batch_spec``, whose local tensors are rank 0's shards. Every op of
rank 0's program runs at its local shapes and is measured there:

* ``memory``: ``MemTracker``'s peak over the step (its inputs, what it
  allocates, its outputs; nothing is donated, as an eager caller holds
  its inputs), with the inputs' and outputs' bytes, and of the inputs
  the params' and the optimizer state's (train) or cache's (decode);
* ``flops_per_device``: the matrix products' flops (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``: the reference counts its ``dot``s) of the ops
  DTensor runs on local shards, counted below its dispatch (a mode that
  sees DTensor ops sees global shapes), plus the work a kernel wrapper
  reports where it is given fake tensors instead of launching;
* ``collectives``: the bytes of each functional collective's result, by
  kind, from ``CommDebugMode``'s traced ops (the reference's
  ``collective_bytes``). On the CPU, DTensor gathers and chunks where a
  card runs an all-to-all;
* ``analytic_bytes_per_device`` and ``roofline``: the reference's
  arithmetic over the H100 ``HW`` table.

Not ported: ``hlo_analysis.module_cost``'s HLO parsing, which reads XLA's
compiled module and has no counterpart in an eager program. Its keys
stay: ``hlo_bytes_per_device`` is the op-level bytes of the local ops
(each reads its inputs and writes its outputs, unfused, as eager PyTorch
runs them: an upper bound, as the reference's), and
``xla_cost_flops_loop_once`` is -1 (no XLA cost analysis), as the
reference writes when its analysis lacks the key. ``peak_bytes_tpu_adj``
equals ``peak_bytes``: the fake step keeps bf16 in bf16, so there is no
CPU upcast to take back.

Usage (``--device cpu`` lays out on fake CPU tensors; the default,
``cuda``, on fake card tensors, and raises without a card):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
      --arch qwen2-72b --shape train_4k [--multi-pod] [--out out.json] \\
      [--layers 8]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out-dir results/

A train step runs every microbatch, each through every layer: at full
depth ``qwen2_72b`` train_4k (80 layers x 16 microbatches) took 19
minutes of one core of an H100 host; ``--layers`` keeps the published
widths and cuts the depth.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from collections import defaultdict
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..configs import ALL_ARCHS, get_config
from ..device import resolve_device
from ..kernels import build as kbuild
from ..models import build_model
from ..models.common import SHAPES, ShapeConfig, tree_size
from ..sharding import mesh_context
from ..sharding.context import Spec, mesh_shape
from ..sharding.rules import (batch_spec, cache_specs, laid_out,
                              param_specs)
from ..train.loop import make_train_step, train_state_shapes
from ..tree import leaves
from .mesh import HW, make_mesh, make_production_mesh, mesh_devices_required

#: functional collectives by the reference's HLO names
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


def choose_fsdp(n_params: int, mode: str, fsdp: Optional[bool]) -> bool:
    """The reference's rule: FSDP (ZeRO-3) params for a train or prefill
    step of more than 8e9 params, and for a decode step whose bf16 params
    over a 16-way ``model`` axis exceed 10e9 bytes; ``fsdp`` overrides."""
    if fsdp is not None:
        return fsdp
    if mode in ("train", "prefill"):
        return n_params > 8e9
    return n_params * 2 / 16 > 10e9


def batch_devices(mesh) -> int:
    """Ranks a batch is split over (``pod`` x ``data``)."""
    ms = mesh_shape(mesh)
    return int(np.prod([v for k, v in ms.items() if k in ("pod", "data")]))


def build_step(model, sc: ShapeConfig, mesh, use_fsdp: bool):
    """(fn, args) of ``sc``'s step: the train step on {params, opt, step}
    (ZeRO-1: both moments on ``fsdp`` specs) and a batch, the prefill on
    params and a batch, or the decode on params, a cache of
    ``cache_capacity(seq_len)`` slots and a batch, every leaf a DTensor
    over ``mesh`` of ``torch.empty`` shards (fake ones under a fake
    tensor mode). A train step's model must carry its microbatches
    already (``clamp_microbatches``)."""
    pshapes = model.param_shapes()
    pspecs = param_specs(pshapes, mesh, fsdp=use_fsdp)
    bshapes = model.input_shapes(sc)
    batch = laid_out(bshapes, batch_spec(bshapes, mesh), mesh, torch.empty)
    if sc.mode == "train":
        zspecs = param_specs(pshapes, mesh, fsdp=True)
        sspecs = {"params": pspecs,
                  "opt": {"m": zspecs, "v": zspecs, "step": Spec()},
                  "step": Spec()}
        state = laid_out(train_state_shapes(model), sspecs, mesh,
                         torch.empty)
        return make_train_step(model), (state, batch)
    params = laid_out(pshapes, pspecs, mesh, torch.empty)
    if sc.mode == "prefill":
        return model.prefill, (params, batch)
    B = sc.global_batch
    cshapes = model.cache_shapes(B, model.cache_capacity(sc.seq_len))
    cache = laid_out(cshapes, cache_specs(cshapes, mesh, B), mesh,
                     torch.empty)
    return model.decode, (params, cache, batch)


def clamp_microbatches(cfg, sc: ShapeConfig, mesh):
    """The reference's clamp: a train step's microbatches at most
    ``global_batch // (pod x data)``, so that every microbatch still
    spans every batch shard."""
    mb_max = max(1, sc.global_batch // batch_devices(mesh))
    if sc.mode == "train" and cfg.train_microbatches > mb_max:
        return cfg.replace(train_microbatches=mb_max)
    return cfg


def build_dryrun(arch: str, shape_name: Union[str, ShapeConfig], *,
                 multi_pod: bool = False, swa_window: int = 0,
                 fsdp: Optional[bool] = None,
                 overrides: Optional[Dict[str, Any]] = None,
                 mesh=None, device=None):
    """((fn, args, mesh, model, fake_mode), meta), or (None, why) for a
    combo the model does not support: ``args`` are fake shards made under
    ``fake_mode``, which ``trace_step`` runs ``fn`` under. ``mesh``
    defaults to the production mesh, which needs a process group of
    ``mesh_devices_required(multi_pod)`` ranks (``run_one`` starts a fake
    one); ``shape_name`` may be a ``ShapeConfig``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_config(arch)
    if swa_window:
        cfg = cfg.replace(sliding_window=swa_window)
    if overrides:
        cfg = cfg.replace(**overrides)
    model = build_model(cfg)
    sc = shape_name if isinstance(shape_name, ShapeConfig) \
        else SHAPES[shape_name]
    ok, why = model.supports(sc)
    if not ok:
        return None, why
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    n_params = tree_size(model.param_shapes())
    use_fsdp = choose_fsdp(n_params, sc.mode, fsdp)
    cfg = clamp_microbatches(cfg, sc, mesh)
    model = build_model(cfg)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        fn, args = build_step(model, sc, mesh, use_fsdp)
    meta = {"arch": arch, "shape": sc.name, "mode": sc.mode,
            "multi_pod": multi_pod, "n_params": int(n_params),
            "fsdp": bool(use_fsdp), "mesh": mesh_shape(mesh),
            "swa_window": swa_window,
            "train_microbatches": cfg.train_microbatches}
    return (fn, args, mesh, model, fake), meta


class LocalCost(torch.utils._python_dispatch.TorchDispatchMode):
    """Flops and op-level bytes of the ops a step runs on local tensors.
    A DTensor op is passed down (``NotImplemented``) so that DTensor runs
    it and this mode sees the local ops it issues, at their local
    shapes; ops DTensor runs under another fake mode to propagate
    shapes are skipped, as ``MemTracker`` skips them. Flops: 2 M N K of
    every ``mm`` / ``addmm`` / ``bmm`` / ``baddbmm``, and what a kernel
    wrapper given fake tensors reports (``kernels.build.fake_launch``).
    Bytes: each non-view op's tensor inputs and outputs."""

    _MM = {"mm", "addmm", "bmm", "baddbmm"}

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.kernel_flops: Dict[str, float] = defaultdict(float)
        self._entry = None

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._entry = active_fake_mode()
        self._hook = kbuild.on_fake_launch
        kbuild.on_fake_launch = self._kernel
        return super().__enter__()

    def __exit__(self, *exc):
        kbuild.on_fake_launch = self._hook
        return super().__exit__(*exc)

    def _kernel(self, name: str, flops: float) -> None:
        self.flops += flops
        self.kernel_flops[name] += flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if active_fake_mode() is not self._entry:
            return out
        name = func._overloadpacket.__name__
        if name in self._MM:
            a, b = (args[1], args[2]) if name.startswith(("add", "badd")) \
                else (args[0], args[1])
            self.flops += 2.0 * float(np.prod(tuple(a.shape))) * b.shape[-1]
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size() for t in
                              _tensors((args, kwargs, out)))
        return out


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    return []


def _mem_tracker():
    """``MemTracker`` that skips the ops DTensor runs to propagate shapes
    (under a fake mode other than the one it was entered under), as
    torch 2.13's does itself: without it (torch 2.11) their global-shape
    fake tensors count into the step's peak."""
    from torch._guards import active_fake_mode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor

    class StepMemTracker(MemTracker):
        def __enter__(self):
            self._step_mode = active_fake_mode()
            return super().__enter__()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not any(issubclass(t, DTensor) for t in types) and \
                    active_fake_mode() is not self._step_mode:
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return StepMemTracker()


def collective_bytes(comm) -> Dict[str, float]:
    """Result bytes of every collective a ``CollectiveBytes`` mode traced,
    by the reference's kinds, with their ``total``."""
    out = dict(comm.bytes)
    out["total"] = float(sum(comm.bytes.values()))
    return out


def _comm_mode():
    from torch.distributed.tensor.debug import CommDebugMode

    class CollectiveBytes(CommDebugMode):
        """``CommDebugMode`` that also sums each collective's result
        bytes by kind."""

        def __init__(self):
            super().__init__()
            self.bytes: Dict[str, float] = defaultdict(float)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented:
                return out
            kind = _COLLECTIVES.get(func._overloadpacket.__name__)
            if kind is not None and \
                    func.namespace in ("_c10d_functional", "c10d"):
                self.bytes[kind] += sum(t.numel() * t.element_size()
                                        for t in _tensors(out))
            return out

    return CollectiveBytes()


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of ``tree``'s tensors."""
    from torch.distributed.tensor import DTensor
    return sum((x.to_local() if isinstance(x, DTensor) else x).numel()
               * x.element_size() for x in leaves(tree)
               if isinstance(x, torch.Tensor))


def trace_step(fn, args, mesh, fake_mode) -> Dict[str, Any]:
    """Run ``fn(*args)`` once under ``mesh_context(mesh)`` and
    ``fake_mode`` (``None``: real tensors), measured as the module
    docstring says: {memory, flops_per_device, hlo_bytes_per_device,
    kernel_flops, collectives}. Works on real DTensors too, where it
    counts the same ops."""
    from torch.distributed.tensor.experimental import implicit_replication

    cost, comm, mt = LocalCost(), _comm_mode(), _mem_tracker()
    with fake_mode or contextlib.nullcontext():
        mt.track_external(*[x for x in leaves(args)
                            if isinstance(x, torch.Tensor)])
        with mesh_context(mesh), implicit_replication(), \
                _propagation_apart(), mt, comm, cost:
            out = fn(*args)
    # the mesh's device: shape-only trees a step builds on ``meta``
    # (``cache_shapes``) are tracked too, and allocate nothing
    peak = {d: v for d, v in mt.get_tracker_snapshot("peak").items()
            if torch.device(d).type == mesh.device_type}
    dev = max(peak, key=lambda d: peak[d]["Total"]) if peak else None
    arg_b = local_bytes(args)
    out_ids = {id(_storage(x)) for x in leaves(args)
               if isinstance(x, torch.Tensor)}
    out_b = local_bytes(out)
    alias_b = sum(_nbytes(x) for x in leaves(out) if isinstance(
        x, torch.Tensor) and id(_storage(x)) in out_ids)
    peak_b = int(peak[dev]["Total"]) if dev is not None else 0
    return {
        "flops_per_device": float(cost.flops),
        "hlo_bytes_per_device": float(cost.bytes),
        "kernel_flops": dict(cost.kernel_flops),
        "collectives": collective_bytes(comm),
        "memory": {"argument_bytes": int(arg_b), "output_bytes": int(out_b),
                   "alias_bytes": int(alias_b),
                   "temp_bytes": max(0, peak_b - int(arg_b)),
                   "peak_bytes": peak_b, "peak_bytes_tpu_adj": peak_b},
    }


@contextlib.contextmanager
def _propagation_apart():
    """Make DTensor propagate shapes under a fake mode of its own. It runs
    each new op once on fake tensors of the global shapes to learn its
    output's, and under an active fake mode it reuses that mode, where
    ``MemTracker`` and ``LocalCost`` would take those ops for the step's:
    with the mode unset there, it makes its own, which both skip."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def apart(self, op_schema):
        with unset_fake_temporarily():
            return orig(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = apart
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _local(x):
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def _storage(x):
    return _local(x).untyped_storage()


def _nbytes(x) -> int:
    x = _local(x)
    return x.numel() * x.element_size()


def run_one(arch: str, shape_name: Union[str, ShapeConfig], *,
            multi_pod: bool = False, swa_window: int = 0,
            fsdp: Optional[bool] = None,
            overrides: Optional[Dict[str, Any]] = None,
            mesh_dims: Optional[Sequence[int]] = None,
            device=None) -> Dict[str, Any]:
    """One combo's dry run, as the reference's ``run_one``: a fake process
    group of ``mesh_devices_required(multi_pod)`` ranks (or of the ranks
    of ``mesh_dims``, a (data, model) shape, instead of the production
    mesh) is started and destroyed on return; it refuses to start while
    another group is live. ``device``: ``cuda`` unless ``"cpu"``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    t0 = time.time()
    sc = shape_name if isinstance(shape_name, ShapeConfig) \
        else SHAPES[shape_name]
    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group is live; the dry run "
                           "starts its own fake one")
    world = (int(np.prod(mesh_dims)) if mesh_dims is not None
             else mesh_devices_required(multi_pod))
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = (make_mesh(mesh_dims, ("data", "model"), dev)
                if mesh_dims is not None else None)
        built, meta = build_dryrun(arch, sc, multi_pod=multi_pod,
                                   swa_window=swa_window, fsdp=fsdp,
                                   overrides=overrides, mesh=mesh,
                                   device=dev)
        if built is None:
            return {"arch": arch, "shape": sc.name, "multi_pod": multi_pod,
                    "status": "skipped", "reason": meta}
        fn, args, mesh, model, fake = built
        traced = trace_step(fn, args, mesh, fake)
        # this rank's params, and its optimizer state (train) or cache
        if meta["mode"] == "train":
            params, state = args[0]["params"], args[0]["opt"]
        else:
            params, state = args[0], (args[1] if meta["mode"] == "decode"
                                      else None)
        traced["memory"]["param_bytes"] = local_bytes(params)
        traced["memory"]["state_bytes"] = local_bytes(state) \
            if state is not None else 0
        n_dev = int(np.prod(list(meta["mesh"].values())))
        result = {**meta, "status": "ok",
                  "compile_s": round(time.time() - t0, 1),
                  "n_devices": n_dev,
                  "flops_per_device": traced["flops_per_device"],
                  "hlo_bytes_per_device": traced["hlo_bytes_per_device"],
                  "analytic_bytes_per_device": float(
                      analytic_bytes(model, sc, n_dev)),
                  "xla_cost_flops_loop_once": -1.0,
                  "kernel_flops": traced["kernel_flops"],
                  "collectives": traced["collectives"],
                  "memory": traced["memory"],
                  "device": dev.type}
        result["roofline"] = roofline_terms(result)
        return result
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        return {"arch": arch, "shape": sc.name, "multi_pod": multi_pod,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:],
                "compile_s": round(time.time() - t0, 1)}
    finally:
        dist.destroy_process_group()


def analytic_bytes(model, sc: ShapeConfig, n_dev: int) -> float:
    """Per-device HBM-traffic floor, the reference's arithmetic: the
    unavoidable passes over params, optimizer state, activations and
    caches given the step type."""
    pshapes = model.param_shapes()
    pbytes = sum(int(np.prod(tuple(x.shape))) * x.element_size()
                 for x in leaves(pshapes))
    cfg = model.cfg
    B, S = sc.global_batch, sc.seq_len
    act_tok_bytes = cfg.d_model * 2  # bf16 residual stream
    L = cfg.n_layers
    if sc.mode == "train":
        # params: read fwd + read bwd + grad write (bf16); opt: m, v r/w f32
        param_traffic = 3 * pbytes + 4 * tree_size(pshapes) * 4
        acts = 12 * B * S * act_tok_bytes * L  # ~12 materializations/layer
        logits = 4 * B * S * cfg.vocab_size * 2
        total = param_traffic + acts + logits
    elif sc.mode == "prefill":
        acts = 8 * B * S * act_tok_bytes * L
        cache = 2 * tree_size(model.cache_shapes(
            B, model.cache_capacity(S))) * 2
        total = pbytes + acts + cache
    else:
        cache_bytes = sum(int(np.prod(tuple(x.shape))) * x.element_size()
                          for x in leaves(model.cache_shapes(
                              B, model.cache_capacity(S))))
        total = pbytes + 2 * cache_bytes + 8 * B * act_tok_bytes * L
    return total / n_dev


def roofline_terms(res: Dict[str, Any]) -> Dict[str, float]:
    """Three roofline terms in seconds, per device, over the H100 ``HW``
    table: flops over the bf16 peak, the analytic bytes over HBM (the
    op-level bytes as the upper bound), collective bytes over the
    inter-node link."""
    flops = max(res.get("flops_per_device", 0.0), 0.0)
    byts = max(res.get("analytic_bytes_per_device", 0.0), 0.0)
    byts_hi = max(res.get("hlo_bytes_per_device", 0.0), 0.0)
    coll = res.get("collectives", {}).get("total", 0.0)
    t_compute = flops / HW["peak_flops_bf16"]
    t_memory = byts / HW["hbm_bw"]
    t_coll = coll / HW["link_bw"]
    dom = max((("compute", t_compute), ("memory", t_memory),
               ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_memory_upper_s": byts_hi / HW["hbm_bw"],
            "t_collective_s": t_coll, "bottleneck": dom}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--swa-window", type=int, default=0)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--fsdp", type=int, default=-1,
                    help="-1 auto, 0 off, 1 on")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this many layers, widths "
                    "kept (0: full depth; not a flag of the reference's)")
    args = ap.parse_args(argv)
    fsdp = None if args.fsdp < 0 else bool(args.fsdp)
    resolve_device(args.device)
    overrides = {"n_layers": args.layers} if args.layers else None

    combos = []
    if args.all:
        for a in ALL_ARCHS:
            for s in SHAPES:
                combos.append((a, s))
    else:
        combos.append((args.arch, args.shape))

    results = []
    for arch, shape in combos:
        res = run_one(arch, shape, multi_pod=args.multi_pod,
                      swa_window=args.swa_window, fsdp=fsdp,
                      overrides=overrides, device=args.device)
        results.append(res)
        line = {k: v for k, v in res.items() if k not in ("trace",)}
        print(json.dumps(line), flush=True)
        if args.out_dir:
            import pathlib
            pathlib.Path(args.out_dir).mkdir(parents=True, exist_ok=True)
            tag = f"{arch}_{shape}_{'mp' if args.multi_pod else 'sp'}"
            with open(f"{args.out_dir}/{tag}.json", "w") as f:
                json.dump(res, f, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
