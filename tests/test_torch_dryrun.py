"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``), on the CPU.

- **Held to the reference.** ``run_one(..., overrides={"n_layers": 2,
  "train_microbatches": 1})`` of ``qwen2_72b`` at train_4k, prefill_32k
  and decode_32k on the single-pod mesh and of ``olmoe_1b_7b`` at
  train_4k on the multi-pod one, in both packages: ``status``, ``mode``,
  ``mesh``, ``n_params``, ``fsdp``, the clamped microbatches and
  ``analytic_bytes_per_device`` equal, ``flops_per_device`` within
  ``FLOP_RTOL``. The reference runs in a subprocess (its module sets
  ``XLA_FLAGS`` to 512 host devices at import), kept to one core, while
  this process lays out the reduced configs and then the port's combos:
  one process of the port, so that DTensor plans each op once and the
  file adds little load beside the other test workers.
- **Skips.** ``long_500k`` on a full-attention arch is ``skipped`` with
  the reference's reason, word for word.
- **One reduced config a family and mechanism** (dense GQA, one KV
  head, MoE, VLM, RWKV6, Zamba2, encoder-decoder) on a fake 4 x 2 mesh,
  train and decode: ``status == "ok"``. One process lays them all out:
  DTensor plans each new op once, and the reduced configs share most
  shapes. The sharded prefill, and the values of every mode, are held to
  JAX on real gloo ranks in ``tests/test_torch_distributed.py``.
- **C1**: the vocab-parallel loss on fake shards, forward and backward,
  makes no all-gather whose output has the vocab's width.
- **The counter**: a DTensor product of known shards counts the local
  flops, and its peak is its inputs and output.
- The dry run refuses a live process group, and without a card and
  without ``--device cpu`` its CLI raises.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models.common import SHAPES, ShapeConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
OVERRIDES = {"n_layers": 2, "train_microbatches": 1}
#: (arch, shape, multi_pod) held to the reference
HELD = [("qwen2_72b", "train_4k", False), ("qwen2_72b", "prefill_32k", False),
        ("qwen2_72b", "decode_32k", False), ("olmoe_1b_7b", "train_4k", True)]
SKIP = ("qwen2_72b", "long_500k", False)
FLOP_RTOL = 0.05
#: the reduced layout check: a fake (data 4, model 2) mesh, short shapes
#: (the flash path still taken: 128 > attn_chunk 64), one batch for both
#: modes, so that the decode's layers reuse the train step's plans
MESH = (4, 2)
SMALL = {"train": ShapeConfig("train_128", 128, 8, "train"),
         "decode": ShapeConfig("decode_128", 128, 8, "decode")}
#: one reduced config a family and mechanism: {id: (arch, widths)}
REDUCED = {
    "dense": ("llama3_2_1b", {}),
    # one KV head: ``model`` (2) does not divide it (K and V whole, the
    # query heads split, the decode cache split over its slots)
    "dense-kv1": ("llama3_2_1b", {"n_kv_heads": 1}),
    "moe": ("olmoe_1b_7b", {}),
    "vlm": ("internvl2_26b", {}),
    "rwkv6": ("rwkv6_7b", {}),
    "zamba2": ("zamba2_7b", {}),
    "encdec": ("seamless_m4t_large_v2", {}),
}

_REFERENCE = """
import json, os, sys
os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:1])
from repro.launch.dryrun import build_dryrun, run_one
for arch, shape, mp in json.loads(sys.argv[1]):
    r = run_one(arch, shape, multi_pod=mp, overrides=json.loads(sys.argv[2]))
    r.pop("trace", None)
    if r["status"] == "ok":
        built, _ = build_dryrun(arch, shape, multi_pod=mp,
                                overrides=json.loads(sys.argv[2]))
        r["train_microbatches"] = built[5].cfg.train_microbatches
    print(json.dumps(r), flush=True)
"""

class _Run:
    """A subprocess started at once, read when first asked: one JSON
    object a line, by (arch, shape, multi_pod) or by arch."""

    def __init__(self, code, *args):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code, *args], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._out = None

    def results(self):
        if self._out is None:
            out, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, err[-4000:]
            self._out = [json.loads(line) for line in out.splitlines()
                         if line.startswith("{")]
        return self._out

    def get(self, arch, shape=None, multi_pod=False):
        for r in self.results():
            if r["arch"] == arch and (shape is None or (
                    r["shape"] == shape and r["multi_pod"] == multi_pod)):
                return r
        raise KeyError((arch, shape, multi_pod))


@pytest.fixture(scope="module")
def reference():
    """The reference's held combos, in a subprocess started at once."""
    run = _Run(_REFERENCE, json.dumps(HELD + [SKIP]), json.dumps(OVERRIDES))
    yield run
    if run.proc.poll() is None:
        run.proc.kill()
        run.proc.communicate()


_PORT = {}


def port_run(arch, shape, multi_pod):
    """The port's ``run_one`` of a held combo: all of them at the first
    call, before any test waits for the reference's subprocess."""
    if not _PORT:
        for key in HELD + [SKIP]:
            _PORT[key] = dryrun.run_one(key[0], key[1], multi_pod=key[2],
                                        overrides=OVERRIDES, device="cpu")
    return _PORT[(arch, shape, multi_pod)]


def reduced_status(arch, widths, mode):
    """``arch``'s reduced config laid out on the fake 4 x 2 mesh in
    ``mode``: its status, or the error."""
    red = get_config(arch).reduced(**widths)
    over = {k: getattr(red, k) for k in red.__dataclass_fields__
            if k not in ("name", "family", "source")}
    r = dryrun.run_one(arch, SMALL[mode], overrides=over, mesh_dims=MESH,
                       device="cpu")
    return r["status"] if r["status"] != "error" else \
        r["error"] + r["trace"][-600:]


# -- while the reference's subprocess runs ------------------------------


@pytest.mark.parametrize("mode", SMALL)
@pytest.mark.parametrize("case", REDUCED)
def test_reduced_config_lays_out(case, mode, reference):
    arch, widths = REDUCED[case]
    assert reduced_status(arch, widths, mode) == "ok"


def _fake_mesh(world, shape):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    return make_mesh(shape, ("data", "model"), "cpu")


def test_vocab_parallel_loss_gathers_no_vocab(reference):
    """C1: DTensor logits split over the vocab (8 x 16 x 512 on data 4 x
    model 2) through ``softmax_xent`` and back: no all-gather's output
    is as wide as the vocab, and the loss comes back replicated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.models.common import softmax_xent

    V = 512
    mesh = _fake_mesh(8, MESH)
    gathered = []

    class Record(CommDebugMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented and "all_gather" in str(func):
                gathered.append(tuple(out.shape))
            return out

    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            logits = DTensor.from_local(
                torch.empty(2, 16, V // 2), mesh, (Shard(0), Shard(2)),
                run_check=False).requires_grad_()
            labels = DTensor.from_local(
                torch.empty(2, 16, dtype=torch.int64), mesh,
                (Shard(0), Replicate()), run_check=False)
            comm = Record()
            with comm:
                loss = softmax_xent(logits, labels)
                loss.backward()
        assert all(p == Replicate() for p in loss.placements)
        assert comm.get_total_counts() > 0          # the reductions ran
        assert not any(s and s[-1] == V for s in gathered), gathered
        assert logits.grad.placements == logits.placements
    finally:
        dist.destroy_process_group()


def test_rwkv6_layer_lays_out_on_the_multi_pod_mesh(reference):
    """One ``rwkv6_7b`` layer (``d_model`` 1024, 16 heads of 64: the
    family's head width, ``model`` dividing the heads), forward and
    backward on fake shards of the multi-pod mesh (pod 2 x data 16 x
    model 16) with 8 rows a rank: the layout where the full train_4k
    step failed. The row-parallel sums that meet an elementwise product
    (the channel mix's ``k @ w_ch_v``) and the gradients of the LoRA
    products (``_ddlerp``'s mixes, the decay's ``tanh``) reach DTensor
    with a token dim split over pod, data and, strided, model, whose
    propagation fails on fake tensors (``aten._local_scalar_dense``)
    unless the channel mix's sums are reduce-scattered first and the
    LoRAs' first products run on each rank's rows. The input's gradient
    keeps its row split with no pending sums, and no (B, L, 5, D)
    gradient of the mixes is all-reduced: only the LoRA's (B, L, rank)
    one is gathered."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models import rwkv6
    from repro_torch.models.common import stack_views
    from repro_torch.sharding.context import mesh_context
    from repro_torch.sharding.rules import laid_out, param_specs

    cfg = get_config("rwkv6_7b").replace(
        n_layers=1, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=512,
        vocab_size=512)
    model = build_model(cfg)
    B, L = 256, 32
    reduced = []

    class Record(CommDebugMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented and "all_reduce" in str(func):
                reduced.append(tuple(out.shape))
            return out

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        mesh = make_mesh((2, 16, 16), ("pod", "data", "model"), "cpu")
        pshapes = model.param_shapes()
        with FakeTensorMode(allow_non_fake_inputs=True):
            params = laid_out(pshapes, param_specs(pshapes, mesh), mesh,
                              torch.empty)
            x = DTensor.from_local(
                torch.empty(B // 32, L, cfg.d_model, dtype=torch.bfloat16),
                mesh, (Shard(0), Shard(0), Replicate()),
                run_check=False).requires_grad_()
            with mesh_context(mesh), implicit_replication(), Record():
                lp = next(stack_views(params["layers"]))
                state = {k: v[0] for k, v in model.new_cache(
                    B, 1, like=x).items() if k != "t"}
                y = rwkv6._layer_out(lp, x, cfg, state, "chunked")[0]
                y.backward(torch.ones_like(y))
        assert tuple(x.grad.placements[:2]) == tuple(x.placements[:2])
        assert not any(p.is_partial() for p in x.grad.placements)
        assert reduced, "the layer's sums were never reduced"
        assert not any(s[-2:] == (rwkv6.N_MIX, cfg.d_model)
                       for s in reduced), reduced
    finally:
        dist.destroy_process_group()


def test_local_flop_count_on_a_known_product(reference):
    """x (1024, 1024) split over data 16 by rows @ w (1024, 1024) split
    over model 16 by columns: rank 0 multiplies (64, 1024) by (1024,
    64), 2 x 64 x 1024 x 64 flops, with no collective; its peak is its
    two shards and the (64, 64) product."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = _fake_mesh(256, (16, 16))
    try:
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        with fake:
            x = DTensor.from_local(torch.empty(64, 1024), mesh,
                                   (Shard(0), Replicate()), run_check=False)
            w = DTensor.from_local(torch.empty(1024, 64), mesh,
                                   (Replicate(), Shard(1)), run_check=False)
        got = dryrun.trace_step(lambda x, w: x @ w, (x, w), mesh, fake)
    finally:
        dist.destroy_process_group()
    assert got["flops_per_device"] == 2 * 64 * 1024 * 64
    assert got["collectives"]["total"] == 0
    assert got["memory"]["peak_bytes"] == 4 * (2 * 64 * 1024 + 64 * 64)


def test_refuses_a_live_group(reference):
    mesh = _fake_mesh(8, MESH)
    try:
        assert mesh is not None
        with pytest.raises(RuntimeError, match="process group is live"):
            dryrun.run_one("llama3_2_1b", SMALL["train"], mesh_dims=MESH,
                           device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cli_raises_without_a_card(reference):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "qwen2-72b", "--shape", "train_4k"])


#: dense combos whose query heads ``model`` (16) does not divide
#: (smollm_135m 9, qwen2_5_14b 40): the port splits the queries by
#: sequence where the reference repeats attention on every ``model``
#: rank, so these are held to the analytic count of an even split
ANALYTIC = [("smollm_135m", "train_4k"), ("qwen2_5_14b", "prefill_32k"),
            ("smollm_135m", "decode_32k")]


def analytic_flops(arch, shape, layers, n_dev):
    """A dense model's matmul flops a device, split evenly over ``n_dev``:
    each layer's projections (2 T P) and attention (4 B Sq Sk H dh: the
    flash loop scores every key chunk, decode every cache slot), and the
    unembedding (a prefill's last position only). A train step runs 3x
    the forward, and with ``remat`` the layers' forward once more,
    less each layer's last product, which the recompute stops before
    (nothing saved for the backward depends on it)."""
    cfg = get_config(arch)
    sc = SHAPES[shape]
    d, H, KV, dh, ff, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.dh, cfg.d_ff, cfg.vocab_size)
    B, S = sc.global_batch, sc.seq_len
    P = d * H * dh + 2 * d * KV * dh + H * dh * d + 3 * d * ff
    if sc.mode == "decode":
        per = 2 * B * P + 4 * B * H * S * dh
        return (layers * per + 2 * B * d * V) / n_dev
    T = B * S
    fwd = 2 * T * P + 4 * B * S * S * H * dh
    if sc.mode == "prefill":
        return (layers * fwd + 2 * B * d * V) / n_dev
    per = 4 * fwd - 2 * T * ff * d if cfg.remat else 3 * fwd
    return (layers * per + 3 * 2 * T * d * V) / n_dev


@pytest.mark.parametrize("combo", ANALYTIC, ids="-".join)
def test_uneven_heads_flops_match_the_analytic_count(combo, reference):
    r = dryrun.run_one(*combo, overrides=OVERRIDES, device="cpu")
    assert r["status"] == "ok", r.get("error")
    n_dev = int(np.prod(list(r["mesh"].values())))
    assert r["flops_per_device"] == analytic_flops(
        *combo, OVERRIDES["n_layers"], n_dev)


# -- the held combos, here and in the reference -------------------------


def test_long_500k_skip_matches_reference(reference):
    got = port_run(*SKIP)
    ref = reference.get(*SKIP)
    assert ref["status"] == got["status"] == "skipped"
    assert got["reason"] == ref["reason"]


@pytest.mark.parametrize("combo", HELD, ids=lambda c: f"{c[0]}-{c[1]}"
                         f"{'-mp' if c[2] else ''}")
def test_held_to_the_reference(combo, reference):
    got = port_run(*combo)
    ref = reference.get(*combo)
    assert got["status"] == ref["status"] == "ok", got.get("error")
    for key in ("mode", "mesh", "n_params", "fsdp", "train_microbatches",
                "analytic_bytes_per_device"):
        assert got[key] == ref[key], key
    rel = abs(got["flops_per_device"] - ref["flops_per_device"]) \
        / ref["flops_per_device"]
    assert rel <= FLOP_RTOL, (got["flops_per_device"],
                              ref["flops_per_device"])
    assert set(got["collectives"]) <= {"all-gather", "all-reduce",
                                       "reduce-scatter", "all-to-all",
                                       "broadcast", "total"}
    assert got["memory"]["peak_bytes"] >= got["memory"]["argument_bytes"]
    assert got["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")
