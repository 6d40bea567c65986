"""A sharded train step of the port held to the reference's single-device
step, the counterpart of ``tests/test_distributed.py``.

The parent process runs JAX's step (constant lr 1e-3, clip 1.0) on the
CPU for two reduced models and writes their inits, batches and results
to an npz:

- ``llama3.2-1b`` at ``tests/test_distributed.py``'s widths (2 layers,
  d 64, 4 heads over 2 KV heads, d_ff 128, vocab 256), B 8 x S 32, with
  2 microbatches (a slice of a batch sharded over ``data``);
- ``olmoe_1b_7b`` reduced with capacity dispatch at factor 0.5, one
  microbatch, the reference's ``axis_size`` patched so ``data`` reads
  the mesh's size: its dispatch then groups tokens by that axis, with
  drops.

``tests/_sharded_worker.py`` then runs one ``torch.multiprocessing``
spawn of 8 gloo ranks on a (data 4, model 2) mesh: it bridges each init,
lays the state out as DTensors (llama with ``param_specs``; olmoe with
``fsdp`` specs built through ``spec_for_leaf(..., fsdp_min_size=1)``, so
that leaves of a reduced model really shard over ``data``), runs one
``make_train_step`` step under ``mesh_context`` and writes the loss, the
new params, both new AdamW moments and every param's placements. The
parent holds the loss and params to the reference test's bounds (loss
1e-4, params 5e-4), the moments to 1e-4 of each leaf's scale (the first
step's params only see each gradient's sign; the moments see its size,
and so a global-norm clip taken over one rank's shards), and the
placements to ``placements`` of the specs; every state leaf must come
back in the placements it went in with. The ``cuda`` case does the same
over NCCL on a (2, 2) mesh of four cards and skips with fewer.
"""
import json
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
from repro.configs import get_config
from repro.models import build_model
from repro.optim import constant_lr
from repro.sharding.rules import _path_str
from repro.train.loop import init_train_state, make_train_step
from repro_torch.configs import get_config as tget
from repro_torch.models import build_model as tbuild
from repro_torch.sharding.context import placements
from repro_torch.sharding.rules import leaf_paths, leaves_of_specs

from _sharded_worker import CASES, case_specs

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = pathlib.Path(__file__).resolve().parent / "_sharded_worker.py"
LOSS_TOL = 1e-4
PARAM_TOL = 5e-4
#: AdamW's first moments are (1 - b1) x the clipped gradient and its
#: second (1 - b2) x its square: each leaf within this x its max |JAX|
#: (a step's params hold each gradient's sign only; these its size, and
#: so the global-norm clip across shards)
MOMENT_RTOL = 1e-4


def _reference(tmp_path, monkeypatch, data: int):
    """JAX's single-device step for every case, the data axis read as
    ``data`` by the MoE's grouping: (npz of inputs, results)."""
    monkeypatch.setattr(jmoe, "axis_size",
                        lambda name: data if name == "data" else 1)
    # on the CPU even where JAX sees a card (its matmuls would take TF32)
    with jax.default_device(jax.devices("cpu")[0]):
        return _reference_steps(tmp_path)


def _reference_steps(tmp_path):
    arrays, want = {"meta": json.dumps(CASES)}, {}
    for case, (arch, widths, mb, _) in CASES.items():
        model = build_model(get_config(arch).reduced(**widths))
        state = init_train_state(model, jax.random.PRNGKey(0))
        tokens = jax.random.randint(jax.random.PRNGKey(1), (8, 32), 0,
                                    model.cfg.vocab_size)
        batch = {"tokens": tokens, "labels": jnp.roll(tokens, -1, axis=1)}
        step = make_train_step(model, lr_fn=constant_lr(1e-3),
                               clip_norm=1.0, microbatches=mb)
        new, metrics = jax.jit(step)(state, batch)
        for path, x in jax.tree_util.tree_flatten_with_path(
                state["params"])[0]:
            arrays[f"{case}/init/{_path_str(path)}"] = np.asarray(x)
        for k, v in batch.items():
            arrays[f"{case}/{k}"] = np.asarray(v, np.int32)
        want[case] = (float(metrics["loss"]), {
            part: {_path_str(p): np.asarray(x) for p, x in
                   jax.tree_util.tree_flatten_with_path(tree)[0]}
            for part, tree in (("new", new["params"]),
                               ("m", new["opt"]["m"]),
                               ("v", new["opt"]["v"]))})
    src = tmp_path / "inputs.npz"
    np.savez(src, **arrays)
    return src, want


def _expected_placements(case, mesh):
    """Each param's placements by the specs the worker lays it out with."""
    arch, widths, _, fsdp = CASES[case]
    shapes = tbuild(tget(arch).reduced(**widths)).param_shapes()
    specs = case_specs(shapes, mesh, fsdp)
    return {p: str(placements(s, mesh))
            for p, s in zip(leaf_paths(shapes), leaves_of_specs(specs))}


def _run_and_check(tmp_path, monkeypatch, device, shape):
    src, want = _reference(tmp_path, monkeypatch, shape[0])
    out = tmp_path / "out.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(WORKER), str(src), str(out), device,
         "x".join(map(str, shape))], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = np.load(out)
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=shape)
    for case in CASES:
        loss, ref = want[case]
        assert abs(float(got[f"{case}/loss"]) - loss) < LOSS_TOL, case
        diff = {p: float(np.abs(got[f"{case}/new/{p}"] - w).max())
                for p, w in ref["new"].items()}
        assert max(diff.values()) < PARAM_TOL, (case, diff)
        for part in ("m", "v"):
            rel = {p: float(np.abs(got[f"{case}/{part}/{p}"] - w).max()
                            / np.abs(w).max())
                   for p, w in ref[part].items()}
            assert max(rel.values()) < MOMENT_RTOL, (case, part, rel)
        assert bool(got[f"{case}/kept"]), case
        assert json.loads(str(got[f"{case}/placements"])) == \
            _expected_placements(case, mesh), case
    # fsdp specs shard some of olmoe's leaves over data: the case is real
    assert any("Shard" in pl.split(",")[0] for pl in
               _expected_placements("olmoe", mesh).values())


def test_sharded_step_matches_jax_on_8_gloo_ranks(tmp_path, monkeypatch):
    _run_and_check(tmp_path, monkeypatch, "cpu", (4, 2))


@pytest.mark.cuda
def test_sharded_step_matches_jax_on_4_cards(tmp_path, monkeypatch):
    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs four cards, found {torch.cuda.device_count()}")
    _run_and_check(tmp_path, monkeypatch, "cuda", (2, 2))
