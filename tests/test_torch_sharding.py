"""The port's ``sharding/`` and ``launch/mesh.py`` meshes against the
reference's, on the CPU in one process.

- ``spec_for_leaf`` / ``param_specs`` equal to ``repro.sharding.rules``
  for every (path, shape) of every config's params at published widths,
  over (data 16, model 16), (pod 2, data 16, model 16), (data 4, model
  2) and (data 1, model 1), with and without ``fsdp``; every path of
  JAX's ``jax.eval_shape(model.init)`` on a reduced model is one of the
  port's, with the same spec. The reference's functions take a
  duck-typed mesh: they read only ``mesh.shape``.
- ``batch_spec`` and ``cache_specs`` equal to the reference's on every
  family's decode cache at B 8 and B 1 and on the long-context cache of
  ``tests/test_substrates.py``; ``divisible`` and ``_clean_spec`` on
  dims a mesh axis does not divide.
- ``mesh_context`` nests and restores; ``axis_size`` reads the current
  mesh; ``shard_act`` hands back a plain tensor untouched;
  ``placements`` lays ``("pod", "data")`` over both mesh dims.
- ``make_production_mesh`` names ``mesh_devices_required`` when the
  group is not 256 / 512 ranks; ``make_host_mesh("cpu")`` starts a
  one-rank gloo group, on which a sharded ``make_train_step`` step of
  reduced llama equals the plain step (its state's placements kept).
- The MoE's mesh-grouped dispatch: with ``axis_size`` patched in both
  packages so that ``data`` reads 4, ``_moe_dispatch`` and ``moe_ffn``
  equal JAX's at factor 0.5 (drops asserted, and the output differs
  from one group's) and 1.25, and a T that 4 does not divide falls back
  to one group. One group (the serving dispatch) builds no per-group
  row offsets.
"""
import itertools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_threads import one_intra_op_thread  # noqa: F401
import repro.sharding.context as jctx
import repro.sharding.rules as jrules
from repro.configs import get_config
from repro.models import build_model
from repro.models import moe as jmoe
from repro_torch.bridge import to_torch
from repro_torch.configs import ALL_ARCHS
from repro_torch.configs import get_config as tget
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model as tbuild
from repro_torch.models import moe as tmoe
from repro_torch.optim import constant_lr
from repro_torch.sharding import (axis_size, batch_spec, current_mesh,
                                  divisible, mesh_context, param_specs,
                                  shard_act)
from repro_torch.sharding.context import Spec, _clean_spec, placements
from repro_torch.sharding.rules import (cache_specs, leaf_paths,
                                        leaves_of_specs, spec_for_leaf)
from repro_torch.train.loop import (init_train_state, make_train_step,
                                    shard_batch, shard_train_state)
from repro_torch.tree import leaves

MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "4x2": {"data": 4, "model": 2},
    "1x1": {"data": 1, "model": 1},
}


def _mesh(shape):
    """A duck-typed ``DeviceMesh``: dim names and sizes, all the port's
    rules read of one (the reference's read ``SimpleNamespace(shape=
    {name: size})``)."""
    return SimpleNamespace(shape=tuple(shape.values()),
                           mesh_dim_names=tuple(shape))


def _abstract(tree):
    """The port's tree of tensors as JAX shape structs (same nesting)."""
    if isinstance(tree, dict):
        return {k: _abstract(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_abstract(v) for v in tree)
    return jax.ShapeDtypeStruct(tuple(tree.shape), jnp.float32)


def _jax_by_path(tree):
    return {jrules._path_str(p): s for p, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}


def _port_by_path(tree, specs):
    return dict(zip(leaf_paths(tree), leaves_of_specs(specs)))


# ---------------------------------------------------------------------------
# parameter, batch and cache specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_equal_reference_at_published_widths(arch):
    shapes = tbuild(tget(arch)).param_shapes()
    paths = leaf_paths(shapes)
    for (name, ms), fsdp in itertools.product(MESHES.items(),
                                              (False, True)):
        specs = leaves_of_specs(param_specs(shapes, _mesh(ms), fsdp=fsdp))
        for path, x, got in zip(paths, leaves(shapes), specs):
            want = jrules.spec_for_leaf(path, tuple(x.shape), ms, fsdp=fsdp)
            assert isinstance(got, Spec)
            assert got == want and tuple(got) == tuple(want), \
                (name, fsdp, path, got, want)
            assert got == spec_for_leaf(path, x.shape, ms, fsdp=fsdp)
    # fsdp shards something at 16 x 16 at published widths
    assert any("data" in s for s in leaves_of_specs(param_specs(
        shapes, _mesh(MESHES["16x16"]), fsdp=True)))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_paths_and_specs_equal_reference_reduced(arch):
    jm = build_model(get_config(arch).reduced())
    jshapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tshapes = tbuild(tget(arch).reduced()).param_shapes()
    for ms in MESHES.values():
        for fsdp in (False, True):
            want = _jax_by_path(jrules.param_specs(
                jshapes, SimpleNamespace(shape=ms), fsdp=fsdp))
            got = _port_by_path(tshapes, param_specs(tshapes, _mesh(ms),
                                                     fsdp=fsdp))
            assert set(want) == set(got)
            assert all(got[p] == want[p] for p in want), (ms, fsdp)
    # fsdp_min_size reaches reduced leaves (the distributed test's specs)
    ms = MESHES["4x2"]
    for path, x in zip(leaf_paths(tshapes), leaves(tshapes)):
        assert spec_for_leaf(path, x.shape, ms, fsdp=True,
                             fsdp_min_size=1) == jrules.spec_for_leaf(
            path, tuple(x.shape), ms, fsdp=True, fsdp_min_size=1)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_batch_and_cache_specs_equal_reference(arch):
    model = tbuild(tget(arch))
    batches = {"tokens": torch.empty((8, 128), device="meta"),
               "labels": torch.empty((8, 128), device="meta"),
               "odd": torch.empty((3, 16, 5), device="meta"),
               "scalar": torch.empty((), device="meta")}
    for ms in MESHES.values():
        mesh = SimpleNamespace(shape=ms)
        got = batch_spec(batches, _mesh(ms))
        want = jrules.batch_spec(_abstract(batches), mesh)
        assert got == dict(want)
        for B in (8, 1):
            cache = model.init_cache(B, 256, device="meta")
            want = _jax_by_path(jrules.cache_specs(_abstract(cache), mesh, B))
            got = _port_by_path(cache, cache_specs(cache, _mesh(ms), B))
            assert got == want, (ms, B)


def test_cache_specs_long_context_and_divisibility():
    # tests/test_substrates.py's long-context cache, on its host mesh and
    # on the production shapes: batch 1 shards the sequence instead
    tree = {"k": torch.empty((16, 1, 4096, 8, 128), device="meta"),
            "t": torch.empty((), dtype=torch.int32, device="meta")}
    for ms in MESHES.values():
        got = cache_specs(tree, _mesh(ms), batch_size=1)
        want = jrules.cache_specs(_abstract(tree), SimpleNamespace(shape=ms),
                                  batch_size=1)
        assert got == want
        assert got["t"] == Spec()
    assert cache_specs(tree, _mesh(MESHES["16x16"]), 1)["k"] == \
        (None, None, ("data", "model"), None, None)
    for dim, axes in itertools.product((1, 2, 6, 16, 48, 92553),
                                       ("data", ("pod", "data"), "x")):
        for ms in MESHES.values():
            assert divisible(dim, axes, ms) == jrules.divisible(dim, axes,
                                                                ms)


def test_clean_spec_drops_missing_and_non_dividing_axes():
    spec = (("pod", "data"), "model", None, "expert")
    for ms, shape in itertools.product(
            MESHES.values(), [(8, 6, 5, 4), (3, 16, 2, 1), (32, 32, 1, 8),
                              (2, 1, 7, 3)]):
        got = _clean_spec(_mesh(ms), spec, shape)
        want = jctx._clean_spec(SimpleNamespace(shape=ms), spec, shape)
        assert got == want and isinstance(got, Spec), (ms, shape, got)
    assert _clean_spec(_mesh(MESHES["4x2"]), spec, (8, 6, 5, 4)) == \
        ("data", "model", None, None)
    assert _clean_spec(_mesh(MESHES["4x2"]), spec, (6, 3, 5, 4)) == \
        (None, None, None, None)


# ---------------------------------------------------------------------------
# mesh context, shard_act, placements
# ---------------------------------------------------------------------------


def test_mesh_context_nests_and_axis_size_reads_it():
    outer, inner = _mesh(MESHES["4x2"]), _mesh(MESHES["2x16x16"])
    assert current_mesh() is None and axis_size("data") == 1
    with mesh_context(outer) as m:
        assert m is outer and current_mesh() is outer
        assert (axis_size("data"), axis_size("model"),
                axis_size("pod")) == (4, 2, 1)
        with mesh_context(inner):
            assert (axis_size("pod"), axis_size("data")) == (2, 16)
            with mesh_context(None):
                assert current_mesh() is None and axis_size("data") == 1
            assert current_mesh() is inner
        assert current_mesh() is outer
        with pytest.raises(RuntimeError):
            with mesh_context(inner):
                raise RuntimeError
        assert current_mesh() is outer
    assert current_mesh() is None
    # an ExpertMesh reads as its one axis
    with mesh_context(tmesh.ExpertMesh(("cpu",) * 3)):
        assert axis_size("expert") == 3 and axis_size("data") == 1


def test_shard_act_is_a_no_op_on_plain_tensors():
    x = torch.randn(8, 4, 6)
    assert shard_act(x, (("pod", "data"), None, "model")) is x
    with mesh_context(_mesh(MESHES["4x2"])):
        assert shard_act(x, (("pod", "data"), None, "model")) is x
        assert shard_act(x, (("pod", "data"), None)) is x


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    assert placements(Spec(("pod", "data"), None),
                      _mesh(MESHES["2x16x16"])) == \
        (Shard(0), Shard(0), Replicate())
    assert placements(Spec(("pod", "data"), None), _mesh(MESHES["4x2"])) \
        == (Shard(0), Replicate())
    assert placements(Spec(None, "model", "data"), _mesh(MESHES["4x2"])) \
        == (Shard(2), Shard(1))
    assert placements(Spec(), _mesh(MESHES["4x2"])) == \
        (Replicate(), Replicate())


# ---------------------------------------------------------------------------
# meshes and a sharded step on the one-rank host mesh
# ---------------------------------------------------------------------------


def test_production_mesh_names_the_ranks_it_needs():
    assert tmesh.mesh_devices_required(False) == 256
    assert tmesh.mesh_devices_required(True) == 512
    for multi in (False, True):
        with pytest.raises(ValueError, match="mesh_devices_required"):
            tmesh.make_production_mesh(multi_pod=multi, device="cpu")


def test_host_mesh_sharded_step_equals_the_plain_step():
    assert not dist.is_initialized()
    cfg = tget("llama3.2-1b").reduced(n_layers=2, d_model=64, n_heads=4,
                                      n_kv_heads=2, d_ff=128,
                                      vocab_size=256)
    model = tbuild(cfg)
    state = init_train_state(model, 0, device="cpu")
    tokens = torch.randint(0, 256, (8, 32),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    step = make_train_step(model, lr_fn=constant_lr(1e-3), clip_norm=1.0,
                           microbatches=2)
    want, wmet = step(state, batch)
    mesh = tmesh.make_host_mesh("cpu")
    try:
        assert dist.get_world_size() == 1
        assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == \
            {"data": 1, "model": 1}
        with mesh_context(mesh):
            sst = shard_train_state(state, mesh, fsdp=True)
            got, gmet = step(sst, shard_batch(batch, mesh))
        assert float(gmet["loss"].full_tensor()) == float(wmet["loss"])
        for a, b, w in zip(leaves(got), leaves(sst), leaves(want)):
            assert tuple(a.placements) == tuple(b.placements)
            torch.testing.assert_close(a.full_tensor(), w, rtol=0,
                                       atol=5e-7)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the MoE's mesh-grouped dispatch
# ---------------------------------------------------------------------------


def _data4(monkeypatch):
    four = lambda name: 4 if name == "data" else 1  # noqa: E731
    monkeypatch.setattr(jmoe, "axis_size", four)
    monkeypatch.setattr(tmoe, "axis_size", four)


def _dispatch_pair(factor, T, grouped, monkeypatch):
    cfg = get_config("olmoe_1b_7b").reduced(moe_capacity_factor=factor)
    tcfg = tget("olmoe_1b_7b").reduced(moe_capacity_factor=factor)
    jp = jax.device_get(jmoe.init_moe(jax.random.PRNGKey(0), cfg,
                                      jnp.float32))
    tp = to_torch(jp, device="cpu")
    x = np.random.default_rng(1).standard_normal(
        (T, cfg.d_model)).astype(np.float32)
    jw, jids, _ = jmoe._route(jp, jnp.asarray(x), cfg)
    tw, tids, _ = tmoe._route(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    with monkeypatch.context() as mp:
        if grouped:
            _data4(mp)
        want = jmoe._moe_dispatch(jp, jnp.asarray(x), jw, jids, cfg)
        got = tmoe._moe_dispatch(tp, torch.from_numpy(x), tw, tids, tcfg)
    return got, np.asarray(want), (tcfg, tids)


@pytest.mark.parametrize("factor", [0.5, 1.25])
def test_grouped_dispatch_equals_reference(factor, monkeypatch):
    T = 64
    got, want, (tcfg, tids) = _dispatch_pair(factor, T, True, monkeypatch)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # capacity is per group: 4 groups of 16 tokens
    Tg = T // 4
    cap = tmoe.capacity(tcfg, Tg, False)
    xs = torch.zeros(4, Tg, tcfg.d_model)
    _, _, keep = tmoe._scatter_groups(
        xs, tids.reshape(4, Tg, -1), tcfg.n_experts, cap)
    one, one_want, _ = _dispatch_pair(factor, T, False, monkeypatch)
    np.testing.assert_allclose(one.numpy(), one_want, rtol=2e-5, atol=2e-5)
    if factor < 1:
        assert not keep.all()
        assert not np.allclose(got.numpy(), one.numpy(), atol=1e-3)
    # moe_ffn end to end, with the balance loss
    cfg = get_config("olmoe_1b_7b").reduced(moe_capacity_factor=factor)
    jp = jax.device_get(jmoe.init_moe(jax.random.PRNGKey(0), cfg,
                                      jnp.float32))
    x = np.random.default_rng(2).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    with monkeypatch.context() as mp:
        _data4(mp)
        jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), cfg)
        ty, taux = tmoe.moe_ffn(to_torch(jp, device="cpu"),
                                torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=2e-5)


def test_grouped_dispatch_falls_back_to_one_group(monkeypatch):
    # T = 30: 4 does not divide it, so both packages use one group
    got, want, _ = _dispatch_pair(0.5, 30, True, monkeypatch)
    one, _, _ = _dispatch_pair(0.5, 30, False, monkeypatch)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    assert torch.equal(got, one)


@pytest.mark.parametrize("grouped", [False, True])
def test_one_group_dispatch_builds_no_group_offsets(grouped, monkeypatch):
    # a serving dispatch (G = 1) launches what a single group needs: the
    # per-group row offsets (an arange, a mul and an add in the scatter
    # and again in the combine) only appear with G > 1
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, fn, types, args=(), kwargs=None):
            self.ops.append(fn.__name__.split(".")[0])
            return fn(*args, **(kwargs or {}))

    cfg = tget("olmoe_1b_7b").reduced(moe_capacity_factor=0.5)
    gen = torch.Generator().manual_seed(0)
    params = {k: v[0] for k, v in tmoe.init_moe(gen, cfg, torch.float32,
                                                1).items()}
    x = torch.randn(64, cfg.d_model, generator=gen)
    w, ids, _ = tmoe._route(params, x, cfg)
    with monkeypatch.context() as mp:
        if grouped:
            _data4(mp)
        with Record() as rec:
            tmoe._moe_dispatch(params, x, w, ids, cfg)
    assert rec.ops.count("arange") == (2 if grouped else 0), rec.ops
