"""The port's expert hub and npz expert store against the reference's, on
the CPU.

Every case of the reference's ``tests/test_hub.py`` (none needs a mesh)
runs on the port: the lifecycle state machine, pins, eviction gated by
active waves, popularity-weighted eviction, paged slot recycling, warmup,
pool exhaustion unwinding pins, staging failures, the host cache, the
store's name check, wiring guards and the worker's lifecycle. Then the
port against JAX on the same weights (``smollm_135m`` reduced, made by
JAX from a seed and bridged with ``bridge.to_torch``): the store read and
written across packages bit for bit; a 2-slot hub over a catalog of 6 on
Zipf traffic, ring and paged, with equal tokens, equal ``loads`` /
``evictions`` / ``resident_misses`` and the same victim at each eviction
(host-staged experts: no worker, so deterministic), and with a cold store
(equal tokens and the conservation laws); the reference's race analyzer
over the port's hub, scheduler and kvcache. Every test that starts a
staging worker joins it. The ``cuda`` cases (skipped without a card)
install experts under captured graphs and stage one during a capture.
"""
import collections
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro.checkpoint import load_expert as jload_expert
from repro.checkpoint import save_expert as jsave_expert
from repro.configs import get_config
from repro.models import build_model
from repro.serve import ExpertHub as JHub
from repro.serve import Request as JRequest
from repro.serve import RoutedServer as JServer
from repro_torch import core as tcore
from repro_torch import serve as tserve
from repro_torch.bridge import to_torch
from repro_torch.checkpoint import list_experts, load_expert, save_expert
from repro_torch.configs import get_config as tget
from repro_torch.models import build_model as tbuild
from repro_torch.models.api import BaseModel
from repro_torch.serve import (ExpertEngine, ExpertHub, NotResident,
                               Request, RoutedServer, Scheduler,
                               plan_placement)
from repro_torch.tree import leaves

MAX_LEN = 32


@pytest.fixture(scope="module")
def models():
    jmod = build_model(get_config("smollm_135m").reduced(name="hub-t"))
    tmod = tbuild(tget("smollm_135m").reduced(name="hub-t"))
    return jmod, tmod


@pytest.fixture(scope="module")
def jparams6(models):
    """Six experts' weights, made by JAX (numpy)."""
    return [jax.device_get(models[0].init(jax.random.PRNGKey(s)))
            for s in range(6)]


@pytest.fixture(scope="module")
def model(models):
    return models[1]


@pytest.fixture(scope="module")
def params4(jparams6):
    return [to_torch(p, device="cpu") for p in jparams6[:4]]


@pytest.fixture(autouse=True)
def workers_joined():
    """Every test that starts a staging worker joins it (workers alive
    before the test, another module's, are not this test's)."""
    before = {t.ident for t in threading.enumerate()}
    yield
    alive = [t for t in threading.enumerate()
             if t.name == "hub-stage" and t.is_alive()
             and t.ident not in before]
    assert not alive, f"staging worker(s) left running: {alive}"


def _mk_hub(model, params, n_slots, **kw):
    hub = ExpertHub(model, n_slots=n_slots, max_len=MAX_LEN, device="cpu",
                    **kw)
    for i, p in enumerate(params):
        hub.add_expert(f"ex{i}", p)
    return hub


def _server(hub, **kw):
    return RoutedServer(None, hub.build_registry(), max_batch=4, hub=hub,
                        device="cpu", **kw)


def _engine(model, params, **kw):
    return ExpertEngine(model, params, max_len=MAX_LEN, device="cpu", **kw)


def _reqs(rng, n, n_experts, max_len=28):
    return [Request(uid=u, features=np.zeros(784, np.float32),
                    prompt=rng.integers(0, 50,
                                        size=int(rng.integers(3, max_len))),
                    max_new_tokens=int(rng.integers(1, 5)),
                    expert=int(rng.integers(n_experts)))
            for u in range(n)]


def _equal_trees(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.uint8) if x.dtype == torch.bfloat16
                           else x, y.view(torch.uint8)
                           if y.dtype == torch.bfloat16 else y)


# -- checkpoint store ---------------------------------------------------------


def test_expert_store_roundtrip(tmp_path, params4):
    root = str(tmp_path / "store")
    save_expert(root, "alpha", params4[0], meta={"arch": "smollm"})
    save_expert(root, "beta", params4[1])
    assert list_experts(root) == ["alpha", "beta"]
    _equal_trees(load_expert(root, "alpha"), params4[0])


def _bf16_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": jnp.asarray(rng.standard_normal((5, 7)), jnp.bfloat16),
            "layers": {"b": jnp.asarray(rng.standard_normal(3), jnp.float32),
                       "i": jnp.arange(4, dtype=jnp.int32)},
            "list": [jnp.asarray(rng.standard_normal(2), jnp.bfloat16)]}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_reads_across_packages_bit_equal(tmp_path, writer):
    """A store written by either package reads in the other, every leaf
    bit-equal (bf16 through its uint16 view) and shards split as the
    reference splits them."""
    root = str(tmp_path / "store")
    tree = jax.device_get(_bf16_tree(3))
    if writer == "jax":
        jsave_expert(root, "x", tree, shard_bytes=64)
        got = load_expert(root, "x")
        want = to_torch(tree, device="cpu")
        _equal_trees(got, want)
        assert isinstance(got["list"], list)
    else:
        save_expert(root, "x", to_torch(tree, device="cpu"), shard_bytes=64)
        got = jload_expert(root, "x")
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(tree)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                          np.asarray(b).view(np.uint8))
    assert len(list((tmp_path / "store" / "x").glob("shard*.npz"))) > 1
    with open(tmp_path / "store" / "x" / "index.json") as f:
        assert '"dtype": "bfloat16"' in f.read()


def test_store_rejects_unsafe_expert_names(tmp_path, params4):
    root = str(tmp_path / "store")
    for bad in ("a/b", "..", ".hidden", "", "a b"):
        with pytest.raises(ValueError, match="safe store"):
            save_expert(root, bad, params4[0])
    save_expert(root, "ok-name_1.0@v2+x", params4[0])  # all allowed


# -- shared catalog entry type ------------------------------------------------


def test_expert_spec_is_the_shared_catalog_type(model, params4):
    """Placement grouping, hub slot compatibility and registry entries
    all read one ExpertSpec; the planner publishes it on the entry, and
    ``param_shapes`` builds nothing."""
    e0 = ExpertEngine(model, params4[0], max_len=64, device="cpu")
    e1 = ExpertEngine(model, params4[1], max_len=64, device="cpu")
    e2 = ExpertEngine(model, params4[2], max_len=32, device="cpu")
    s0, s1, s2 = (e.spec for e in (e0, e1, e2))
    assert s0 == s1 and hash(s0) == hash(s1)
    assert s0 != s2
    assert s0.bankable
    reg = tcore.ExpertRegistry()
    reg.add("a", e0)
    reg.add("b", e1)
    plan = plan_placement(reg)
    assert reg[0].spec == reg[1].spec == s0
    assert len([s for s in plan.shards if s.banked]) == 1
    hub = ExpertHub(model, n_slots=2, max_len=64, device="cpu")
    assert hub.spec == s0
    hub.add_expert("c", params4[0])
    assert hub.build_registry()[0].spec == s0
    shapes = model.param_shapes()
    assert all(t.device.type == "meta" for t in leaves(shapes))
    assert [(t.shape, t.dtype) for t in leaves(shapes)] == \
        [(t.shape, t.dtype) for t in leaves(params4[0])]


def test_dispatch_moe_spec_not_bankable():
    cfg = tget("mixtral_8x22b").reduced(name="moe-spec")
    assert cfg.n_experts and cfg.moe_impl == "dispatch"
    spec = tcore.ExpertSpec(arch=cfg.replace(name=""), max_len=64,
                            len_buckets=(8, 64), batch_buckets=(1, 16))
    assert not spec.bankable
    # the port builds no MoE family yet (A10): the hub refuses the arch
    # before it builds anything
    with pytest.raises(ValueError, match="slot bank"):
        ExpertHub(BaseModel(cfg), n_slots=2, max_len=64, device="cpu")


# -- lifecycle state machine --------------------------------------------------


def test_hub_lifecycle_cold_to_resident_to_evicted(tmp_path, model,
                                                   params4):
    store = str(tmp_path / "store")
    with ExpertHub(model, n_slots=1, max_len=MAX_LEN, store=store,
                   device="cpu") as hub:
        e0 = hub.add_expert("cold0", params4[0], cold=True)
        e1 = hub.add_expert("cold1", params4[1], cold=True)
        assert [hub.catalog[e].state for e in (e0, e1)] == ["cold", "cold"]
        assert list_experts(store) == ["cold0", "cold1"]
        with pytest.raises(NotResident):
            hub.acquire(e0)
        assert hub.has_wanted and hub.stats.resident_misses == 1
        while hub.has_wanted:
            hub.service(block=True)
        assert hub.catalog[e0].state == "resident"
        assert hub.acquire(e0) == 0 and hub.slot_of(e0) == 0
        assert hub.stats.loads == 1 and hub.stats.stage_count == 1
        _equal_trees(hub.bank.params[0], params4[0])
        with pytest.raises(NotResident):
            hub.acquire(e1)
        while hub.has_wanted:
            hub.service(block=True)
        assert hub.catalog[e1].state == "resident"
        assert hub.catalog[e0].state == "staged"   # host copy retained
        assert hub.stats.evictions == 1
        _equal_trees(hub.bank.params[0], params4[1])
        with pytest.raises(NotResident):
            hub.acquire(e0)
        while hub.has_wanted:
            hub.service(block=True)
        assert hub.stats.stage_count == 2          # e0+e1 staged once each
        assert hub.stats.stage_cache_hits == 1
        hub.check()


def test_slots_own_their_tensors_and_installs_write_in_place(model,
                                                              params4):
    """Each slot has tensors of its own (installing slot 0 leaves slot 1
    alone), and an install writes into the slot's tensors: the addresses
    a captured step reads never change."""
    hub = _mk_hub(model, params4[:3], 2)
    ptrs = [[t.data_ptr() for t in leaves(p)] for p in hub.bank.params]
    assert not set(ptrs[0]) & set(ptrs[1])
    for e in (0, 1):
        hub.want(e)
    hub.service()
    _equal_trees(hub.bank.params[0], params4[0])
    _equal_trees(hub.bank.params[1], params4[1])
    hub.want(2)
    assert hub.service() == 1 and hub.stats.evictions == 1
    slot = hub.slot_of(2)
    _equal_trees(hub.bank.params[slot], params4[2])
    _equal_trees(hub.bank.params[1 - slot], params4[1 - slot])
    assert [[t.data_ptr() for t in leaves(p)]
            for p in hub.bank.params] == ptrs
    assert hub.stats.commit_bytes == 3 * sum(
        t.numel() * t.element_size() for t in leaves(params4[0]))


def test_pinned_expert_is_not_evictable(model, params4):
    hub = _mk_hub(model, params4[:2], 1)
    hub.want(0)
    hub.service(block=True)
    hub.pin(0, 2)
    hub.want(1)
    assert hub.service(block=True) == 0        # slot pinned: no commit
    assert hub.catalog[1].state != "resident"
    hub.unpin(0)
    assert hub.service() == 0                  # still one pin left
    hub.unpin(0)
    assert hub.service() == 1                  # now evictable
    assert hub.catalog[1].state == "resident"
    assert hub.catalog[0].state == "staged"
    with pytest.raises(ValueError, match="unpin below zero"):
        hub.unpin(0)
    with pytest.raises(ValueError, match="non-resident"):
        hub.pin(0)
    hub.check()


@pytest.mark.parametrize("spec", [False, True])
def test_active_wave_blocks_eviction_even_when_pin_free(model, params4,
                                                        spec):
    """A row's pin drops at harvest, but its wave (and pages) lives until
    every row retires: the hub must not recycle a slot an active wave
    still references — a speculative wave's row map counts the same."""
    hub = _mk_hub(model, params4[:2], 1, kv_layout="paged")
    if spec:
        # the hub's bank never speculates; a spec wave on a bank shaped
        # as the hub's carries the same row map
        hub.bank.core.speculate_k = 2
        hub.bank.core.draft = tserve.build_draft("table",
                                                 model.cfg.padded_vocab)
        hub.bank.core.draft_name = "table"
        hub.bank.core.draft_state = [hub.bank.core.draft.init_state(
            torch.Generator().manual_seed(0), 1)]
    hub.want(0)
    hub.service(block=True)
    rng = np.random.default_rng(0)
    hub.bank.admit({0: ([("t", 1), ("t", 2)],
                        [rng.integers(0, 50, 9), rng.integers(0, 50, 9)],
                        [1, 4])}, defer=True)
    assert hub.bank.core._active[0].spec == spec
    hub.want(1)
    assert hub.service() == 0, "evicted a slot with an active wave"
    assert hub.catalog[0].state == "resident"
    while hub.bank.n_active:
        hub.bank.tick()
    hub.bank.poll()
    assert hub.service() == 1                  # wave retired: evictable
    assert hub.catalog[1].state == "resident"
    hub.bank.core.pool.check()
    hub.check()


# -- serving integration ------------------------------------------------------


def test_hub_token_identical_to_resident_and_per_engine(model, params4):
    """A 2-slot hub over 4 experts serves the same tokens as a fully
    resident 4-slot hub and the plain per-engine path, with evictions
    and stalls happening."""
    rng = np.random.default_rng(7)
    reqs = _reqs(rng, 20, 4)
    hub_small = _mk_hub(model, params4, 2)
    srv_small = _server(hub_small)
    hub_full = _mk_hub(model, params4, 4)
    srv_full = _server(hub_full)
    reg = tcore.ExpertRegistry()
    for i, p in enumerate(params4):
        reg.add(f"ex{i}", _engine(model, p))
    sched = Scheduler(None, reg)       # router-less per-engine path
    got_small = srv_small.serve(reqs)
    got_full = srv_full.serve(reqs)
    sched.submit(reqs)
    got_eng = {r.uid: r for r in sched.drain()}
    for a, b in zip(got_small, got_full):
        assert a.uid == b.uid and a.expert == b.expert
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=str(a.uid))
        c = got_eng[a.uid]
        assert c.expert == a.expert
        np.testing.assert_array_equal(a.tokens, c.tokens, err_msg=str(a.uid))
    assert hub_small.stats.evictions > 0
    assert hub_full.stats.evictions == 0
    assert srv_small.scheduler.stats.resident_stalls > 0
    assert all(c.pins == 0 for c in hub_small.catalog)
    hub_small.check()
    st = srv_small.stats
    assert "hub" in st and st["hub"].loads >= 2
    assert srv_small.snapshot()["hub"]["loads"] == st["hub"].loads


def test_cold_start_parks_then_serves(tmp_path, model, params4):
    store = str(tmp_path / "store")
    hub = ExpertHub(model, n_slots=1, max_len=MAX_LEN, store=store,
                    device="cpu")
    for i, p in enumerate(params4[:2]):
        hub.add_expert(f"ex{i}", p, cold=True)
    with _server(hub) as srv:
        rng = np.random.default_rng(3)
        prompt = rng.integers(0, 50, size=10)
        [r] = srv.serve([Request(uid=0, features=np.zeros(784, np.float32),
                                 prompt=prompt, max_new_tokens=4, expert=1)])
    assert r.expert == "ex1" and r.tokens.shape == (4,)
    assert srv.scheduler.stats.resident_stalls >= 1
    assert hub.stats.stage_count >= 1
    ref = _engine(model, params4[1])
    np.testing.assert_array_equal(r.tokens,
                                  ref.generate(prompt[None, :], 4)[0])


def test_popularity_keeps_hot_expert_resident(model, params4):
    hub = _mk_hub(model, params4, 2)
    srv = _server(hub)
    rng = np.random.default_rng(11)
    uid = 0
    for rnd in range(6):
        batch = [Request(uid=uid + k, features=np.zeros(784, np.float32),
                         prompt=rng.integers(0, 50, size=8),
                         max_new_tokens=2,
                         expert=0 if k < 3 else 1 + (rnd + k) % 3)
                 for k in range(4)]
        uid += 4
        srv.serve(batch)
        assert 0 in hub.resident_experts, \
            f"hot expert evicted in round {rnd}"
    assert hub.stats.evictions > 0
    hub.check()


def test_paged_slot_recycle_invalidates_prefix_cache(model, params4):
    hub = _mk_hub(model, params4[:2], 1, kv_layout="paged")
    srv = _server(hub)
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 50, size=16)
    mk = lambda uid, e: Request(uid=uid,
                                features=np.zeros(784, np.float32),
                                prompt=shared, max_new_tokens=3, expert=e)
    srv.serve([mk(0, 0), mk(1, 0)])            # populates prefix cache
    cache = hub.bank.core.prefix_cache
    n_stale, drops0 = len(cache), cache.stats["evictions"]
    assert n_stale > 0
    [r2] = srv.serve([mk(2, 1)])
    assert hub.stats.evictions == 1
    assert cache.stats["evictions"] >= drops0 + n_stale, \
        "stale prefixes survived the slot recycle"
    ref1 = _engine(model, params4[1], kv_layout="paged")
    np.testing.assert_array_equal(
        r2.tokens, ref1.generate(shared[None, :], 3)[0])
    [r3] = srv.serve([mk(3, 0)])               # ex0 returns to the slot
    ref0 = _engine(model, params4[0], kv_layout="paged")
    np.testing.assert_array_equal(
        r3.tokens, ref0.generate(shared[None, :], 3)[0])
    hub.bank.core.pool.check()
    hub.check()


def test_hub_warmup_prevents_steady_state_compiles(model, params4):
    """Warmup runs every (length, batch) bucket up to ``max_batch`` and
    steps each decode bucket three times: afterwards traffic through any
    experts adds no decode step object and no prefill shape."""
    hub = _mk_hub(model, params4, 2)
    srv = _server(hub)
    hub.warmup(max_batch=4)
    jit0 = hub.bank.stats.jit_cache_entries
    graphs0 = hub.bank.stats.decode_compiles
    assert graphs0 == 3 and jit0 > graphs0   # buckets 1, 2, 4
    assert sorted(hub.resident_experts) == [0, 1]
    rng = np.random.default_rng(13)
    srv.serve(_reqs(rng, 16, 4))
    assert hub.stats.evictions > 0
    assert hub.bank.stats.jit_cache_entries == jit0
    assert hub.bank.stats.decode_compiles == graphs0
    assert srv.scheduler.stats.orphaned == 0, \
        "warmup leaked rows into the scheduler's poll stream"


def test_hub_pool_too_small_unwinds_pins_and_rows(model, params4):
    hub = _mk_hub(model, params4[:2], 1, kv_layout="paged", pool_pages=2)
    hub.want(0)
    hub.service(block=True)
    srv = _server(hub)
    srv.submit([Request(uid=0, features=np.zeros(784, np.float32),
                        prompt=np.arange(30, dtype=np.int32),
                        max_new_tokens=3, expert=0)])
    with pytest.raises(Exception, match="pages"):
        srv.scheduler.drain()
    assert all(c.pins == 0 for c in hub.catalog), "leaked pins"
    assert srv.scheduler.n_queued == 1          # row requeued, not lost
    hub.check()


def test_staging_failure_is_loud_but_retryable(tmp_path, model, params4):
    store = str(tmp_path / "store")
    with ExpertHub(model, n_slots=1, max_len=MAX_LEN, store=store,
                   device="cpu") as hub:
        e = hub.add_expert("frail", params4[0], cold=True)
        shutil.rmtree(store)                      # corrupt the cold tier
        with pytest.raises(NotResident):
            hub.acquire(e)
        with pytest.raises(Exception):
            while hub.has_wanted:
                hub.service(block=True)
        assert hub.catalog[e].state == "cold"     # not wedged in staging
        assert not hub.has_wanted
        save_expert(store, "frail", params4[0])
        with pytest.raises(NotResident):
            hub.acquire(e)
        while hub.has_wanted:
            hub.service(block=True)
        assert hub.catalog[e].state == "resident"
        hub.check()


def test_staging_failure_still_trims_host_cache(tmp_path, model, params4):
    store = str(tmp_path / "store")
    with ExpertHub(model, n_slots=1, max_len=MAX_LEN, store=store,
                   device="cpu") as hub:
        e0 = hub.add_expert("ex0", params4[0], cold=True)
        e1 = hub.add_expert("ex1", params4[1], cold=True)
        e2 = hub.add_expert("ex2", params4[2], cold=True)
        for e in (e0, e1):
            with pytest.raises(NotResident):
                hub.acquire(e)
            while hub.has_wanted:
                hub.service(block=True)
        assert hub.catalog[e0].state == "staged"
        assert hub.catalog[e0].params is not None
        hub.host_cache = 0
        shutil.rmtree(store)
        with pytest.raises(NotResident):
            hub.acquire(e2)
        with pytest.raises(Exception):
            while hub.has_wanted:
                hub.service(block=True)
        assert hub.catalog[e0].state == "cold"
        assert hub.catalog[e0].params is None
        assert hub.catalog[e2].state == "cold"
        assert not hub.has_wanted and not hub._staging
        assert all(c.pins == 0 for c in hub.catalog)
        for i, name in enumerate(("ex0", "ex1", "ex2")):
            save_expert(store, name, params4[i])
        with pytest.raises(NotResident):
            hub.acquire(e2)
        while hub.has_wanted:
            hub.service(block=True)
        assert hub.catalog[e2].state == "resident"
        hub.check()


def test_host_cache_bounds_staged_copies(tmp_path, model, params4):
    store = str(tmp_path / "store")
    hub = ExpertHub(model, n_slots=1, max_len=MAX_LEN, store=store,
                    host_cache=1, device="cpu")
    for i, p in enumerate(params4):
        hub.add_expert(f"ex{i}", p, cold=True)
    with _server(hub) as srv:
        rng = np.random.default_rng(17)
        for uid, e in enumerate([0, 1, 2, 3]):
            srv.serve([Request(uid=uid, features=np.zeros(784, np.float32),
                               prompt=rng.integers(0, 50, size=8),
                               max_new_tokens=2, expert=e)])
        held = [c for c in hub.catalog
                if c.state == "staged" and c.params is not None]
        assert len(held) <= 1, [c.name for c in held]
        [r] = srv.serve([Request(uid=99, features=np.zeros(784, np.float32),
                                 prompt=rng.integers(0, 50, size=8),
                                 max_new_tokens=2, expert=0)])
        assert r.expert == "ex0"
        hub.check()


# -- wiring guards ------------------------------------------------------------


def test_hub_wiring_guards(model, params4):
    hub = _mk_hub(model, params4[:2], 1)
    reg = hub.build_registry()
    with pytest.raises(ValueError, match="matcher=None requires a hub"):
        RoutedServer(None, tcore.ExpertRegistry(), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        other = tcore.ExpertRegistry()
        other.add("only-one", None)
        Scheduler(None, other, hub=hub)
    with pytest.raises(ValueError, match="HubMember"):
        foreign = tcore.ExpertRegistry()
        for i in range(len(hub)):
            foreign.add(f"f{i}", None)
        Scheduler(None, foreign, hub=hub)
    with pytest.raises(ValueError, match="exclusive"):
        Scheduler(None, reg, hub=hub,
                  placement=tserve.PlacementPlan([], {}))
    with pytest.raises(ValueError, match="pre-routed"):
        srv = _server(hub)
        srv.submit([Request(uid=0, features=np.zeros(784, np.float32),
                            prompt=np.arange(4), max_new_tokens=1)])
    with pytest.raises(ValueError, match="out of range"):
        srv = _server(hub)
        srv.submit([Request(uid=1, features=np.zeros(784, np.float32),
                            prompt=np.arange(4), max_new_tokens=1,
                            expert=7)])
    with pytest.raises(ValueError, match="already in the catalog"):
        hub.add_expert("ex0", params4[0])
    with pytest.raises(ValueError, match="no params and no checkpoint"):
        ExpertHub(model, n_slots=1, max_len=MAX_LEN,
                  device="cpu").add_expert("ghost")
    with pytest.raises(ValueError, match="n_slots"):
        ExpertHub(model, n_slots=0, max_len=MAX_LEN, device="cpu")
    wrong = dict(params4[0], ln_f=torch.ones(3))
    bad = _mk_hub(model, [wrong], 1)
    bad.want(0)
    with pytest.raises(ValueError, match="does not fit"):
        bad.service()


# -- worker lifecycle / thread hygiene ----------------------------------------


@pytest.fixture(autouse=True, scope="module")
def no_dangling_nondaemon_threads():
    before = {t.ident for t in threading.enumerate()}
    yield
    leaked = [t for t in threading.enumerate()
              if t.ident not in before and t.is_alive() and not t.daemon]
    assert leaked == [], f"non-daemon threads leaked: {leaked}"


def test_hub_close_joins_worker_and_is_idempotent(tmp_path, model, params4):
    root = str(tmp_path / "store")
    for i, p in enumerate(params4):
        save_expert(root, f"ex{i}", p)
    hub = ExpertHub(model, n_slots=2, max_len=MAX_LEN, store=root,
                    device="cpu")
    assert hub.add_from_store() == [0, 1, 2, 3]
    hub.want(2)
    hub.service(block=True)
    assert hub.expert_in(hub.slot_of(2)) == 2
    worker = hub._stage_thread
    assert worker is not None and worker.is_alive()
    assert worker.name == "hub-stage"
    hub.close()
    assert not worker.is_alive(), "close() returned with the worker alive"
    hub.close()                                        # idempotent
    assert hub._stage_thread is None
    assert hub.acquire(2) == hub.slot_of(2)
    hub.want(3)
    with pytest.raises(RuntimeError, match="closed"):
        hub.service(block=True)


def test_hub_context_manager_closes(tmp_path, model, params4):
    root = str(tmp_path / "store")
    for i, p in enumerate(params4):
        save_expert(root, f"ex{i}", p)
    with ExpertHub(model, n_slots=2, max_len=MAX_LEN, store=root,
                   device="cpu") as hub:
        hub.add_from_store()
        hub.want(0)
        hub.service(block=True)
        worker = hub._stage_thread
        assert worker is not None and worker.is_alive()
    assert hub._closed and not worker.is_alive()


def test_popularity_counter_reads_under_hub_lock(model, params4):
    """Once bind_popularity shares the router's Counter, the router's
    increments take the hub lock, and note_hit mutates that Counter."""
    hub = _mk_hub(model, params4, n_slots=2)
    try:
        from repro_torch.serve.router import Router

        class _Stub(Router):
            def __init__(self):
                self.expert_hits = collections.Counter()
                self.hits_lock = None

        router = _Stub()
        hub.bind_popularity(router.expert_hits, router=router)
        assert router.hits_lock is hub._lock
        assert hub.popularity is router.expert_hits
        hub.note_hit(1, 3)
        assert router.expert_hits[1] == 3
    finally:
        hub.close()


def test_race_analyzer_finds_no_violation_in_the_port():
    """The port's static lockset checker (R001-R004,
    ``repro_torch.analysis.races``) over the port's hub, scheduler and
    kvcache: the port keeps the threading contract its hub declares."""
    import pathlib
    from repro_torch.analysis.races import DEFAULT_UNIT, analyze_unit
    root = pathlib.Path(__file__).resolve().parents[1]
    unit = {rel: (root / rel).read_text() for rel in DEFAULT_UNIT}
    assert sorted(unit) == [f"src/repro_torch/serve/{n}.py"
                            for n in ("hub", "kvcache", "scheduler")]
    assert analyze_unit(unit) == []


# -- against the reference on Zipf traffic ------------------------------------


def _zipf_traffic(rng, n_experts, n):
    """A catalog sweep (each expert once), then Zipf(1.1) over expert
    rank; prompts of 3-27 tokens, 1-4 new tokens."""
    ranks = np.arange(1, n_experts + 1, dtype=np.float64)
    p = ranks ** -1.1
    experts = list(range(n_experts)) + list(
        rng.choice(n_experts, size=n - n_experts, p=p / p.sum()))
    return [(u, rng.integers(0, 50, size=int(rng.integers(3, 28))),
             int(rng.integers(1, 5)), int(e)) for u, e in enumerate(experts)]


def _victims(hub):
    """Record each eviction's victim on the hub instance."""
    out, evict = [], hub._evict_locked

    def wrapped(e):
        out.append(e)
        return evict(e)
    hub._evict_locked = wrapped
    return out


def _serve_pair(jsrv, tsrv, traffic, chunk=6):
    want, got = [], []
    for lo in range(0, len(traffic), chunk):
        part = traffic[lo:lo + chunk]
        want += jsrv.serve([JRequest(u, np.zeros(784, np.float32), p, m,
                                     expert=e) for u, p, m, e in part])
        got += tsrv.serve([Request(u, np.zeros(784, np.float32), p, m,
                                   expert=e) for u, p, m, e in part])
    for g, w in zip(got, want):
        assert (g.uid, g.expert) == (w.uid, w.expert)
        np.testing.assert_array_equal(g.tokens, w.tokens, err_msg=str(g.uid))
    return got


@pytest.mark.parametrize("executor", ["serial", "overlapped"])
@pytest.mark.parametrize("kv", ["ring", "paged"])
def test_hub_matches_reference_on_zipf_traffic(models, jparams6, kv,
                                               executor):
    """Host-staged experts (no worker: deterministic): a 2-slot hub over
    6 experts in both packages gives equal tokens, equal loads /
    evictions / resident misses / stalls and the same victim at every
    eviction."""
    jmod, tmod = models
    jh = JHub(jmod, n_slots=2, max_len=MAX_LEN, kv_layout=kv)
    th = ExpertHub(tmod, n_slots=2, max_len=MAX_LEN, kv_layout=kv,
                   device="cpu")
    for i, p in enumerate(jparams6):
        jh.add_expert(f"ex{i}", p)
        th.add_expert(f"ex{i}", to_torch(p, device="cpu"))
    jv, tv = _victims(jh), _victims(th)
    jsrv = JServer(None, jh.build_registry(), max_batch=4, hub=jh,
                   executor=executor, check_every=1)
    tsrv = _server(th, executor=executor, check_every=1)
    _serve_pair(jsrv, tsrv, _zipf_traffic(np.random.default_rng(21), 6, 24))
    assert th.stats.evictions > 0
    for k in ("loads", "evictions", "resident_misses", "stage_cache_hits"):
        assert getattr(th.stats, k) == getattr(jh.stats, k), k
    assert tv == jv
    assert tsrv.scheduler.stats.resident_stalls == \
        jsrv.scheduler.stats.resident_stalls
    assert th.bank.stats.host_blocks == jh.bank.stats.host_blocks
    assert th.total_pins() == 0
    th.check()


@pytest.mark.parametrize("kv", ["ring", "paged"])
def test_cold_hub_matches_reference_on_zipf_traffic(tmp_path, models,
                                                    jparams6, kv):
    """Every expert saved ``cold`` into a store of each package's own and
    staged by the worker: tokens equal JAX's, and the conservation laws
    hold (every load a commit, every stage attempt published, no pin
    left)."""
    jmod, tmod = models
    jh = JHub(jmod, n_slots=2, max_len=MAX_LEN, kv_layout=kv,
              store=str(tmp_path / "jax"))
    th = ExpertHub(tmod, n_slots=2, max_len=MAX_LEN, kv_layout=kv,
                   store=str(tmp_path / "port"), device="cpu")
    for i, p in enumerate(jparams6):
        jh.add_expert(f"ex{i}", p, cold=True)
        th.add_expert(f"ex{i}", to_torch(p, device="cpu"), cold=True)
    jsrv = JServer(None, jh.build_registry(), max_batch=4, hub=jh)
    try:
        with _server(th, check_every=1) as tsrv:
            _serve_pair(jsrv, tsrv,
                        _zipf_traffic(np.random.default_rng(22), 6, 24))
    finally:
        jh.close()
    st = th.stats
    assert st.loads == st.commit_count >= 6 and st.evictions > 0
    assert st.stage_attempts == st.stage_count + st.stage_failures
    assert st.stage_failures == 0 and th.total_pins() == 0
    th.check()


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def _card_model():
    return tbuild(tget("llama3_2_1b").reduced(name="hub-card"))


def _card_traffic():
    rng = np.random.default_rng(9)
    return [Request(uid=u, features=np.zeros(784, np.float32),
                    prompt=rng.integers(0, 300, size=int(rng.integers(4, 20))),
                    max_new_tokens=6, expert=e)
            for u, e in enumerate([0, 0, 1, 2, 1, 0, 2, 2, 0, 1])]


def _eager(model, params, device, prompts, max_new):
    """One wave through an eager engine (no graph) on ``device``."""
    eng = ExpertEngine(model, {k: _to(v, device) for k, v in params.items()},
                       max_len=64, device=device, capture_decode=False)
    eng.admit(list(range(len(prompts))), prompts, [max_new] * len(prompts))
    out = {}
    while eng.has_pending:
        eng.tick()
        out.update(eng.poll())
    return out


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.cuda
def test_cuda_install_under_captured_graphs_replays_new_weights(cuda):
    """A 2-slot hub over 3 reduced f32 experts on the card: after warmup
    every decode bucket is captured, and the experts rotating through
    those slots give replayed tokens equal to an eager engine's on the
    card and to the CPU's, with no new capture however many installs
    follow and ``decode_attention`` counted 2 x n_layers a step."""
    from repro_torch.kernels import ops
    model = _card_model()
    cpu = [model.init(torch.Generator().manual_seed(s), device="cpu")
           for s in range(3)]
    hub = ExpertHub(model, n_slots=2, max_len=64, device=cuda)
    for i, p in enumerate(cpu):
        hub.add_expert(f"ex{i}", p)
    srv = RoutedServer(None, hub.build_registry(), max_batch=4, hub=hub,
                       device=cuda)
    hub.warmup(max_batch=4)
    captured = hub.bank.stats.decode_captured
    assert captured == 3                          # buckets 1, 2, 4
    steps0 = hub.bank.stats.decode_steps
    ops.reset_launches()
    traffic, got = _card_traffic(), {}
    for lo in range(0, len(traffic), 2):     # two requests a round: the
        got.update((r.uid, r.tokens)         # experts rotate
                   for r in srv.serve(traffic[lo:lo + 2]))
    torch.cuda.synchronize()
    steps = hub.bank.stats.decode_steps - steps0
    assert ops.launches()["decode_attention"] == \
        2 * model.cfg.n_layers * steps
    assert hub.stats.evictions >= 4 and hub.stats.loads >= 6
    assert hub.bank.stats.decode_captured == captured
    hub.check()
    for q in traffic:
        for where in (cuda, "cpu"):
            want = _eager(model, cpu[q.expert], where, [q.prompt], 6)[0]
            np.testing.assert_array_equal(got[q.uid], want)


@pytest.mark.cuda
def test_cuda_stage_during_a_capture_leaves_it_valid(cuda, tmp_path):
    """The staging worker reads a cold expert while the bank's decode
    step is being captured (the capture waits inside its body until the
    worker has published): the capture stays valid, its replays give an
    eager engine's tokens, and the staged expert then commits."""
    model = _card_model()
    cpu = [model.init(torch.Generator().manual_seed(s), device="cpu")
           for s in range(2)]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 300, size=9), rng.integers(0, 300, size=6)]
    with ExpertHub(model, n_slots=1, max_len=64, store=str(tmp_path),
                   device=cuda) as hub:
        hub.add_expert("ex0", cpu[0])
        hub.add_expert("ex1", cpu[1], cold=True)
        hub.want(0)
        hub.service()
        core, calls = hub.bank.core, []
        decode = core._decode

        def body(p, cache, tok):
            calls.append(1)
            if len(calls) == 2:
                # the capture: hand ex1 to the worker and wait (on the
                # host only) until it has published
                hub.want(1)
                hub.service()
                for _ in range(6000):
                    if hub.catalog[1].state == "staged":
                        break
                    threading.Event().wait(0.01)
            return decode(p, cache, tok)
        core._decode = body
        hub.bank.admit({0: ([0, 1], prompts, [8, 8])}, defer=True)
        while hub.bank.n_active:
            hub.bank.tick(defer=True)
            hub.bank.harvest()
        got = {u: t for _, u, t in hub.bank.poll()}
        del core._decode
        assert hub.bank.stats.decode_captured == 1
        assert hub.catalog[1].state == "staged"
        while hub.has_wanted:
            hub.service(block=True)
        assert hub.slot_of(1) == 0 and hub.stats.stage_count == 1
        hub.check()
    want = _eager(model, cpu[0], cuda, prompts, 8)
    for u in (0, 1):
        np.testing.assert_array_equal(got[u], want[u])
