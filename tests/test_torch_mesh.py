"""The port's 1-D expert mesh against the reference's, on the CPU.

The port's ``_bank_submesh`` gives the reference's slice on every (bank
size, cursor) of an 8-position mesh; ``plan_placement(mesh=)`` moves its
cursor as the reference does and prints the devices; a mesh that does
not divide a bank, or has no ``expert`` axis, raises the reference's
``ValueError``. A bank of 4 over 2 and 4 positions gives the tokens and
``host_blocks`` of the unsharded port bank and of JAX's unsharded
``BankedEngine`` (ring serial and deferred, chunked paged, spec k 2 with
the ``mlp`` draft carried across by ``bridge.copy_to_torch``); a banked
``RoutedServer`` on a mesh gives JAX's banked server's (expert, fine,
shard, tokens); a hub over a 2-position mesh the unsharded hub's tokens
and counters. The mesh's positions repeat the CPU: the port's
counterpart of the reference test's forced host device count. On the
card (``-m cuda``): graph == eager == CPU over ``(cuda:0,) * 2``, and
over two distinct cards each member's bytes on its card (skips below 2).
Weights are ``smollm_135m`` reduced at ``MAX_LEN`` 32, as the reference
suite's speculative tests.
"""
import types

import jax
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro.configs import get_config
from repro.core import ExpertRegistry, build_matcher, train_bank
from repro.data import load_benchmark
from repro.models import build_model
from repro.serve import BankedEngine, ExpertEngine, Request, RoutedServer
from repro.serve import plan_placement as jplan
from repro.serve.placement import _bank_submesh as jsubmesh
from repro_torch import core as tcore
from repro_torch import serve as tserve
from repro_torch.bridge import copy_to_torch, to_torch
from repro_torch.configs import get_config as tget
from repro_torch.launch.mesh import ExpertMesh, make_expert_mesh
from repro_torch.models import build_model as tbuild
from repro_torch.serve import placement as tplacement
from repro_torch.sharding import leading_sharding
from repro_torch.tree import leaves

GEOM = dict(max_len=32, min_len_bucket=8, batch_buckets=(1, 2, 4))
#: the three layouts a sharded bank is held in; the spec bank keeps its
#: waves inside the no-wrap gate, the others take a 20-token prompt
#: (ring wrap; paged: four chunks of 8)
LAYOUTS = {"ring": {}, "paged": dict(kv_layout="paged", chunk_len=8),
           "spec": dict(speculate_k=2, draft="mlp")}
SPEC = ("verify_steps", "tokens_drafted", "tokens_accepted",
        "spec_fallback_waves")


def cpu_mesh(n):
    return ExpertMesh(("cpu",) * n)


@pytest.fixture(scope="module")
def models():
    jmod = build_model(get_config("smollm_135m").reduced(name="mesh"))
    tmod = tbuild(tget("smollm_135m").reduced(name="mesh"))
    params = [jax.device_get(jmod.init(jax.random.PRNGKey(s)))
              for s in range(4)]
    return jmod, tmod, params


# -- layout ------------------------------------------------------------------


def test_bank_submesh_equals_the_reference():
    """Every (bank size 1..12, cursor 0..15) on a duck-typed 8-position
    mesh: the same device indices, the same sub-mesh shape (a bank of 9,
    10 or 12 takes its largest divisor that fits), and banks of 1 and 11
    unsharded (``(None, ())``); no mesh or no ``expert`` axis too."""
    stub = types.SimpleNamespace(shape={"expert": 8}, devices=np.arange(8))
    unsharded = 0
    for n in range(1, 13):
        for cursor in range(16):
            jsub, jdevs = jsubmesh(n, stub, cursor)
            tsub, tdevs = tplacement._bank_submesh(n, stub, cursor)
            assert tdevs == jdevs, (n, cursor)
            assert (tsub is None) == (jsub is None), (n, cursor)
            if tsub is None:
                unsharded += 1
                assert tdevs == ()
                continue
            assert tsub.shape == dict(jsub.shape)
            assert tsub.devices == tuple(torch.device("cuda", int(i))
                                         for i in jdevs)
    assert unsharded == 16 * 2          # n = 1, and 11 (prime, > 8)
    no_axis = types.SimpleNamespace(shape={"data": 8}, devices=np.arange(8))
    for mesh in (None, no_axis):
        assert tplacement._bank_submesh(4, mesh) == jsubmesh(4, mesh) == \
            (None, ())


def test_leading_sharding_and_make_expert_mesh():
    """Member ``e`` on position ``e // (E // n)``; nothing to split
    without a mesh, at size 1 or when the size does not divide.
    ``make_expert_mesh("cpu")`` is one CPU position; without a card the
    default raises."""
    assert leading_sharding(6, "expert", cpu_mesh(3)) == (0, 0, 1, 1, 2, 2)
    assert leading_sharding(4, "expert", cpu_mesh(4)) == (0, 1, 2, 3)
    for mesh in (None, cpu_mesh(1), cpu_mesh(4)):
        assert leading_sharding(6, "expert", mesh) is None
    mesh = make_expert_mesh("cpu")
    assert mesh.shape == {"expert": 1}
    assert mesh.devices == (torch.device("cpu"),)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_expert_mesh()


def _registry(tmod, params, sizes):
    """Engines in banks of ``sizes``: bank ``i``'s members share a spec
    (``max_len`` 32 + 8 i), so each size is one group."""
    reg = tcore.ExpertRegistry()
    for i, n in enumerate(sizes):
        for j in range(n):
            reg.add(f"b{i}m{j}", tserve.ExpertEngine(
                tmod, params[j % len(params)], max_len=32 + 8 * i,
                batch_buckets=(1, 2, 4), device="cpu"))
    return reg


def test_plan_placement_moves_its_cursor_as_the_reference(models,
                                                          monkeypatch):
    """Banks of 4, 6, 3 and 2 over an 8-position mesh: each bank asks
    ``_bank_submesh`` at the reference's cursor (advanced by the devices
    the last bank took), its shard holds those devices, ``describe``
    prints them, the bank's core splits over them, and params already on
    their position are not copied."""
    _, tmod, params = models
    tp = [to_torch(p, device="cpu") for p in params]
    sizes = (4, 6, 3, 2)
    reg = _registry(tmod, tp, sizes)
    calls = []
    real = tplacement._bank_submesh

    def spy(n, mesh, offset=0):
        calls.append((n, offset))
        return real(n, mesh, offset)

    monkeypatch.setattr(tplacement, "_bank_submesh", spy)
    plan = tserve.plan_placement(reg, mesh=cpu_mesh(8))
    stub = types.SimpleNamespace(shape={"expert": 8}, devices=np.arange(8))
    cursor, want = 0, []
    for n in sizes:
        _, devs = jsubmesh(n, stub, cursor)
        want.append(((n, cursor), len(devs)))
        cursor += len(devs)
    assert calls == [w[0] for w in want]
    assert [len(s.devices) for s in plan.shards] == [w[1] for w in want]
    assert plan.mesh.shape == {"expert": 8}
    lines = plan.describe(reg.names).splitlines()
    first = 0
    for s, n, line in zip(plan.shards, sizes, lines):
        names = ", ".join(reg.names[first:first + n])
        assert line == (f"shard {s.sid} [bank] on {len(s.devices)} "
                        f"device(s): {names}")
        assert s.bank.mesh.shape == {"expert": len(s.devices)}
        assert s.bank.core.per_pos == n // len(s.devices)
        for local in range(n):
            assert s.bank.params[local]["embed"].data_ptr() == \
                tp[local % len(tp)]["embed"].data_ptr()
        first += n


def test_mesh_refusals_match_the_reference(models):
    """A mesh whose ``expert`` axis does not divide the bank, and one
    with no ``expert`` axis, raise the reference's ``ValueError`` (with
    its message); a mesh of size 1 is the unsharded bank."""
    jmod, tmod, params = models
    tp = [to_torch(p, device="cpu") for p in params]
    bad = (types.SimpleNamespace(shape={"expert": 3},
                                 devices=("cpu",) * 3),
           types.SimpleNamespace(shape={"data": 2}, devices=("cpu",) * 2))
    for mesh in bad:
        with pytest.raises(ValueError) as want:
            BankedEngine(jmod, params, mesh=mesh, **GEOM)
        with pytest.raises(ValueError) as got:
            tserve.BankedEngine(tmod, tp, mesh=mesh, device="cpu", **GEOM)
        assert str(got.value) == str(want.value)
        with pytest.raises(ValueError, match="must divide"):
            tserve.ExpertHub(tmod, n_slots=4, mesh=mesh, device="cpu",
                             **GEOM)
    one = tserve.BankedEngine(tmod, tp, mesh=cpu_mesh(1), **GEOM)
    assert one.mesh is None and one.core.devices == (torch.device("cpu"),)


# -- tokens --------------------------------------------------------------------


def _waves(layout):
    rng = np.random.default_rng(3)
    g = lambda ns: [rng.integers(0, 100, size=n).astype(np.int32)
                    for n in ns]
    waves = {0: ([0, 1, 2], g((5, 8, 6)), [6, 4, 7]),
             1: ([3, 4], g((7, 4)), [5, 6]),
             3: ([5], g((3,)), [4])}
    if layout != "spec":
        waves[2] = ([6], g((20,)), [5])
    return waves


def _run(bank, layout, defer):
    """Admit the layout's wave and drive it to the end as an executor
    does (pending chunks, tick, harvest): {(local, uid): tokens}."""
    bank.admit(_waves(layout), defer=defer)
    out = {}
    while bank.has_pending:
        bank.core.prefill_step()
        bank.tick(defer=defer)
        bank.harvest()
        for local, uid, seq in bank.poll():
            out[(local, uid)] = np.asarray(seq).tolist()
    return out


@pytest.fixture(scope="module")
def reference_runs(models):
    """JAX's unsharded bank of 4 in each layout, blocking and deferred:
    (tokens, host_blocks, spec counters, draft state). The ring and spec
    banks serve both runs (counters as deltas; the ``mlp`` draft does
    not learn); a paged bank's prefix cache would serve the second run,
    so each paged run has a bank of its own."""
    jmod, _, params = models
    out = {}
    for layout, kw in LAYOUTS.items():
        jb = None
        for defer in (False, True):
            if jb is None or layout == "paged":
                jb = BankedEngine(jmod, params, **GEOM, **kw)
            state = (jax.device_get(jb.core.draft_state)
                     if jb.core.draft_state is not None else None)
            before = [getattr(jb.stats, k) for k in ("host_blocks",) + SPEC]
            tokens = _run(jb, layout, defer)
            after = [getattr(jb.stats, k) for k in ("host_blocks",) + SPEC]
            delta = [a - b for a, b in zip(after, before)]
            out[layout, defer] = (tokens, delta[0], delta[1:], state)
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_bank_matches_unsharded_and_reference(models, reference_runs,
                                                      layout):
    """A bank of 4 over 1, 2 and 4 positions, blocking and deferred:
    tokens, ``host_blocks`` and spec counters equal JAX's unsharded
    bank's; deferred blocks strictly less than serial; one graph object
    a (position, bucket); a spec bank's own draft state is the unsharded
    bank's, split."""
    _, tmod, params = models
    tp = [to_torch(p, device="cpu") for p in params]
    kw = LAYOUTS[layout]
    for defer in (False, True):
        tokens, blocks, spec, state = reference_runs[layout, defer]
        for n in (1, 2, 4):
            bank = tserve.BankedEngine(
                tmod, tp, device="cpu", mesh=None if n == 1 else cpu_mesh(n),
                **GEOM, **kw)
            if state is not None:
                # drawn once for all four members, then split: a
                # generator a position would draw other states
                own = [torch.cat(ls) for ls in
                       zip(*map(leaves, bank.core.draft_state))]
                if n == 1:
                    drawn = own
                assert all(torch.equal(a, b) for a, b in zip(own, drawn))
                # the reference's draft state, split as the bank splits it
                copy_to_torch(bank.core.draft_state,
                              [jax.tree_util.tree_map(lambda a: a[s], state)
                               for s, _ in bank.core._slices()])
            got = _run(bank, layout, defer)
            label = (layout, defer, n)
            assert got == tokens, label
            assert bank.stats.host_blocks == blocks, label
            assert [getattr(bank.stats, k) for k in SPEC] == spec, label
            ladder = bank.core._verify_graphs if kw.get("speculate_k") \
                else bank.core._graphs
            assert all(len(gs) == n for gs in ladder.values()), label
            assert bank.stats.decode_compiles + bank.stats.verify_compiles \
                <= sum(bank.core.executable_bounds()[k]
                       for k in ("decode", "verify"))
        if layout == "spec":
            assert spec[0] > 0 and spec[3] == 0
    assert reference_runs[layout, True][1] < reference_runs[layout, False][1]


@pytest.fixture(scope="module")
def fleet(models):
    """A JAX-trained matcher over two datasets and its port copy."""
    bench = load_benchmark(names=["mnist", "har"], n_per_dataset=200, seed=0)
    names = list(bench)
    aes, _ = train_bank([(n, bench[n]["server"][0]) for n in names],
                        epochs=2, batch_size=64)
    cents = [(bench[n]["server"][0], bench[n]["server"][1]) for n in names]
    jm = build_matcher(aes, names, cents)
    tm = tcore.ExpertMatcher(
        to_torch(jax.device_get(jm.bank_params), device="cpu"),
        to_torch(jax.device_get(jm.bank_states), device="cpu"), names,
        to_torch(np.asarray(jm.centroids), device="cpu"),
        to_torch(np.asarray(jm.centroid_mask), device="cpu"))
    return bench, names, jm, tm


def test_banked_server_on_a_mesh_matches_reference(models, fleet):
    """Two experts banked over a 2-position mesh behind an overlapped
    ``RoutedServer``: expert, fine class, shard and tokens per uid equal
    JAX's unsharded banked server's, and the bank's ``host_blocks``."""
    kv, executor = "ring", "overlapped"
    jmod, tmod, params = models
    bench, names, jm, tm = fleet
    jreg, treg = ExpertRegistry(), tcore.ExpertRegistry()
    for i, p in enumerate(params[:2]):
        jreg.add(names[i], ExpertEngine(jmod, p, kv_layout=kv, **GEOM))
        treg.add(names[i], tserve.ExpertEngine(
            tmod, to_torch(p, device="cpu"), kv_layout=kv, device="cpu",
            **GEOM))
    jp = jplan(jreg)
    tp = tserve.plan_placement(treg, mesh=cpu_mesh(2))
    assert tp.shards[0].bank.mesh.shape == {"expert": 2}
    assert tp.describe(treg.names).splitlines()[0] == \
        "shard 0 [bank] on 2 device(s): mnist, har"
    jsrv = RoutedServer(jm, jreg, max_batch=4, placement=jp,
                        executor=executor)
    tsrv = tserve.RoutedServer(tm, treg, max_batch=4, placement=tp,
                               executor=executor, device="cpu")
    rng = np.random.default_rng(13)
    traffic = []
    for uid in range(12):
        x, _ = bench[names[uid % 2]]["client_a"]
        traffic.append((uid, x[uid % 60],
                        rng.integers(0, 100, size=int(rng.integers(1, 20)))
                        .astype(np.int32), int(rng.integers(1, 7))))
    want = jsrv.serve([Request(u, f, p, m) for u, f, p, m in traffic])
    got = tsrv.serve([tserve.Request(u, f, p, m) for u, f, p, m in traffic])
    for g, w in zip(got, want, strict=True):
        assert (g.uid, g.expert, g.fine_class, g.shard) == \
            (w.uid, w.expert, w.fine_class, w.shard)
        np.testing.assert_array_equal(g.tokens, w.tokens, err_msg=str(g.uid))
    assert tp.shards[0].bank.stats.host_blocks == \
        jp.shards[0].bank.stats.host_blocks


def test_hub_on_a_mesh_matches_the_unsharded_hub(models, monkeypatch):
    """A 2-slot hub over a 2-position mesh (slot ``s`` on position
    ``s``), four experts staged from host memory, pre-routed traffic (a
    sweep, then skewed): tokens, loads, evictions, misses and the victim
    sequence equal the unsharded hub's."""
    _, tmod, params = models
    tp = [to_torch(p, device="cpu") for p in params]
    rng = np.random.default_rng(5)
    experts = [0, 1, 2, 3] + list(rng.choice(4, size=10, p=[.4, .3, .2, .1]))
    reqs = [tserve.Request(uid=u, features=np.zeros(784, np.float32),
                           prompt=rng.integers(0, 100, size=int(
                               rng.integers(4, 20))).astype(np.int32),
                           max_new_tokens=5, expert=int(e))
            for u, e in enumerate(experts)]
    victims = []
    real = tserve.ExpertHub._evict_locked

    def spy(self, e):
        victims.append((self.bank.mesh is not None, e))
        return real(self, e)

    monkeypatch.setattr(tserve.ExpertHub, "_evict_locked", spy)
    out = {}
    for mesh in (None, cpu_mesh(2)):
        hub = tserve.ExpertHub(tmod, n_slots=2, mesh=mesh, device="cpu",
                               **GEOM)
        if mesh is not None:
            assert hub.bank.core.per_pos == 1
            assert hub.bank.core.devices == (torch.device("cpu"),) * 2
        for i, p in enumerate(tp):
            hub.add_expert(f"x{i}", p)
        with tserve.RoutedServer(None, hub.build_registry(), max_batch=4,
                                 hub=hub, check_every=1,
                                 device="cpu") as srv:
            tokens = {r.uid: r.tokens.tolist() for r in srv.serve(reqs)}
        out[mesh is not None] = (tokens, {k: hub.stats.as_dict()[k] for k in (
            "loads", "evictions", "resident_misses")})
    assert out[True] == out[False]
    assert out[True][1]["evictions"] > 0
    assert [e for m, e in victims if m] == [e for m, e in victims if not m]


# -- the card ------------------------------------------------------------------


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _cuda(n):
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} NVIDIA GPU(s): a CUDA graph has no CPU "
                    "mode" + ("" if n == 1 else
                              "; waits for a machine with several cards"))


@pytest.mark.cuda
@pytest.mark.parametrize("kv,kernel", [("ring", "decode_attention"),
                                       ("paged", "paged_decode_attention")])
def test_cuda_mesh_bank_graph_equals_eager_and_cpu(kv, kernel):
    """A reduced f32 llama bank of 4 over ``(cuda:0,) * 2``: replayed
    graph tokens equal the eager step's and the CPU's unsharded bank's,
    one graph a (position, bucket), and the decode kernel launched E x
    n_layers times a step."""
    _cuda(1)
    from repro_torch.kernels import ops
    dev = torch.device("cuda", 0)
    model = tbuild(tget("llama3_2_1b").reduced(name="mesh-card"))
    cpu = [model.init(torch.Generator().manual_seed(s), device="cpu")
           for s in range(4)]
    card = [_to(p, dev) for p in cpu]
    rng = np.random.default_rng(4)
    groups = {0: ([0, 1], [rng.integers(0, 300, 9), rng.integers(0, 300, 5)],
                  [6, 4]),
              3: ([2], [rng.integers(0, 300, 12)], [7])}

    def run(bank):
        bank.admit(groups)
        out = {}
        while bank.has_pending:
            bank.tick()
            out.update({(l, u): s.tolist() for l, u, s in bank.poll()})
        return out

    want = run(tserve.BankedEngine(model, cpu, max_len=64, kv_layout=kv,
                                   device="cpu"))
    for capture in (True, False):
        bank = tserve.BankedEngine(model, card, max_len=64, kv_layout=kv,
                                   mesh=ExpertMesh((dev,) * 2),
                                   capture_decode=capture)
        ops.reset_launches()
        got = run(bank)
        torch.cuda.synchronize()
        assert got == want, capture
        steps = bank.stats.decode_steps
        assert ops.launches()[kernel] == 4 * model.cfg.n_layers * steps
        assert bank.stats.decode_compiles == 2
        assert bank.stats.decode_captured == 2 * int(capture)


@pytest.mark.cuda
def test_cuda_distinct_cards_hold_their_members():
    """Over two distinct cards: each member's params and pool slice on its
    own card, params already there not copied, the tokens the CPU's, and
    a kernel wrapper called on the second card while the first is current
    launches there (equal to its plain version)."""
    _cuda(2)
    from repro_torch.kernels import ops
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    model = tbuild(tget("llama3_2_1b").reduced(name="mesh-cards"))
    cpu = [model.init(torch.Generator().manual_seed(s), device="cpu")
           for s in range(4)]
    reg = tcore.ExpertRegistry()
    for i, p in enumerate(cpu):
        reg.add(f"m{i}", tserve.ExpertEngine(model, _to(p, d0), max_len=64,
                                             kv_layout="paged", device=d0))
    ptrs = [reg[e].backend.params["embed"].data_ptr() for e in range(4)]
    plan = tserve.plan_placement(reg, mesh=ExpertMesh((d0, d1)))
    bank = plan.shards[0].bank
    assert plan.shards[0].devices == (d0, d1)
    for e, params in enumerate(bank.params):
        home = (d0, d1)[e // 2]
        assert all(t.device == home for t in leaves(params)), e
        if home == d0:
            assert params["embed"].data_ptr() == ptrs[e]
    assert [p["k"].device for p in bank.core.kv_pool] == [d0, d1]
    rng = np.random.default_rng(6)
    groups = {0: ([0], [rng.integers(0, 300, 9)], [5]),
              3: ([1, 2], [rng.integers(0, 300, 7), rng.integers(0, 300, 4)],
                  [6, 3])}
    want = tserve.BankedEngine(model, cpu, max_len=64, kv_layout="paged",
                               device="cpu")
    outs = []
    for b in (bank, want):
        b.admit(groups)
        out = {}
        while b.has_pending:
            b.tick()
            out.update({(l, u): s.tolist() for l, u, s in b.poll()})
        outs.append(out)
    assert outs[0] == outs[1]
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 64, generator=gen)
    k = torch.randn(2, 32, 2, 64, generator=gen)
    v = torch.randn(2, 32, 2, 64, generator=gen)
    qp = torch.tensor(31, dtype=torch.int32)
    kp = torch.arange(32, dtype=torch.int32)
    with torch.cuda.device(d0):
        got = ops.decode_attention(q.to(d1), k.to(d1), v.to(d1), qp.to(d1),
                                   kp.to(d1))
        torch.cuda.synchronize(d1)
    assert got.device == d1
    torch.testing.assert_close(
        got.cpu(), ops.decode_attention_plain(q, k, v, qp, kp),
        rtol=2e-5, atol=2e-5)
