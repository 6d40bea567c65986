"""The decode step per (engine, decode batch bucket) — ``DecodeGraph``,
the port's counterpart of the reference's ``EngineCore._decode_fn(Bb)``.

On the CPU the step runs eagerly on the same static buffers a captured
graph replays on the card, so the residency swaps of ring waves that
share a bucket, the copy-out of every token plane and the paged
``pos``/``t`` round trip are all exercised here. Ring, paged (chunked
prefill) and mixed RWKV6 + dense ``RoutedServer``s, with two waves
resident at one bucket at once, are held to the reference's on the same
weights and requests: greedy tokens, expert and fine-class indices and
``host_blocks`` equal, ``decode_compiles`` within the bucket bound, and a
second identical serve adds no decode step object. The ``cuda`` cases
(skipped without a card) hold captured graphs to the eager step on the
card, count kernel launches through replays, and check that a body that
synchronises inside the capture raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro.configs import get_config
from repro.core import ExpertRegistry, build_matcher, init_ae
from repro.models import build_model
from repro.serve import ExpertEngine, Request, RoutedServer
from repro_torch import core as tcore
from repro_torch import serve as tserve
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config as tget
from repro_torch.kernels import ops
from repro_torch.models import build_model as tbuild
from test_torch_rwkv import trained_like

NAMES = ("a", "b")
PER_EXPERT = 5
MAX_LEN = 64


@pytest.fixture(scope="module")
def bank():
    """A two-expert AE bank (seeded, untrained) in both packages, and
    fingerprints chosen by their route: PER_EXPERT for each expert."""
    rng = np.random.default_rng(3)
    aes = [init_ae(jax.random.PRNGKey(30 + i)) for i in range(len(NAMES))]
    data = [(rng.random((64, 784), dtype=np.float32), np.arange(64) % 3)
            for _ in NAMES]
    jm = build_matcher(aes, list(NAMES), data)
    tm = tcore.ExpertMatcher(
        to_torch(jax.device_get(jm.bank_params), device="cpu"),
        to_torch(jax.device_get(jm.bank_states), device="cpu"), list(NAMES),
        to_torch(np.asarray(jm.centroids), device="cpu"),
        to_torch(np.asarray(jm.centroid_mask), device="cpu"))
    cands = rng.random((256, 784), dtype=np.float32)
    route = np.asarray(jm.assign_coarse(jnp.asarray(cands)))
    picks = [np.flatnonzero(route == e)[:PER_EXPERT]
             for e in range(len(NAMES))]
    assert all(len(p) == PER_EXPERT for p in picks)
    feats = cands[np.stack(picks, axis=1).ravel()]
    return jm, tm, feats


def _traffic(feats, seed, uid0=0):
    """Requests alternating between the experts; prompts of 3-40 tokens
    (length buckets 8-64: with ``chunk_len`` 16 the longer ones prefill
    in chunks) and 3-6 new tokens, so waves run several decode steps."""
    rng = np.random.default_rng(seed)
    lens = (5, 12, 20, 28, 40, 3, 9, 17, 33, 6)
    return [(uid0 + u, f, rng.integers(0, 300, size=lens[u % len(lens)])
             .astype(np.int32), int(rng.integers(3, 7)))
            for u, f in enumerate(feats)]


@pytest.fixture(scope="module")
def fleets(bank):
    """JAX and port registries over the same bridged weights, one pair
    per (archs, engine options), built once: the JAX engines keep their
    compiled executables from one test to the next, and both sides serve
    the same requests in the same order, so their caches and counters
    stay alike."""
    built = {}

    def get(archs, **kw):
        key = (archs, tuple(sorted(kw.items())))
        if key not in built:
            jreg, treg = ExpertRegistry(), tcore.ExpertRegistry()
            for i, (name, arch) in enumerate(zip(NAMES, archs)):
                jmod = build_model(get_config(arch).reduced(name=f"g-{name}"))
                params = jax.device_get(jmod.init(jax.random.PRNGKey(40 + i)))
                if jmod.cfg.family == "rwkv":
                    params = trained_like(params, seed=i)
                jreg.add(name, ExpertEngine(jmod, params, max_len=MAX_LEN,
                                            **kw))
                tmod = tbuild(tget(arch).reduced(name=f"g-{name}"))
                treg.add(name, tserve.ExpertEngine(
                    tmod, to_torch(params, device="cpu"), max_len=MAX_LEN,
                    device="cpu", **kw))
            built[key] = jreg, treg
        return built[key]
    return get


COUNTED = ("host_blocks", "decode_steps")


def _held_to_reference(bank, fleets, archs, executor, budget=0, **kw):
    """Serve the same requests twice (fresh uids the second time) through
    JAX's and the port's servers, ``max_batch`` 2: each expert's five
    requests make waves of 2, 2 and 1 rows, and the two waves of bucket 2
    decode side by side. Tokens, expert and class equal each time, and
    equal ``host_blocks``; the repeat adds no decode step object."""
    jm, tm, feats = bank
    jreg, treg = fleets(archs, **kw)
    jsrv = RoutedServer(jm, jreg, max_batch=2, executor=executor,
                        prefill_tokens_per_step=budget)
    tsrv = tserve.RoutedServer(tm, treg, max_batch=2, executor=executor,
                               prefill_tokens_per_step=budget, device="cpu")
    cores = [treg[e].backend.core for e in range(len(NAMES))]
    runs = []
    for uid0 in (0, 100):
        before = [{k: (getattr(jreg[e].backend.stats, k),
                       getattr(c.stats, k)) for k in COUNTED}
                  for e, c in enumerate(cores)]
        traffic = _traffic(feats, seed=1, uid0=uid0)
        want = jsrv.serve([Request(u, f, p, m) for u, f, p, m in traffic])
        got = tsrv.serve([tserve.Request(u, f, p, m)
                          for u, f, p, m in traffic])
        assert [r.uid for r in got] == [r.uid for r in want]
        for g, w in zip(got, want):
            assert (g.expert, g.fine_class) == (w.expert, w.fine_class), \
                g.uid
            np.testing.assert_array_equal(g.tokens, w.tokens,
                                          err_msg=str(g.uid))
        for e, c in enumerate(cores):
            for k in COUNTED:
                jb, tb = before[e][k]
                assert getattr(c.stats, k) - tb == \
                    getattr(jreg[e].backend.stats, k) - jb, (k, e)
            # waves of 2, 2 and 1 rows: buckets 2 and 1, one wave a replay;
            # a constant-state core's rows share replays (row slots), in
            # groups of up to five rows: buckets 4 and 2
            assert set(c._graphs) == ({4, 2} if c.row_slots else {2, 1})
            assert c.stats.decode_compiles <= \
                c.executable_bounds()["decode"]
            assert c.stats.decode_captured == 0
            assert c.stats.decode_capture_ms == 0.0
        runs.append(got)
    return runs, cores


@pytest.mark.parametrize("executor", ["serial", "overlapped"])
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_dense_server_matches_reference(bank, fleets, layout, executor):
    kw = {"kv_layout": layout}
    if layout == "paged":
        kw.update(chunk_len=16, budget=16)
    (got, again), cores = _held_to_reference(
        bank, fleets, ("llama3_2_1b", "smollm_135m"), executor, **kw)
    if layout == "ring":
        # two waves shared bucket 2: their states swapped in and out
        assert all(c.stats.decode_swaps > 0 for c in cores)
    else:
        assert all(c.stats.decode_swaps == 0 for c in cores)
        assert all(c.stats.suffix_compiles > 0 for c in cores)
        for c in cores:
            c.pool.check()
    for g, a in zip(got, again):
        np.testing.assert_array_equal(g.tokens, a.tokens)


@pytest.mark.parametrize("executor", ["serial", "overlapped"])
def test_mixed_rwkv_server_matches_reference(bank, fleets, executor):
    (got, again), cores = _held_to_reference(
        bank, fleets, ("rwkv6_7b", "llama3_2_1b"), executor)
    assert cores[0].model.cfg.family == "rwkv"
    # the dense core's two waves at bucket 2 swap through its graph; the
    # RWKV core's rows share one group of slots, so it swaps nothing and
    # replays less often than its waves step
    rwkv, dense = cores
    assert dense.stats.decode_swaps > 0
    assert rwkv.stats.decode_swaps == 0
    assert 0 < rwkv.stats.decode_replays < rwkv.stats.decode_steps
    assert rwkv.stats.rows_installed > 0
    for g, a in zip(got, again):
        np.testing.assert_array_equal(g.tokens, a.tokens)


# ---------------------------------------------------------------------------
# The engine alone (no JAX)
# ---------------------------------------------------------------------------


def _engine(arch="llama3_2_1b", seed=0, device="cpu", **kw):
    model = tbuild(tget(arch).reduced(name=f"ge-{arch}"))
    params = model.init(torch.Generator(device=device).manual_seed(seed),
                        device=device)
    return tserve.ExpertEngine(model, params, max_len=MAX_LEN, device=device,
                               **kw)


def _waves(seed=0, n=3):
    """Three waves of two rows at bucket 2, 5-8 new tokens each."""
    rng = np.random.default_rng(seed)
    return [([2 * i, 2 * i + 1],
             [rng.integers(0, 300, size=int(rng.integers(4, 14)))
              for _ in range(2)], [5 + i, 8 - i]) for i in range(n)]


def _run(eng, waves, *, defer):
    """Admit every wave at once, then tick to the end; with ``defer``
    nothing is harvested until every wave has stepped its last."""
    for uids, prompts, max_new in waves:
        eng.admit(uids, prompts, max_new, defer=defer)
    while eng.n_active:
        if not eng.tick(defer=defer):
            eng.harvest()
    if defer:
        eng.harvest()
    return dict(eng.poll())


def test_token_planes_do_not_alias_the_static_output():
    """Overlapped: waves of more than one step keep every plane on the
    device until harvest. Each plane is copied out of the step's static
    output, so the next step cannot overwrite it: overlapped tokens equal
    serial tokens, and each wave's tokens equal the wave decoded alone."""
    waves = _waves()
    serial = _run(_engine(), waves, defer=False)
    eng = _engine()
    over = _run(eng, waves, defer=True)
    assert over.keys() == serial.keys()
    for u in serial:
        np.testing.assert_array_equal(over[u], serial[u], err_msg=str(u))
    # not a vacuous check: some row emits different tokens over its steps
    assert any(len(set(s.tolist())) > 1 for s in serial.values())
    alone = {}
    for w in waves:
        alone.update(_run(_engine(), [w], defer=False))
    for u in serial:
        np.testing.assert_array_equal(alone[u], serial[u], err_msg=str(u))
    st = eng.stats
    assert st.decode_compiles == 1 and st.decode_swaps > 0
    assert eng.core._graphs[2][0].resident is None  # every wave retired


def test_swap_copies_the_resident_state_out_and_the_newcomer_in():
    """Two waves at one bucket: the first is adopted (its cache tensors
    become the static state), the second swaps in, and the first then
    holds its own copy of its live state."""
    eng = _engine(seed=1)
    (u0, p0, m0), (u1, p1, m1) = _waves(seed=2, n=2)
    eng.admit(u0, p0, m0, defer=True)
    core = eng.core
    w0 = core._active[0]
    eng.tick(defer=True)
    g = core._graphs[2][0]               # the one position's graph
    assert g.state is w0.cache[0] and g.resident is w0
    eng.admit(u1, p1, m1, defer=True)
    w1 = core._active[1]
    t0 = int(g.state["t"][0])
    eng.tick(defer=True)                 # w0 replays, then w1 swaps in
    assert g.resident is w1 and w0.cache[0] is not g.state
    assert int(w0.cache[0]["t"][0]) == t0 + 1
    assert int(g.state["t"][0]) == int(w1.cache[0]["t"][0]) + 1
    assert core.stats.decode_swaps == 1


def test_paged_step_copies_pos_and_t_back_to_the_wave():
    eng = _engine(seed=3, kv_layout="paged", page_size=8)
    (u0, p0, m0), (u1, p1, m1) = _waves(seed=4, n=2)
    eng.admit(u0, p0, m0, defer=True)
    eng.admit(u1, p1, m1, defer=True)
    w0, w1 = eng.core._active
    t = [int(w.t[0][0]) for w in (w0, w1)]
    eng.tick(defer=True)
    assert [int(w.t[0][0]) for w in (w0, w1)] == [t[0] + 1, t[1] + 1]
    for w, tt in ((w0, t[0]), (w1, t[1])):
        assert int(w.pos[0][0, tt % MAX_LEN]) == tt
    g = eng.core._graphs[2][0]
    assert w0.pos[0].data_ptr() != g.pos.data_ptr()
    assert eng.stats.decode_swaps == 0


def test_a_decode_that_rebinds_a_cache_leaf_raises():
    """The captured step replays on fixed buffers, so the engine refuses
    a model whose decode returns a new tensor for a cache leaf."""
    eng = _engine(seed=5)
    model = eng.model
    decode = model.decode

    def rebinding(params, cache, batch):
        logits, cache = decode(params, cache, batch)
        cache["t"] = cache["t"] + 0
        return logits, cache

    (u0, p0, m0), = _waves(n=1)
    eng.admit(u0, p0, m0)
    model.decode = rebinding
    with pytest.raises(RuntimeError, match="in place"):
        eng.tick()


def test_add_launches_adds_and_takes_back():
    before = ops.launches()
    ops.add_launches({"decode_attention": 3, "wkv_step": 2})
    after = ops.launches()
    assert after["decode_attention"] == before["decode_attention"] + 3
    assert after["wkv_step"] == before["wkv_step"] + 2
    ops.add_launches({"decode_attention": -3, "wkv_step": -2})
    assert ops.launches() == before


# ---------------------------------------------------------------------------
# Row slots: the rows of a constant-state core's waves share replays
# ---------------------------------------------------------------------------

#: (uids, prompt lengths, max_new) of three waves of length buckets 8, 16
#: and 32, admitted in successive steps; with a largest batch bucket of 4,
#: up to nine rows decode at once, so packing, swaps and slot reuse all run
SLOT_WAVES = [([0, 1, 2], (5, 3, 6), (6, 3, 5)),
              ([3, 4, 5, 6], (12, 10, 14, 9), (4, 7, 2, 5)),
              ([7, 8], (28, 20), (6, 1))]
SLOT_BUCKETS = (1, 2, 4)


def _slot_waves(seed=9):
    rng = np.random.default_rng(seed)
    return [(uids, [rng.integers(0, 300, size=n).astype(np.int32)
                    for n in lens], list(news))
            for uids, lens, news in SLOT_WAVES]


def _decoding(core) -> int:
    """Rows that decode in the next step: a row of a wave at step j needs
    it while its max_new exceeds j + 1."""
    return sum(m > w.ticks + 1 for w in core._active if w.steps_left > 0
               for ms in w.per_row_new.values() for m in ms)


def _drive_successive(eng, waves, *, defer, core=None):
    """Admit one wave a step, tick every step, harvest; ``core`` (the
    port's): each tick's (replays, rows decoding, waves ticked)."""
    pending, ticks = list(waves), []
    while pending or eng.n_active:
        if pending:
            eng.admit(*pending.pop(0), defer=defer)
        if core is not None:
            live, r0 = _decoding(core), core.stats.decode_replays
        n = eng.tick(defer=defer)
        if core is not None:
            ticks.append((core.stats.decode_replays - r0, live, n))
        eng.harvest()
    return dict(eng.poll()), ticks


@pytest.mark.parametrize("defer", [False, True])
def test_row_slots_merge_waves_and_match_reference(defer):
    """A reduced RWKV6 core: waves of three length buckets admitted in
    successive steps decode together. Each tick replays at most
    ceil(rows decoding / largest bucket) times, fewer than the waves it
    steps once they overlap; every row's tokens, ``decode_steps`` and
    ``host_blocks`` equal the reference's (one replay a wave); the
    ladder stays within ``executable_bounds()``."""
    jmod = build_model(get_config("rwkv6_7b").reduced(name="slots"))
    params = trained_like(jax.device_get(jmod.init(jax.random.PRNGKey(50))),
                          seed=5)
    kw = dict(max_len=MAX_LEN, batch_buckets=SLOT_BUCKETS)
    jeng = ExpertEngine(jmod, params, **kw)
    teng = tserve.ExpertEngine(
        tbuild(tget("rwkv6_7b").reduced(name="slots")),
        to_torch(params, device="cpu"), device="cpu", **kw)
    core = teng.core
    assert core.row_slots is not None
    waves = _slot_waves()
    want, _ = _drive_successive(jeng, waves, defer=defer)
    got, ticks = _drive_successive(teng, waves, defer=defer, core=core)
    assert got.keys() == want.keys() == {u for w in SLOT_WAVES for u in w[0]}
    for u in want:
        np.testing.assert_array_equal(got[u], want[u], err_msg=str(u))
    Bmax = SLOT_BUCKETS[-1]
    for replays, live, n in ticks:
        assert replays <= -(-live // Bmax), ticks
    assert max(live for _, live, _ in ticks) > Bmax     # groups swapped
    assert any(r < n for r, _, n in ticks)              # waves merged
    st, jst = core.stats, jeng.stats
    assert (st.decode_steps, st.host_blocks) == (jst.decode_steps,
                                                  jst.host_blocks)
    assert st.decode_replays == sum(r for r, _, _ in ticks) < st.decode_steps
    assert st.rows_installed == sum(m > 1 for w in SLOT_WAVES for m in w[2])
    assert st.decode_swaps > 0
    assert st.decode_compiles <= core.executable_bounds()["decode"]
    assert set(st.decode_graphs) <= set(SLOT_BUCKETS)
    assert not any(g.count() for g in core.row_slots.groups)  # all free


def test_row_slot_replays_name_their_waves(bank, fleets):
    """Traced, the mixed RWKV + dense server: one ``decode.replay`` range
    a replay, each naming the waves it carries and its decoding rows (an
    RWKV range carries rows of more than one wave), the RWKV core's
    installs under ``ring.swap``, and each ``sched.step`` the replays it
    ran."""
    from repro_torch.obs.trace import Tracer
    jm, tm, feats = bank
    _, treg = fleets(("rwkv6_7b", "llama3_2_1b"))
    tsrv = tserve.RoutedServer(tm, treg, max_batch=2, executor="overlapped",
                               device="cpu")
    cores = [treg[e].backend.core for e in range(len(NAMES))]
    before = [c.stats.as_dict() for c in cores]
    tr = Tracer(enabled=True)
    tsrv.bind_tracer(tr)
    try:
        tsrv.serve([tserve.Request(u, f, p, m) for u, f, p, m in
                    _traffic(feats, seed=2, uid0=200)])
        recs = tr.records()
    finally:
        tsrv.bind_tracer(None)
    delta = [{k: c.stats.as_dict()[k] - b[k] for k in b
              if isinstance(b[k], int)} for c, b in zip(cores, before)]
    replays = [r for r in recs if r["name"] == "decode.replay"]
    assert len(replays) == sum(d["decode_replays"] for d in delta)
    assert sum(r["args"]["replays"] for r in recs
               if r["name"] == "sched.step") == len(replays)
    rwkv = [r["args"] for r in replays if r["args"]["engine"] == 0]
    assert len(rwkv) == delta[0]["decode_replays"] < delta[0]["decode_steps"]
    assert all(a["waves"] and a["rows"] >= 1 for a in rwkv)
    assert max(len(a["waves"]) for a in rwkv) > 1
    assert sum(r["args"].get("rows_installed", 0) for r in recs
               if r["name"] == "ring.swap" and r["cat"] == "device") \
        == delta[0]["rows_installed"] > 0
    dense = [r["args"] for r in replays if r["args"]["engine"] == 1]
    assert len(dense) == delta[1]["decode_steps"]
    assert all(a["waves"] == [a["wave"]] for a in dense)


@pytest.mark.parametrize("layout,spec", [("ring", 0), ("paged", 0),
                                         ("ring", 2)])
def test_cores_with_positions_never_merge(layout, spec):
    """Dense ring waves (K/V rings with a shared ``pos``/``t``), paged
    waves and speculative waves keep one replay a wave step: no row
    slots, ``decode_replays == decode_steps``."""
    kw = dict(speculate_k=spec, draft="table") if spec else {}
    eng = _engine(seed=11, kv_layout=layout, **kw)
    assert eng.core.row_slots is None
    _run(eng, _waves(seed=12), defer=True)
    st = eng.stats
    assert st.decode_steps > 0 and st.decode_replays == st.decode_steps
    assert st.rows_installed == 0
    assert (st.verify_steps > 0) == bool(spec)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    return torch.device("cuda")


#: (arch, layout, the kernel every decode layer launches)
CARD_CASES = [("llama3_2_1b", "ring", "decode_attention"),
              ("llama3_2_1b", "paged", "paged_decode_attention"),
              ("rwkv6_7b", "ring", "wkv_step")]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,layout,kernel", CARD_CASES)
def test_cuda_graph_tokens_equal_eager_and_launches_count_replays(
        cuda, arch, layout, kernel):
    """Three waves at bucket 2 (swaps on the ring) through captured
    graphs, and through the eager step on the same weights: equal tokens,
    and ``kernel`` counted n_layers x replays with the replays. One wave a
    replay and one graph captured, except on RWKV6, whose rows share
    replays (row slots): fewer replays than wave steps."""
    waves = _waves(seed=6)
    out = {}
    for capture in (True, False):
        eng = _engine(arch, seed=7, device=cuda, kv_layout=layout,
                      capture_decode=capture)
        steps0 = eng.stats.decode_steps
        ops.reset_launches()
        out[capture] = _run(eng, waves, defer=True)
        torch.cuda.synchronize()
        st = eng.stats
        steps = st.decode_steps - steps0
        assert ops.launches()[kernel] == \
            eng.model.cfg.n_layers * st.decode_replays
        if eng.core.row_slots is None:
            assert st.decode_replays == steps
            assert st.decode_compiles == 1
            assert st.decode_captured == int(capture)
        else:
            assert st.decode_replays < steps
            assert (st.decode_captured > 0) == capture
    for u in out[False]:
        np.testing.assert_array_equal(out[True][u], out[False][u],
                                      err_msg=str(u))
    cpu = _engine(arch, seed=7, kv_layout=layout)
    cpu.core.params = [_to(eng.params, "cpu")]
    want = _run(cpu, waves, defer=False)
    for u in want:
        np.testing.assert_array_equal(out[True][u], want[u], err_msg=str(u))


@pytest.mark.cuda
def test_cuda_row_slot_replays_equal_eager_and_count_launches(cuda):
    """Waves of three length buckets admitted in successive steps on a
    reduced RWKV6 core: captured merged replays (packing, swaps, slot
    reuse) give the eager replays' tokens and the CPU's, and ``wkv_step``
    counts n_layers x replays."""
    waves = _slot_waves()
    out = {}
    for capture in (True, False):
        eng = _engine("rwkv6_7b", seed=13, device=cuda,
                      capture_decode=capture, batch_buckets=SLOT_BUCKETS)
        ops.reset_launches()
        out[capture], _ = _drive_successive(eng, waves, defer=True,
                                            core=eng.core)
        torch.cuda.synchronize()
        st = eng.stats
        assert ops.launches()["wkv_step"] == \
            eng.model.cfg.n_layers * st.decode_replays
        assert 0 < st.decode_replays < st.decode_steps
        assert st.decode_swaps > 0
        assert (st.decode_captured > 0) == capture
    for u in out[False]:
        np.testing.assert_array_equal(out[True][u], out[False][u],
                                      err_msg=str(u))
    cpu = _engine("rwkv6_7b", seed=13, batch_buckets=SLOT_BUCKETS)
    cpu.core.params = [_to(eng.params, "cpu")]
    want, _ = _drive_successive(cpu, waves, defer=False)
    for u in want:
        np.testing.assert_array_equal(out[True][u], want[u], err_msg=str(u))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


#: run in a process of its own: a capture that fails leaves its CUDA
#: context unfit for the tests that follow
SYNCING_CAPTURE = """
import numpy as np, torch
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve import ExpertEngine
model = build_model(get_config("llama3_2_1b").reduced(name="sync"))
params = model.init(torch.Generator(device="cuda").manual_seed(8),
                    device="cuda")
eng = ExpertEngine(model, params, max_len=64, device="cuda")
decode = model.decode
def syncing(params, cache, batch):
    logits, cache = decode(params, cache, batch)
    float(logits.sum().item())
    return logits, cache
model.decode = syncing
rng = np.random.default_rng(0)
eng.admit([0, 1], [rng.integers(0, 300, size=9) for _ in range(2)], [6, 6],
          defer=True)
eng.tick(defer=True)
try:
    eng.tick(defer=True)
except RuntimeError as e:
    print("RAISED", eng.stats.decode_captured, type(e).__name__)
else:
    print("NO ERROR")
"""


@pytest.mark.cuda
def test_cuda_a_body_that_syncs_inside_the_capture_raises(cuda):
    """The first step runs eagerly (a sync is allowed there); the second
    captures, where a host sync is refused: the tick raises, and no
    eager step stands in for the graph."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", SYNCING_CAPTURE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[:2] == ["RAISED", "0"], out.stdout


#: a dead engine's captured graph waits in reference cycles (core <->
#: stats, core <-> graph) for the cyclic collector; here the collector
#: runs inside the next capture, as it may whenever it comes due there
GARBAGE_DURING_CAPTURE = """
import gc, numpy as np, torch
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve import ExpertEngine
model = build_model(get_config("llama3_2_1b").reduced(name="gc"))
params = model.init(torch.Generator(device="cuda").manual_seed(8),
                    device="cuda")
rng = np.random.default_rng(0)
prompts = [rng.integers(0, 300, size=9) for _ in range(2)]
def engine():
    eng = ExpertEngine(model, params, max_len=64, device="cuda")
    eng.admit([0, 1], prompts, [6, 6], defer=True)
    eng.tick(defer=True)
    return eng
gc.disable()
dead = engine()
dead.tick(defer=True)
assert dead.stats.decode_captured == 1
del dead
live = engine()
decode = live.core._decode
def collecting(p, cache, tok):
    if torch.cuda.is_current_stream_capturing():
        gc.collect()
    return decode(p, cache, tok)
live.core._decode = collecting
try:
    live.tick(defer=True)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("FAILED", type(e).__name__)
else:
    print("CAPTURED", live.stats.decode_captured)
"""


@pytest.mark.cuda
def test_cuda_a_dead_engines_graph_is_not_freed_inside_a_capture(cuda):
    """Destroying a CUDA graph while another is being captured invalidates
    that capture (torch.cuda.graph does not collect garbage on entry).
    The step graph collects before it captures, so a dead engine's graph
    is gone before capture begins and the collector running inside the
    capture frees nothing that touches the card."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", GARBAGE_DURING_CAPTURE],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[:2] == ["CAPTURED", "1"], out.stdout
