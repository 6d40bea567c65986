"""The port's speculative decoding against the reference's, on the CPU.

``ExpertEngine(speculate_k=k, draft=...)`` in both packages on the same
bridged weights (``smollm_135m`` reduced, ``MAX_LEN`` 32, batch buckets
1, 2, 4, the reference suite's geometry): the port's spec tokens equal
JAX's spec tokens and the port's own plain engine's, on the whole ring
(k 1, 2, 4, 8) and paged (k 2, 4) grid, and the four spec counters
(``verify_steps``, ``tokens_drafted``, ``tokens_accepted``,
``spec_fallback_waves``) equal JAX's for every draft — the ``mlp`` draft
on the reference's own state, carried across with
``bridge.copy_to_torch`` (``jax.random`` draws cannot be reproduced by a
torch generator). Then the reference suite's other cases: identity
across waves, the always-wrong draft's progress guarantee, paged page
accounting (baseline after a spec wave, a wrapping wave falling back to
plain decode, ``PagePoolExhausted`` rolling admission back), the verify
bound, RWKV6's refusal, and a ``RoutedServer(speculate_k=)`` against
JAX's. Unit cases hold the drafts and the model's ``verify`` to the
reference: the bigram table's ``observe`` with repeated window tokens
(the last write in row-major order wins, as XLA's CPU scatter applies
them), the mlp draft's proposals, and a verify window holding the id
``padded_vocab`` (clamped, as JAX's gather clamps). The ``cuda`` cases
(skipped without a card) hold the captured verify graph to the eager
step and both to the CPU.
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
from repro.serve.draft import BigramTableDraft as JTable
from repro.serve.draft import MLPBaselineDraft as JMLP
from repro_torch import core as tcore
from repro_torch import serve as tserve
from repro_torch.bridge import copy_to_torch, to_torch
from repro_torch.configs import get_config as tget
from repro_torch.kernels import ops
from repro_torch.models import build_model as tbuild
from repro_torch.tree import tree_map

MAX_LEN = 32
GEOM = dict(max_len=MAX_LEN, min_len_bucket=8, batch_buckets=(1, 2, 4))
SPEC = ("verify_steps", "tokens_drafted", "tokens_accepted",
        "spec_fallback_waves")


@pytest.fixture(scope="module")
def tiny():
    jmod = build_model(get_config("smollm_135m").reduced(name="spec-diff"))
    tmod = tbuild(tget("smollm_135m").reduced(name="spec-diff"))
    params = jax.device_get(jmod.init(jax.random.PRNGKey(7)))
    return jmod, tmod, params, to_torch(params, device="cpu")


def _jax(tiny, **kw):
    jmod, _, params, _ = tiny
    return ExpertEngine(jmod, params, **{**GEOM, **kw})


def _port(tiny, **kw):
    _, tmod, _, params = tiny
    return tserve.ExpertEngine(tmod, params, device="cpu", **{**GEOM, **kw})


def _pair(tiny, **kw):
    """JAX and port engines with the same options; an ``mlp`` draft's
    state is carried across from the JAX engine."""
    je, te = _jax(tiny, **kw), _port(tiny, **kw)
    if te.core.draft_name == "mlp":
        copy_to_torch(te.core.draft_state,
                      [jax.device_get(je.core.draft_state)])
    return je, te


def _wave_a():
    """3 rows (Bb 4), prompts <= 8 (Sb 8), mixed caps: 8 + 6 + k <= 32
    for every k <= 8, so every grid cell speculates."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 100, size=n).astype(np.int32)
               for n in (5, 8, 6)]
    return prompts, [6, 4, 7]


def _wave_long():
    """The same prompts with longer continuations (up to 20 tokens, the
    gate still open at k 2): the table draft learns and accepts some."""
    prompts, _ = _wave_a()
    return prompts, [20, 12, 18]


def _run(engine, prompts, max_new, uid0=0):
    """Admit one wave and drain it to {uid: tokens} (blocking path)."""
    uids = list(range(uid0, uid0 + len(prompts)))
    engine.admit(uids, list(prompts), list(max_new))
    out = {}
    while engine.has_pending:
        engine.tick()
        out.update(engine.poll())
    return out


def _equal(got, want):
    assert got.keys() == want.keys()
    for u in want:
        np.testing.assert_array_equal(got[u], want[u], err_msg=str(u))


def _same_counters(te, je, keys=SPEC):
    for k in keys:
        assert getattr(te.stats, k) == getattr(je.stats, k), k


@pytest.fixture(scope="module")
def plain_tokens(tiny):
    """The port's plain engine: one token a tick, the reference every
    spec cell is held to."""
    return _run(_port(tiny), *_wave_a())


# -- identity grid -------------------------------------------------------------


@pytest.mark.parametrize("kv,k", [
    ("ring", 1), ("ring", 2), ("ring", 4), ("ring", 8),
    ("paged", 2), ("paged", 4),
])
def test_spec_tokens_equal_reference_and_plain(tiny, plain_tokens, kv, k):
    """Every (layout, k) cell with the table draft: tokens equal JAX's
    spec engine and the port's plain engine, the spec counters equal
    JAX's, and every decode step is a verify."""
    je, te = _pair(tiny, kv_layout=kv, speculate_k=k, draft="table")
    prompts, max_new = _wave_a()
    want = _run(je, prompts, max_new)
    got = _run(te, prompts, max_new)
    _equal(got, want)
    _equal(got, plain_tokens)
    _same_counters(te, je, SPEC + ("host_blocks",))
    st = te.stats
    assert st.verify_steps > 0 and st.spec_fallback_waves == 0
    assert st.decode_steps == st.verify_steps
    assert st.decode_compiles == 0 and st.verify_compiles == 1


@pytest.mark.parametrize("draft", ["table", "always-wrong", "mlp"])
@pytest.mark.parametrize("kv", ["ring", "paged"])
def test_spec_counters_equal_reference(tiny, kv, draft):
    """Longer continuations, k 2: the four spec counters equal JAX's for
    every draft (the table draft accepts some drafts here)."""
    je, te = _pair(tiny, kv_layout=kv, speculate_k=2, draft=draft)
    prompts, max_new = _wave_long()
    _equal(_run(te, prompts, max_new), _run(je, prompts, max_new))
    _same_counters(te, je)
    if draft == "table":
        assert te.stats.tokens_accepted > 0


def test_spec_identity_across_waves(tiny):
    """An online draft keeps learning across waves; the tokens stay the
    plain engine's on every wave shape it meets (Bb 2 then Bb 1)."""
    plain = _port(tiny)
    je, te = _pair(tiny, speculate_k=2, draft="table")
    rng = np.random.default_rng(23)
    for uid0, caps in ((0, [5, 5]), (10, [6])):
        prompts = [rng.integers(0, 100, size=int(rng.integers(3, 9)))
                   .astype(np.int32) for _ in caps]
        want = _run(plain, prompts, caps, uid0=uid0)
        _equal(_run(te, prompts, caps, uid0=uid0), want)
        _equal(_run(je, prompts, caps, uid0=uid0), want)
    assert te.stats.verify_steps > 0
    _same_counters(te, je)
    np.testing.assert_array_equal(
        te.core.draft_state[0]["table"].numpy(),
        np.asarray(je.core.draft_state["table"]))


def test_always_wrong_draft_progress_guarantee(tiny, plain_tokens):
    """Nothing is accepted, yet every verify emits the corrected greedy
    token: rows advance one a verify and the wave needs exactly
    max(max_new) - 1 verifies (the first token comes from prefill)."""
    te = _port(tiny, speculate_k=2, draft="always-wrong")
    prompts, max_new = _wave_a()
    _equal(_run(te, prompts, max_new), plain_tokens)
    st = te.stats
    assert st.tokens_accepted == 0 and st.acceptance_rate == 0.0
    assert st.tokens_drafted > 0
    assert st.verify_steps == max(max_new) - 1


# -- page accounting -----------------------------------------------------------


def _evict_all(core):
    for e in range(core.pool.n_experts):
        core.prefix_cache.evict_for(e, core.pool.n_pages)


def test_spec_wave_pages_return_to_baseline(tiny):
    """After a spec wave retires only the prefix cache holds pages;
    evicting them restores the counters of before the admission. The
    rejected suffix's slots live in pages the row owns, released at
    retirement."""
    te = _port(tiny, kv_layout="paged", page_size=8, speculate_k=2,
               draft="table")
    pool = te.core.pool
    base = dict(pool.counters())
    _run(te, *_wave_a())
    assert te.core.n_active == 0
    pins = sum(1 for key in te.core.prefix_cache._lru if key[0] == "pg")
    assert pool.counters()["used"] == pins
    _evict_all(te.core)
    assert pool.counters() == base
    pool.check()


def test_spec_wrap_cow_wave_falls_back_identically(tiny):
    """A wave whose decode wraps into its (shared) prompt pages fails the
    gate: it runs plain decode, with the plain ring engine's tokens and
    JAX's counters, and its pages settle."""
    mk = dict(max_len=16, min_len_bucket=8, batch_buckets=(1, 2))
    jmod, tmod, jp, tp = tiny
    spec = tserve.ExpertEngine(tmod, tp, kv_layout="paged", page_size=8,
                               speculate_k=4, draft="table", device="cpu",
                               **mk)
    jspec = ExpertEngine(jmod, jp, kv_layout="paged", page_size=8,
                         speculate_k=4, draft="table", **mk)
    plain = tserve.ExpertEngine(tmod, tp, device="cpu", **mk)
    p = np.random.default_rng(5).integers(0, 100, size=8).astype(np.int32)
    prompts, max_new = [p, p.copy()], [10, 10]    # Sb + steps = 17 > 16
    want = _run(plain, prompts, max_new)
    base = dict(spec.core.pool.counters())
    _equal(_run(spec, prompts, max_new), want)
    _equal(_run(jspec, prompts, max_new), want)
    st = spec.stats
    assert st.spec_fallback_waves == 1 and st.verify_steps == 0
    assert st.pages_copied > 0            # the duplicate COW'd its page
    _same_counters(spec, jspec, SPEC + ("pages_copied", "decode_steps"))
    assert spec.core.pool.counters() == base
    spec.core.pool.check()


def test_spec_admission_pool_exhausted_rolls_back(tiny):
    """An admission that outgrows the pool raises PagePoolExhausted with
    no page moved, and succeeds once the resident wave retired."""
    te = _port(tiny, kv_layout="paged", page_size=8, pool_pages=8,
               speculate_k=2, draft="table")
    pool = te.core.pool
    rng = np.random.default_rng(9)
    caps = [6, 4, 7]
    first, second = ([rng.integers(lo, lo + 90, size=n).astype(np.int32)
                      for n in (5, 8, 6)] for lo in (0, 100))
    te.admit([0, 1, 2], first, caps)           # resident: 6 of 8 pages
    before = dict(pool.counters())
    with pytest.raises(tserve.PagePoolExhausted):
        te.admit([10, 11, 12], second, caps)
    assert pool.counters() == before
    pool.check()
    while te.has_pending:
        te.tick()
        te.poll()
    _evict_all(te.core)
    got = _run(te, second, caps, uid0=10)
    assert sorted(got) == [10, 11, 12]
    assert [len(got[10 + i]) for i in range(3)] == caps


# -- bounds and refusals -------------------------------------------------------


def test_executable_bounds_verify_family(tiny):
    spec = _port(tiny, speculate_k=2, draft="table")
    assert spec.core.executable_bounds()["verify"] == len(spec.batch_buckets)
    assert _port(tiny).core.executable_bounds()["verify"] == 0
    _run(spec, *_wave_a())
    _run(spec, *_wave_a(), uid0=50)        # the same bucket: no new step
    st = spec.stats
    assert (st.decode_compiles, st.verify_compiles) == (0, 1)
    assert st.jit_cache_entries == st.prefill_compiles + 1


def test_spec_options_are_checked(tiny):
    jmod = build_model(get_config("rwkv6_7b").reduced())
    tmod = tbuild(tget("rwkv6_7b").reduced())
    assert not tmod.supports_verify
    tp = tmod.init(torch.Generator().manual_seed(0), device="cpu")
    jp = jmod.init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="verify protocol"):
        tserve.ExpertEngine(tmod, tp, device="cpu", speculate_k=2)
    with pytest.raises(ValueError, match="verify protocol"):
        ExpertEngine(jmod, jp, speculate_k=2)
    with pytest.raises(ValueError, match="speculate_k > 0"):
        _port(tiny, draft="table")
    with pytest.raises(ValueError, match=">= 0"):
        _port(tiny, speculate_k=-1)
    with pytest.raises(ValueError, match="unknown draft"):
        _port(tiny, speculate_k=2, draft="oracle")


# -- the server ----------------------------------------------------------------


def test_routed_server_speculates_like_the_reference(tiny):
    """A two-expert RoutedServer(speculate_k=2) in both packages: equal
    routes and tokens, serial and overlapped; ``speculative_stats``
    equal; the draft's identity in the metrics tree; a SchedulerConfig
    whose speculate_k disagrees with an engine's raises."""
    jmod, tmod, jp, tp = tiny
    rng = np.random.default_rng(4)
    names = ["a", "b"]
    aes = [init_ae(jax.random.PRNGKey(60 + i)) for i in range(2)]
    data = [(rng.random((48, 784), dtype=np.float32), np.arange(48) % 3)
            for _ in names]
    jm = build_matcher(aes, names, data)
    tm = tcore.ExpertMatcher(
        to_torch(jax.device_get(jm.bank_params), device="cpu"),
        to_torch(jax.device_get(jm.bank_states), device="cpu"), names,
        to_torch(np.asarray(jm.centroids), device="cpu"),
        to_torch(np.asarray(jm.centroid_mask), device="cpu"))
    traffic = [(u, rng.random(784, dtype=np.float32),
                rng.integers(0, 100, size=int(rng.integers(3, 9)))
                .astype(np.int32), int(rng.integers(6, 15)))
               for u in range(8)]
    for executor in ("serial", "overlapped"):
        jreg, treg = ExpertRegistry(), tcore.ExpertRegistry()
        for n in names:
            jreg.add(n, ExpertEngine(jmod, jp, speculate_k=2, draft="table",
                                     **GEOM))
            treg.add(n, tserve.ExpertEngine(tmod, tp, speculate_k=2,
                                            draft="table", device="cpu",
                                            **GEOM))
        jsrv = RoutedServer(jm, jreg, max_batch=4, executor=executor,
                            speculate_k=2)
        tsrv = tserve.RoutedServer(tm, treg, max_batch=4, executor=executor,
                                   speculate_k=2, device="cpu")
        want = jsrv.serve([Request(u, f, p, m) for u, f, p, m in traffic])
        got = tsrv.serve([tserve.Request(u, f, p, m)
                          for u, f, p, m in traffic])
        for g, w in zip(got, want):
            assert (g.uid, g.expert, g.fine_class) == \
                (w.uid, w.expert, w.fine_class)
            np.testing.assert_array_equal(g.tokens, w.tokens,
                                          err_msg=str(g.uid))
        assert tsrv.scheduler.speculative_stats() == \
            jsrv.scheduler.speculative_stats()
        assert tsrv.scheduler.speculative_stats()["verify_steps"] > 0
        snap = tsrv.snapshot()
        assert snap["engines"]["shard0"]["draft"] == \
            {"name": "table", "kind": "BigramTableDraft"}
        assert snap["engines"]["shard0"]["verify_steps"] == \
            treg[0].backend.stats.verify_steps
    with pytest.raises(ValueError, match="speculate_k"):
        tserve.RoutedServer(tm, treg, speculate_k=4, device="cpu")


# -- drafts and the verify window ----------------------------------------------


def test_table_observe_last_write_wins_as_in_the_reference():
    """Repeated window tokens with different successors: the port's table
    equals the one XLA's CPU scatter leaves (the last write in row-major
    order wins), masked columns land on the sentinel row; then the
    chained proposals from the learnt table equal the reference's."""
    V = 64
    window = np.array([[1, 2, 1], [1, 3, 2]], np.int32)
    greedy = np.array([[10, 20, 30], [40, 50, 60]], np.int32)
    for adv in ([3, 3], [2, 3], [3, 1], [0, 2]):
        adv = np.array(adv, np.int32)
        jd = JTable(V)
        want = jd.observe({"table": jnp.arange(V + 1, dtype=jnp.int32)},
                          jnp.asarray(window), jnp.asarray(greedy),
                          jnp.asarray(adv))["table"]
        td = tserve.BigramTableDraft(V)
        st = td.init_state(torch.Generator(), 1)
        td.observe({"table": st["table"][0]}, torch.from_numpy(window),
                   torch.from_numpy(greedy), torch.from_numpy(adv))
        np.testing.assert_array_equal(st["table"][0].numpy(),
                                      np.asarray(want), err_msg=str(adv))
        # and the chained proposals from the learnt table
        tok = np.array([1, 2, 3, 40], np.int32)
        np.testing.assert_array_equal(
            td.propose({"table": st["table"][0]}, torch.from_numpy(tok), 3)
            .numpy(),
            np.asarray(jd.propose({"table": want}, jnp.asarray(tok), 3)))


def test_mlp_draft_proposals_equal_the_reference(tiny):
    """The mlp draft over the reference's own state: the same k-token
    chains (its argmax over the padded vocab) from the same tokens."""
    jmod, _, _, _ = tiny
    V = jmod.cfg.padded_vocab
    jd, td = JMLP(V), tserve.MLPBaselineDraft(V)
    jst = jd.init_state(jax.random.PRNGKey(3), 2)
    tst = td.init_state(torch.Generator().manual_seed(3), 2)
    copy_to_torch(tst, jax.device_get(jst))
    tok = np.random.default_rng(0).integers(0, V, size=6).astype(np.int32)
    for e in range(2):
        want = jd.propose(jax.tree_util.tree_map(lambda a: a[e], jst),
                          jnp.asarray(tok), 4)
        got = td.propose(tree_map(lambda a: a[e], tst),
                         torch.from_numpy(tok), 4)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _prefilled(tiny, toks):
    """Both models' ring caches after a prefill of ``toks`` (B, S) at
    capacity MAX_LEN, as a verify takes them: {k, v}, per-row pos and t."""
    jmod, tmod, jp, tp = tiny
    _, jc = jmod.prefill(jp, {"tokens": jnp.asarray(toks)},
                         capacity=MAX_LEN)
    _, tc = tmod.prefill(tp, {"tokens": torch.from_numpy(toks)},
                         capacity=MAX_LEN)
    B = toks.shape[0]
    jpos = jnp.broadcast_to(jc["pos"], (B, MAX_LEN))
    jt = jnp.broadcast_to(jc["t"], (B,))
    tpos = tc["pos"].expand(B, -1).clone()
    tt = tc["t"].expand(B).clone()
    return ({"k": jc["k"], "v": jc["v"]}, jpos, jt,
            {"k": tc["k"], "v": tc["v"]}, tpos, tt)


def test_verify_window_with_the_id_padded_vocab(tiny):
    """The always-wrong draft's id ``padded_vocab``, one past the last
    embedding row: JAX's gather clamps it, the port's verify clamps it
    explicitly (an unclamped lookup raises on the CPU and asserts on
    the card). Greedy tokens and the written K/V equal the reference's,
    and equal a window holding the last row's id itself."""
    jmod, tmod, jp, tp = tiny
    V = tmod.cfg.padded_vocab
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 100, size=(2, 8)).astype(np.int32)
    window = np.array([[5, V, V], [7, 9, V]], np.int32)
    jcache, jpos, jt, tcache, tpos, tt = _prefilled(tiny, toks)
    # jax arrays, not the host copy: the clamp is jax's gather's
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    want, jnew = jmod.verify(jp, jcache, jpos, jt,
                             {"tokens": jnp.asarray(window)})
    got, tnew = tmod.verify(tp, tcache, tpos, tt,
                            {"tokens": torch.from_numpy(window)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(tnew["k"].numpy(), np.asarray(jnew["k"]),
                               rtol=2e-5, atol=2e-6)
    _, _, _, tcache2, tpos2, tt2 = _prefilled(tiny, toks)
    same, _ = tmod.verify(tp, tcache2, tpos2, tt2, {"tokens": torch.from_numpy(
        np.where(window == V, V - 1, window).astype(np.int32))})
    np.testing.assert_array_equal(got.numpy(), same.numpy())


def test_verify_equals_chained_decode(tiny):
    """One verify of a 4-token window, rows at different positions,
    gives each row the greedy tokens four chained one-token decodes
    give, and leaves pos / t unchanged (the engine rolls them)."""
    _, tmod, _, tp = tiny
    rng = np.random.default_rng(6)
    toks = rng.integers(0, 100, size=(2, 8)).astype(np.int32)
    _, _, _, tcache, tpos, tt = _prefilled(tiny, toks)
    _, chain = tmod.prefill(tp, {"tokens": torch.from_numpy(toks)},
                            capacity=MAX_LEN)
    window = rng.integers(0, 100, size=(2, 4)).astype(np.int32)
    want = []
    for i in range(4):
        logits, chain = tmod.decode(tp, chain, {"token": torch.from_numpy(
            window[:, i:i + 1])})
        want.append(logits.argmax(-1))
    pos0, t0 = tpos.clone(), tt.clone()
    got, _ = tmod.verify(tp, tcache, tpos, tt,
                         {"tokens": torch.from_numpy(window)})
    np.testing.assert_array_equal(got.numpy(),
                                  torch.stack(want, 1).numpy())
    assert torch.equal(tpos, pos0) and torch.equal(tt, t0)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def _waves(seed=0, n=3):
    """Waves of two rows at bucket 2: prompts of 4-13 tokens, 8-14 new."""
    rng = np.random.default_rng(seed)
    return [([2 * i, 2 * i + 1],
             [rng.integers(0, 100, size=int(rng.integers(4, 14)))
              for _ in range(2)], [14 - i, 8 + i]) for i in range(n)]


def _run_all(eng, waves, *, defer):
    for uids, prompts, max_new in waves:
        eng.admit(uids, prompts, max_new, defer=defer)
    while eng.n_active:
        if not eng.tick(defer=defer):
            eng.harvest()
    if defer:
        eng.harvest()
    return dict(eng.poll())


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_cuda_verify_graph_equals_eager_and_cpu(cuda, layout):
    """A reduced f32 dense expert, three resident spec waves at bucket 2
    (ring waves swap through the verify graph's state): the captured
    verify graph's tokens equal the eager step's and the CPU's plain
    tokens; one verify graph, captured once; no decode kernel runs (no
    wave falls back)."""
    model = tbuild(tget("llama3_2_1b").reduced(name="spec-card"))
    cpu = model.init(torch.Generator().manual_seed(9), device="cpu")
    params = _to(cpu, "cuda")
    waves = _waves(seed=1)
    want = _run_all(tserve.ExpertEngine(model, cpu, max_len=64,
                                        kv_layout=layout, device="cpu"),
                    waves, defer=False)
    out = {}
    for capture in (True, False):
        eng = tserve.ExpertEngine(model, params, max_len=64,
                                  kv_layout=layout, speculate_k=4,
                                  draft="table", device=cuda,
                                  capture_decode=capture)
        ops.reset_launches()
        out[capture] = _run_all(eng, waves, defer=True)
        torch.cuda.synchronize()
        st = eng.stats
        assert st.verify_compiles == 1 and st.decode_compiles == 0
        assert st.verify_captured == int(capture)
        assert st.spec_fallback_waves == 0 and st.verify_steps > 0
        assert ops.launches()["decode_attention"] == 0
        assert ops.launches()["paged_decode_attention"] == 0
        if layout == "ring":
            assert st.decode_swaps > 0
    for u in want:
        np.testing.assert_array_equal(out[True][u], want[u], err_msg=str(u))
        np.testing.assert_array_equal(out[False][u], want[u],
                                      err_msg=str(u))
