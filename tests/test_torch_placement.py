"""The port's banked placement against the reference's, on the CPU.

``plan_placement`` groups the same experts as JAX's; a banked
``RoutedServer`` (ring and paged, serial and overlapped) gives JAX's
banked server's expert, fine class, shard and tokens for every uid, the
same ``host_blocks``, and the port's own per-engine server's tokens; a
speculative bank (E 2, the ``mlp`` draft, ring k 2 and paged k 4, the
reference suite's ``test_speculative_identity_banked``) gives JAX's
tokens and spec counters with the draft state carried across by
``bridge.copy_to_torch``. Weights are ``smollm_135m`` reduced, made by
JAX from a seed and bridged with ``bridge.to_torch``.
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
from repro_torch import core as tcore
from repro_torch import serve as tserve
from repro_torch.bridge import copy_to_torch, to_torch
from repro_torch.configs import get_config as tget
from repro_torch.models import build_model as tbuild

SPEC = ("verify_steps", "tokens_drafted", "tokens_accepted",
        "spec_fallback_waves")


@pytest.fixture(scope="module")
def fleet():
    """A JAX-trained matcher over two datasets and its port copy, the
    reduced model in both packages, and two experts' weights."""
    bench = load_benchmark(names=["mnist", "har"], n_per_dataset=400, seed=0)
    names = list(bench)
    aes, _ = train_bank([(n, bench[n]["server"][0]) for n in names],
                        epochs=4, batch_size=64)
    cents = [(bench[n]["server"][0], bench[n]["server"][1]) for n in names]
    jm = build_matcher(aes, names, cents)
    tm = tcore.ExpertMatcher(
        to_torch(jax.device_get(jm.bank_params), device="cpu"),
        to_torch(jax.device_get(jm.bank_states), device="cpu"), names,
        to_torch(np.asarray(jm.centroids), device="cpu"),
        to_torch(np.asarray(jm.centroid_mask), device="cpu"))
    jmod = build_model(get_config("smollm_135m").reduced(name="placed"))
    tmod = tbuild(tget("smollm_135m").reduced(name="placed"))
    params = [jax.device_get(jmod.init(jax.random.PRNGKey(s)))
              for s in (0, 1)]
    return bench, names, jm, tm, jmod, tmod, params


def _regs(fleet, kv="ring", **kw):
    """(JAX registry, port registry) of one engine per expert, equal
    weights."""
    _, names, _, _, jmod, tmod, params = fleet
    jreg, treg = ExpertRegistry(), tcore.ExpertRegistry()
    for n, p in zip(names, params):
        jreg.add(n, ExpertEngine(jmod, p, max_len=64, kv_layout=kv, **kw))
        treg.add(n, tserve.ExpertEngine(tmod, to_torch(p, device="cpu"),
                                        max_len=64, kv_layout=kv,
                                        device="cpu", **kw))
    return jreg, treg


def _traffic(fleet, rng, n, uid0=0, shared=None):
    bench, names = fleet[0], fleet[1]
    out = []
    for uid in range(uid0, uid0 + n):
        x, _ = bench[names[uid % 2]]["client_a"]
        if shared is not None and uid % 3 == 0:
            prompt = shared
        else:
            prompt = rng.integers(0, 100, size=int(rng.integers(1, 40)))
        out.append((uid, x[uid % 60], prompt.astype(np.int32),
                    int(rng.integers(1, 7))))
    return out


# -- planning -----------------------------------------------------------------


def test_plan_placement_groups_as_the_reference(fleet):
    """Two experts of one spec bank together; an expert of another width
    stays a singleton shard; the plan, the rebound backends and the bank
    agree with JAX's plan on the same registry."""
    _, names, _, _, jmod, tmod, params = fleet
    jreg, treg = _regs(fleet)
    jodd = build_model(get_config("smollm_135m").reduced(name="odd",
                                                         d_model=64))
    todd = tbuild(tget("smollm_135m").reduced(name="odd", d_model=64))
    p_odd = jax.device_get(jodd.init(jax.random.PRNGKey(9)))
    jreg.add("odd", ExpertEngine(jodd, p_odd, max_len=64))
    treg.add("odd", tserve.ExpertEngine(todd, to_torch(p_odd, device="cpu"),
                                        max_len=64, device="cpu"))
    spec0 = treg[0].backend.spec
    jp, tp = jplan(jreg), tserve.plan_placement(treg)
    assert tp.shard_of == jp.shard_of
    assert [(s.experts, s.banked) for s in tp.shards] == \
        [(s.experts, s.banked) for s in jp.shards]
    banked = [s for s in tp.shards if s.banked]
    assert len(banked) == 1 and banked[0].experts == (0, 1)
    for e in (0, 1):
        be = treg[e].backend
        assert isinstance(be, tserve.BankMember) and be.local == e
        assert be.pad_shape(3, 9) == (4, 16)
        assert treg[e].spec == spec0
    assert isinstance(treg[2].backend, tserve.ExpertEngine)
    bank = banked[0].bank
    assert isinstance(bank, tserve.BankedEngine) and bank.n_experts == 2
    assert tp.describe(treg.names).splitlines()[0] == \
        "shard 0 [bank]: mnist, har"


def test_bank_uses_member_tensors_and_one_core(fleet):
    """The bank holds its members' params tensors (no copy), and
    ExpertEngine and BankedEngine are shims over one EngineCore."""
    _, treg = _regs(fleet)
    engines = [treg[e].backend for e in range(2)]
    ptrs = [e.params["embed"].data_ptr() for e in engines]
    plan = tserve.plan_placement(treg)
    bank = plan.shards[0].bank
    assert [p["embed"].data_ptr() for p in bank.params] == ptrs
    assert type(bank.core) is type(engines[0].core) is tserve.EngineCore
    assert bank.core.n_experts == 2 and engines[0].core.n_experts == 1


def test_spec_bankability_and_refusals(fleet):
    """Capacity-dispatch MoE specs are not bankable (as the reference's,
    whose planner leaves such engines solo); a mesh that does not divide
    a bank raises the reference's ``ValueError``, an object that is no
    mesh an ``AttributeError``."""
    _, treg = _regs(fleet)
    cfg = tget("mixtral_8x22b").reduced(name="moe-spec")
    assert cfg.n_experts and cfg.moe_impl == "dispatch"
    spec = tcore.ExpertSpec(arch=cfg.replace(name=""), max_len=64,
                            len_buckets=(8, 64), batch_buckets=(1, 16))
    assert not spec.bankable and treg[0].backend.spec.bankable
    with pytest.raises(AttributeError, match="shape"):
        tserve.plan_placement(treg, mesh=object())
    with pytest.raises(ValueError, match="must divide the bank's 2 experts"):
        tserve.BankedEngine(fleet[5], [treg[e].backend.params
                                       for e in range(2)],
                            mesh=types.SimpleNamespace(
                                shape={"expert": 3}, devices=("cpu",) * 3),
                            device="cpu")
    with pytest.raises(ValueError, match="at least one expert"):
        tserve.BankedEngine(fleet[5], [], device="cpu")


def test_forgotten_placement_plan_fails_fast(fleet):
    """A planned registry served without its plan, a plan paired with
    another registry, and a registry grown after planning all raise up
    front."""
    tm = fleet[3]
    _, reg = _regs(fleet)
    plan = tserve.plan_placement(reg)
    with pytest.raises(ValueError, match="placement"):
        tserve.RoutedServer(tm, reg, device="cpu")
    with pytest.raises(ValueError, match="already bank-placed"):
        tserve.plan_placement(reg)
    _, other = _regs(fleet)
    tserve.plan_placement(other)
    with pytest.raises(ValueError, match="does not match registry"):
        tserve.RoutedServer(tm, other, placement=plan, device="cpu")
    reg.add("late", None)
    with pytest.raises(ValueError, match="does not cover"):
        tserve.Scheduler(None, reg, placement=plan)


def test_bank_graph_count_is_per_bank_not_per_expert(fleet):
    """The bank's decode steps (one ``DecodeGraph`` per batch bucket) and
    prefill shapes are bounded by its own ladders in all; replaying the
    same traffic makes no new one."""
    tm = fleet[3]
    _, reg = _regs(fleet)
    plan = tserve.plan_placement(reg)
    srv = tserve.RoutedServer(tm, reg, max_batch=4, placement=plan,
                              device="cpu")
    rng = np.random.default_rng(8)
    traffic = _traffic(fleet, rng, 30)
    resps = srv.serve([tserve.Request(u, f, p, m) for u, f, p, m in traffic])
    assert len(resps) == 30
    bank = plan.shards[0].bank
    bounds = bank.core.executable_bounds()
    assert bank.stats.prefill_compiles <= bounds["prefill"]
    assert 0 < bank.stats.decode_compiles <= len(bank.batch_buckets)
    before = bank.stats.jit_cache_entries
    srv.serve([tserve.Request(100 + u, f, p, m) for u, f, p, m in traffic])
    assert bank.stats.jit_cache_entries == before


# -- tokens against the reference ---------------------------------------------


@pytest.mark.parametrize("executor", ["serial", "overlapped"])
@pytest.mark.parametrize("kv", ["ring", "paged"])
def test_banked_server_matches_reference(fleet, kv, executor):
    """A banked server in both packages on the same traffic (a shared
    prompt every third request, so a paged bank dedups): equal expert,
    fine class, shard and tokens per uid and equal bank ``host_blocks``;
    the port's per-engine server (serial) gives the same tokens."""
    _, _, jm, tm, *_ = fleet
    jreg, treg = _regs(fleet, kv)
    _, solo = _regs(fleet, kv)
    jp, tp = jplan(jreg), tserve.plan_placement(treg)
    jsrv = RoutedServer(jm, jreg, max_batch=4, placement=jp,
                        executor=executor)
    tsrv = tserve.RoutedServer(tm, treg, max_batch=4, placement=tp,
                               executor=executor, device="cpu")
    ssrv = tserve.RoutedServer(tm, solo, max_batch=4, executor="serial",
                               device="cpu")
    rng = np.random.default_rng(13)
    traffic = _traffic(fleet, rng, 14, shared=rng.integers(0, 100, 30))
    want = jsrv.serve([Request(u, f, p, m) for u, f, p, m in traffic])
    got = tsrv.serve([tserve.Request(u, f, p, m) for u, f, p, m in traffic])
    solo_got = ssrv.serve([tserve.Request(u, f, p, m)
                           for u, f, p, m in traffic])
    for g, w, s in zip(got, want, solo_got):
        assert (g.uid, g.expert, g.fine_class, g.shard) == \
            (w.uid, w.expert, w.fine_class, w.shard)
        assert g.shard == tp.shard_of[treg.names.index(g.expert)]
        np.testing.assert_array_equal(g.tokens, w.tokens, err_msg=str(g.uid))
        np.testing.assert_array_equal(g.tokens, s.tokens, err_msg=str(g.uid))
    jb, tb = jp.shards[0].bank, tp.shards[0].bank
    assert tb.stats.host_blocks == jb.stats.host_blocks
    assert tb.stats.decode_steps == jb.stats.decode_steps
    if kv == "paged":
        assert tb.stats.prefix_dup_rows == jb.stats.prefix_dup_rows >= 1
        tb.core.pool.check()


def _banked_waves():
    rng = np.random.default_rng(3)
    g = lambda ns: [rng.integers(0, 100, size=n).astype(np.int32)
                    for n in ns]
    return {0: ([0, 1, 2], g((5, 8, 6)), [6, 4, 7]),
            1: ([3, 4], g((7, 4)), [5, 6])}


def _run_banked(engine, groups):
    engine.admit(groups)
    out = {}
    while engine.has_pending:
        engine.tick()
        for local, uid, seq in engine.poll():
            out[(local, uid)] = seq
    return out


@pytest.fixture(scope="module")
def spec_pair():
    """The reference suite's speculative geometry (``MAX_LEN`` 32, batch
    buckets 1, 2, 4) and two experts' weights (seeds 7 and 8)."""
    jmod = build_model(get_config("smollm_135m").reduced(name="spec-diff"))
    tmod = tbuild(tget("smollm_135m").reduced(name="spec-diff"))
    params = [jax.device_get(jmod.init(jax.random.PRNGKey(s)))
              for s in (7, 8)]
    return jmod, tmod, params


@pytest.mark.parametrize("kv,k", [("ring", 2), ("paged", 4)])
def test_speculative_bank_matches_reference(spec_pair, kv, k):
    """E 2 spec banks (``mlp`` draft, its state carried over from JAX's
    bank): tokens equal JAX's spec bank's and the port's plain bank's,
    spec counters and ``host_blocks`` equal JAX's, no fallback wave."""
    jmod, tmod, params = spec_pair
    geom = dict(max_len=32, min_len_bucket=8, batch_buckets=(1, 2, 4))
    jb = BankedEngine(jmod, params, kv_layout=kv, speculate_k=k,
                      draft="mlp", **geom)
    tp = [to_torch(p, device="cpu") for p in params]
    tb = tserve.BankedEngine(tmod, tp, kv_layout=kv, speculate_k=k,
                             draft="mlp", device="cpu", **geom)
    copy_to_torch(tb.core.draft_state, [jax.device_get(jb.core.draft_state)])
    plain = tserve.BankedEngine(tmod, tp, device="cpu", **geom)
    want = _run_banked(jb, _banked_waves())
    got = _run_banked(tb, _banked_waves())
    ref = _run_banked(plain, _banked_waves())
    assert got.keys() == want.keys() == ref.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))
        np.testing.assert_array_equal(got[key], ref[key], err_msg=str(key))
    for name in SPEC + ("host_blocks",):
        assert getattr(tb.stats, name) == getattr(jb.stats, name), name
    assert tb.stats.verify_steps > 0 and tb.stats.spec_fallback_waves == 0
    assert tb.stats.verify_compiles == 1


def test_plan_placement_passes_speculation_through(spec_pair):
    """Spec engines bank into a spec bank (same k, same draft); a plain
    and a spec engine of one model do not share a bank."""
    _, tmod, params = spec_pair
    reg = tcore.ExpertRegistry()
    for i, p in enumerate(params * 2):
        reg.add(f"e{i}", tserve.ExpertEngine(
            tmod, to_torch(p, device="cpu"), max_len=32, device="cpu",
            **({"speculate_k": 2, "draft": "table"} if i < 2 else {})))
    plan = tserve.plan_placement(reg)
    banks = [s.bank for s in plan.shards if s.banked]
    assert [s.experts for s in plan.shards] == [(0, 1), (2, 3)]
    assert (banks[0].core.speculate_k, banks[0].core.draft_name) == \
        (2, "table")
    assert banks[1].core.speculate_k == 0
    # uids 0-3 go to the spec bank's members, 4-7 to the plain bank's on
    # the same weights and prompts: equal tokens
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 100, size=6).astype(np.int32)
               for _ in range(4)]
    sched = tserve.Scheduler(None, reg, tserve.SchedulerConfig(max_batch=4),
                             placement=plan)
    sched.submit([tserve.Request(u, np.zeros(784, np.float32), prompts[u % 4],
                                 5, expert=(u % 2) + 2 * (u // 4))
                  for u in range(8)])
    out = {r.uid: r for r in sched.drain()}
    for u in range(4):
        assert out[u].expert == f"e{u % 2}"
        assert out[u + 4].expert == f"e{2 + u % 2}"
        np.testing.assert_array_equal(out[u].tokens, out[u + 4].tokens)
    assert banks[0].stats.verify_steps > 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kv,kernel", [("ring", "decode_attention"),
                                       ("paged", "paged_decode_attention")])
def test_cuda_bank_graph_tokens_equal_eager_and_cpu(cuda, kv, kernel):
    """A reduced f32 llama bank of 3 on the card: replayed graph tokens
    equal the eager step's and the CPU bank's, one graph per bucket for
    the whole bank, and the decode kernel launched E x n_layers times a
    step (every member, rows or not)."""
    from repro_torch.kernels import ops
    model = tbuild(tget("llama3_2_1b").reduced(name="bank-card"))
    cpu = [model.init(torch.Generator().manual_seed(s), device="cpu")
           for s in range(3)]
    dev = [{k: _to(v, cuda) for k, v in p.items()} for p in cpu]
    rng = np.random.default_rng(4)
    groups = {0: ([0, 1], [rng.integers(0, 300, 9), rng.integers(0, 300, 5)],
                  [6, 4]),
              2: ([2], [rng.integers(0, 300, 12)], [7])}
    out = {}
    for capture in (True, False):
        bank = tserve.BankedEngine(model, dev, max_len=64, kv_layout=kv,
                                   device=cuda, capture_decode=capture)
        ops.reset_launches()
        out[capture] = _run_banked(bank, groups)
        torch.cuda.synchronize()
        steps = bank.stats.decode_steps
        assert ops.launches()[kernel] == 3 * model.cfg.n_layers * steps
        assert bank.stats.decode_compiles == 1
        assert bank.stats.decode_captured == int(capture)
    want = _run_banked(tserve.BankedEngine(model, cpu, max_len=64,
                                           kv_layout=kv, device="cpu"),
                       groups)
    for key in want:
        np.testing.assert_array_equal(out[True][key], out[False][key])
        np.testing.assert_array_equal(out[True][key], want[key])


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
