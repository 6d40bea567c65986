"""The port's MoE FFN and the MoE / VLM families of its DecoderLM against
the reference on bridged weights, f32 reduced configs on the CPU.

- ``models/moe.py``: ``_route``, ``_aux_loss``, ``_moe_dispatch`` (with
  drops at capacity factor 0.5 and 1.25, and on exact router ties, where
  ``jax.lax.top_k`` takes the lower index) and ``_moe_dense`` against
  the reference's functions at rtol 2e-5; expert ids, capacity and the
  dropped assignments equal.
- ``olmoe_1b_7b`` and ``mixtral_8x22b`` reduced (4 experts, top 2):
  last-position prefill logits and caches, per-step decode logits and
  16-token greedy continuations, at the default factor and at 0.5
  (drops certain), and with ``moe_impl="dense"``; a sliding-window ring
  decoded past its window.
- ``loss`` with its gradients (aux included) and one AdamW step against
  the reference's; ``moe_impl="dense"`` against the reference's dense
  oracle and against dispatch at a dropless factor.
- ``internvl2_26b`` reduced (8 stub embeds): loss, prefill with stubs and
  decode against the reference's; the loss ignores stub positions.
- ``cuda``: two launches of a MoE decode step are bit-equal, and its
  tokens equal the CPU's.

Gradients are held per leaf at ``|got - want| <= 2e-5 * (|want| +
max|want|)``, as ``tests/test_torch_train_loop.py`` holds dense ones.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro.configs import get_config
from repro.models import build_model
from repro.models import moe as jmoe
from repro.optim import constant_lr as jconstant_lr
from repro.train.loop import init_train_state as jinit_state
from repro.train.loop import make_train_step as jmake_step
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config as tget
from repro_torch.models import build_model as tbuild
from repro_torch.models import moe as tmoe
from repro_torch.optim import constant_lr
from repro_torch.train import make_train_step
from repro_torch.tree import leaves, value_and_grad

TOL = 2e-5
LR = 1e-3
#: (arch, reduced overrides)
CONFIGS = {
    "olmoe": ("olmoe_1b_7b", {}),
    "olmoe-drop": ("olmoe_1b_7b", {"moe_capacity_factor": 0.5}),
    "olmoe-dense": ("olmoe_1b_7b", {"moe_impl": "dense"}),
    "mixtral": ("mixtral_8x22b", {}),
}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def _pair(key):
    name, kw = CONFIGS[key]
    jm = build_model(get_config(name).reduced(**kw))
    tm = tbuild(tget(name).reduced(**kw))
    jp = jax.device_get(jm.init(jax.random.PRNGKey(3)))
    return jm, jp, tm, to_torch(jp, device="cpu"), jax.jit(jm.decode)


def _tokens(vocab, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(B, S)).astype(np.int32)


def _dropped(ids, cfg, T):
    """Assignments a capacity dispatch of T tokens drops (numpy, from the
    reference's expert ids)."""
    flat = np.asarray(ids).reshape(-1)
    cap = tmoe.capacity(cfg, T, False)
    seen = np.zeros(cfg.n_experts, np.int64)
    n = 0
    for e in flat:
        n += seen[e] >= cap
        seen[e] += 1
    return n


# ---------------------------------------------------------------------------
# the MoE module's functions
# ---------------------------------------------------------------------------


def _moe_params(cfg, tie=False):
    p = jax.device_get(jmoe.init_moe(jax.random.PRNGKey(0), cfg,
                                     jnp.float32))
    if tie:
        # experts 1-3 score exactly 0: every token ties them, and expert 0
        # wins or loses against all three
        p = dict(p, router=np.concatenate(
            [p["router"][:, :1], np.zeros_like(p["router"][:, 1:])], 1))
    return p


@pytest.mark.parametrize("factor,tie", [(0.5, False), (1.25, False),
                                        (1.25, True)],
                         ids=["factor0.5", "factor1.25", "ties"])
def test_moe_functions_match_reference(factor, tie):
    cfg = get_config("olmoe_1b_7b").reduced(moe_capacity_factor=factor)
    tcfg = tget("olmoe_1b_7b").reduced(moe_capacity_factor=factor)
    jp = _moe_params(cfg, tie)
    tp = to_torch(jp, device="cpu")
    x = np.random.default_rng(1).standard_normal(
        (3, 20, cfg.d_model)).astype(np.float32)
    x2 = x.reshape(-1, cfg.d_model)
    jw, jids, jprobs = jmoe._route(jp, jnp.asarray(x2), cfg)
    tw, tids, tprobs = tmoe._route(tp, torch.from_numpy(x2), tcfg)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _close(tw, jw)
    _close(tprobs, jprobs)
    if tie:
        p = np.asarray(jprobs)
        assert (p[:, 1] == p[:, 2]).all() and (p[:, 2] == p[:, 3]).all()
        assert set(np.asarray(jids)[:, 0]) == {0, 1}
    _close(tmoe._aux_loss(tprobs, tids, 4),
           jmoe._aux_loss(jprobs, jids, 4))
    T = x2.shape[0]
    n_drop = _dropped(jids, tcfg, T)
    if factor < 1:
        assert n_drop > 0
    for dropless in (False, True):
        want = jmoe._moe_dispatch(jp, jnp.asarray(x2), jw, jids, cfg,
                                  dropless)
        got = tmoe._moe_dispatch(tp, torch.from_numpy(x2), tw, tids, tcfg,
                                 dropless)
        _close(got, want)
    _close(tmoe._moe_dense(tp, torch.from_numpy(x2), tw, tids, tcfg),
           jmoe._moe_dense(jp, jnp.asarray(x2), jw, jids, cfg))
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), cfg)
    ty, taux = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    _close(ty, jy)
    _close(taux, jaux)
    _, none = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg, with_aux=False)
    assert none is None


def test_dispatch_drop_order_is_row_major_then_k():
    """Capacity 1 per expert: the first assignment to each expert, in
    (token, choice) order, is the one kept; everything else adds 0."""
    cfg = tget("olmoe_1b_7b").reduced(moe_capacity_factor=0.01)
    D = cfg.d_model
    x = torch.randn(6, D, generator=torch.Generator().manual_seed(0))
    ids = torch.tensor([[2, 0], [2, 1], [3, 0], [1, 3], [0, 2], [3, 1]])
    w = torch.full((6, 2), 0.5)
    eye = torch.eye(D)[None].expand(4, D, D).contiguous()
    # experts as the identity map (SwiGLU of identity weights):
    # silu(x) * x, so the kept tokens are visible in the output
    p = {"w_gate": eye, "w_up": eye, "w_down": eye}
    y = tmoe._moe_dispatch(p, x, w, ids, cfg)
    f = torch.nn.functional.silu(x) * x
    # kept: (t0, e2), (t0, e0), (t1, e1), (t2, e3); every later one drops
    want = torch.zeros_like(x)
    want[0] = f[0]
    want[1] = 0.5 * f[1]
    want[2] = 0.5 * f[2]
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# model level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", list(CONFIGS))
def test_prefill_and_decode_logits_match_reference(key):
    """Prefill logits and cache, then 8 teacher-forced decode steps'
    logits (the reference's greedy token fed to both)."""
    jm, jp, tm, tp, jdec = _pair(key)
    toks = _tokens(jm.cfg.vocab_size, 3, 40, 1)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, capacity=64)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, capacity=64)
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    for _ in range(8):
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        jl, jc = jdec(jp, jc, {"token": jnp.asarray(tok)})
        tl, tc = tm.decode(tp, tc, {"token": torch.from_numpy(tok)})
        _close(tl, jl)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("key", ["olmoe", "olmoe-drop", "mixtral"])
def test_greedy_continuations_equal(key):
    jm, jp, tm, tp, jdec = _pair(key)
    toks = _tokens(jm.cfg.vocab_size, 2, 30, 2)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    jt, tt = [], []
    for _ in range(16):
        jtok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        ttok = torch.argmax(tl, -1).to(torch.int32)
        jt.append(jtok)
        tt.append(ttok.numpy())
        jl, jc = jdec(jp, jc, {"token": jnp.asarray(jtok[:, None])})
        tl, tc = tm.decode(tp, tc, {"token": ttok[:, None]})
    np.testing.assert_array_equal(np.stack(tt), np.stack(jt))


def test_prefill_drops_change_logits_like_the_reference():
    """At factor 0.5 the prefill drops assignments; its logits differ
    from the dropless factor's, on both sides alike."""
    jm, jp, tm, tp, _ = _pair("olmoe-drop")
    toks = _tokens(jm.cfg.vocab_size, 3, 40, 1)
    x = tm._embed(tp, {"tokens": torch.from_numpy(toks)})
    _, ids, _ = tmoe._route({"router": tp["layers"]["moe"]["router"][0]},
                            x.reshape(-1, x.shape[-1]), tm.cfg)
    assert _dropped(ids.numpy(), tm.cfg, 120) > 0
    free = tbuild(tm.cfg.replace(moe_capacity_factor=2.0))
    a, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    b, _ = free.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert not torch.allclose(a, b, rtol=1e-3, atol=1e-3)


def test_swa_ring_decodes_past_the_window_like_the_reference():
    """Mixtral-style sliding window of 16: a ring of window size, 6
    decode steps past it, against the reference and against the port's
    own teacher-forced prefill (the reference's ``rel < 2e-2``)."""
    cfg = get_config("mixtral_8x22b").reduced(sliding_window=16)
    cfg = cfg.replace(moe_capacity_factor=float(cfg.n_experts)
                      / cfg.experts_per_token)
    jm = build_model(cfg)
    tm = tbuild(tget("mixtral_8x22b").reduced(
        sliding_window=16, moe_capacity_factor=cfg.moe_capacity_factor))
    assert tm.cache_capacity(64) == 16
    jp = jax.device_get(jm.init(jax.random.PRNGKey(5)))
    tp = to_torch(jp, device="cpu")
    full = _tokens(cfg.vocab_size, 2, 40, 5)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(full[:, :34])})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(full[:, :34])})
    assert tc["k"].shape[2] == 16
    jdec = jax.jit(jm.decode)
    for i in range(6):
        tok = full[:, 34 + i][:, None]
        jl, jc = jdec(jp, jc, {"token": jnp.asarray(tok)})
        tl, tc = tm.decode(tp, tc, {"token": torch.from_numpy(tok)})
        _close(tl, jl)
    fl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(full)})
    rel = (tl - fl).abs().max() / (fl.abs().max() + 1e-9)
    assert rel < 2e-2


def test_init_is_the_reference_layout_and_meta_shapes():
    jm, jp, tm, _, _ = _pair("olmoe")
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else
                (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in tree.items()}

    assert shapes(tp) == shapes(jp)
    assert shapes(tm.param_shapes()) == shapes(tp)
    bf = tbuild(tm.cfg.replace(param_dtype="bfloat16")).param_shapes()
    assert bf["layers"]["moe"]["router"].dtype == torch.float32
    assert bf["layers"]["moe"]["w_up"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# training: loss, gradients, one AdamW step
# ---------------------------------------------------------------------------


def _lm_batch(vocab, B, S, seed):
    toks = _tokens(vocab, B, S + 1, seed)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _assert_tree(got, want, tol, label):
    g = [t.float().numpy() for t in leaves(got)]
    w = [np.asarray(a, np.float32)
         for a in jax.tree_util.tree_leaves(want)]
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        bound = tol * (np.abs(b) + np.abs(b).max())
        assert (np.abs(a - b) <= bound).all(), (
            f"{label} leaf {i}: max err {np.abs(a - b).max()}")


@pytest.mark.parametrize("key", ["olmoe", "olmoe-dense"])
def test_loss_grads_and_adamw_step_match_reference(key):
    """Loss, ce, aux, every gradient leaf and ``remat`` (both impls); for
    dispatch also one AdamW step."""
    jm, jp, tm, tp, _ = _pair(key)
    batch = _lm_batch(jm.cfg.vocab_size, 4, 32, 7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, jb)
    (tl, taux), tg = value_and_grad(tm.loss, tp, tb)
    _close(tl, jl)
    _close(taux["ce"], jaux["ce"])
    _close(taux["aux"], jaux["aux"])
    assert float(taux["aux"]) > 0
    _assert_tree(tg, jg, TOL, f"{key} grad")
    # remat recomputes the same forward: the same loss bits
    rm = tbuild(tm.cfg.replace(remat=True))
    (rl, raux), _ = value_and_grad(rm.loss, tp, tb)
    assert float(rl) == float(tl) and float(raux["aux"]) == float(
        taux["aux"])
    if key != "olmoe":
        return
    # one AdamW step (clip 1.0)
    s0 = jinit_state(jm, jax.random.PRNGKey(0))
    s0 = {**s0, "params": jax.tree_util.tree_map(jnp.asarray, jp)}
    js, jmet = jax.jit(jmake_step(jm, lr_fn=jconstant_lr(LR),
                                  microbatches=1))(s0, jb)
    ts0 = {"params": tp, "opt": to_torch(jax.device_get(s0["opt"]),
                                         device="cpu"),
           "step": torch.zeros((), dtype=torch.int32)}
    ts, tmet = make_train_step(tm, lr_fn=constant_lr(LR),
                               microbatches=1)(ts0, tb)
    _close(tmet["loss"], jmet["loss"])
    gn = float(jnp.sqrt(sum(jnp.sum(jnp.square(g))
                            for g in jax.tree_util.tree_leaves(jg))))
    scale = min(1.0, 1.0 / max(gn, 1e-9))
    for a, b, g in zip(leaves(ts["params"]),
                       jax.tree_util.tree_leaves(js["params"]),
                       jax.tree_util.tree_leaves(jg)):
        big = np.abs(np.asarray(g)) * scale >= 1e-5
        np.testing.assert_allclose(a.numpy()[big], np.asarray(b)[big],
                                   rtol=1e-5, atol=1e-7)


def test_dense_impl_matches_oracle_and_dropless_dispatch():
    """``moe_impl="dense"`` is the reference's dense oracle; at a
    dropless factor dispatch computes the same loss (the reference's
    ``test_moe_dispatch_matches_dense_oracle`` bar, rtol 2e-3, here at
    f32 tolerance: the two sum the experts in other orders)."""
    jm, jp, tm, tp, _ = _pair("olmoe-dense")
    batch = _lm_batch(jm.cfg.vocab_size, 2, 32, 9)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want, _ = jax.jit(jm.loss)(jp, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    dense, _ = tm.loss(tp, tb)
    _close(dense, want)
    free = tbuild(tm.cfg.replace(moe_impl="dispatch",
                                 moe_capacity_factor=2.0))
    disp, _ = free.loss(tp, tb)
    np.testing.assert_allclose(float(disp), float(dense), rtol=1e-5)


# ---------------------------------------------------------------------------
# VLM: stub embeddings
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _vlm():
    cfg = get_config("internvl2_26b").reduced()
    jm, tm = build_model(cfg), tbuild(tget("internvl2_26b").reduced())
    assert cfg.n_stub_embeds == 8
    jp = jax.device_get(jm.init(jax.random.PRNGKey(4)))
    return jm, jp, tm, to_torch(jp, device="cpu")


def _stubs(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, cfg.n_stub_embeds, cfg.d_model))
            * 0.1).astype(np.float32)


def test_vlm_loss_matches_reference_and_ignores_stub_positions():
    jm, jp, tm, tp = _vlm()
    batch = _lm_batch(jm.cfg.vocab_size, 2, 24, 3)
    batch["stub_embeds"] = _stubs(jm.cfg, 2, 3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, jb)
    (tl, _), tg = value_and_grad(tm.loss, tp, tb)
    _close(tl, jl)
    _assert_tree(tg, jg, TOL, "vlm grad")
    # the stubs take part in the forward pass; labels never cover them
    tb2 = dict(tb, stub_embeds=tb["stub_embeds"] + 1.0)
    assert abs(float(tm.loss(tp, tb2)[0]) - float(tl)) > 1e-6
    # without stubs the first n_stub_embeds text positions are cut, as
    # the reference cuts them
    nb = {k: v for k, v in batch.items() if k != "stub_embeds"}
    nb["labels"] = nb["labels"][:, jm.cfg.n_stub_embeds:]
    want, _ = jax.jit(jm.loss)(jp, {k: jnp.asarray(v)
                                    for k, v in nb.items()})
    got, _ = tm.loss(tp, {k: torch.from_numpy(v) for k, v in nb.items()})
    _close(got, want)


def test_vlm_prefill_with_stubs_and_decode_match_reference():
    jm, jp, tm, tp = _vlm()
    toks = _tokens(jm.cfg.vocab_size, 2, 20, 6)
    stub = _stubs(jm.cfg, 2, 6)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "stub_embeds": jnp.asarray(stub)}, capacity=48)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                             "stub_embeds": torch.from_numpy(stub)},
                        capacity=48)
    assert int(tc["t"]) == int(jc["t"]) == 28
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    jdec = jax.jit(jm.decode)
    jt, tt = [], []
    for _ in range(8):
        jtok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        ttok = torch.argmax(tl, -1).to(torch.int32)
        jt.append(jtok)
        tt.append(ttok.numpy())
        jl, jc = jdec(jp, jc, {"token": jnp.asarray(jtok[:, None])})
        tl, tc = tm.decode(tp, tc, {"token": ttok[:, None]})
        _close(tl, jl)
    np.testing.assert_array_equal(np.stack(tt), np.stack(jt))
    assert not tm.supports_paged_kv


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["olmoe-drop", "mixtral"])
def test_cuda_moe_decode_is_bit_stable_and_equals_cpu(cuda, key):
    """Two launches of one MoE decode step from the same cache give the
    same bits; greedy tokens on the card equal the CPU's."""
    jm, jp, tm, tp, _ = _pair(key)
    gp = to_torch(jp, device=cuda)
    toks = _tokens(jm.cfg.vocab_size, 3, 40, 1)
    lg, cg = tm.prefill(gp, {"tokens": torch.from_numpy(toks).to(cuda)},
                        capacity=64)
    tok = torch.argmax(lg, -1).to(torch.int32)[:, None]
    pos0, t0 = cg["pos"].clone(), cg["t"].clone()
    outs = []
    for _ in range(2):
        cg["pos"].copy_(pos0)
        cg["t"].copy_(t0)
        outs.append(tm.decode(gp, cg, {"token": tok})[0])
    assert torch.equal(outs[0], outs[1])
    want, got = [], []
    lc, cc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, capacity=64)
    lg, cg = tm.prefill(gp, {"tokens": torch.from_numpy(toks).to(cuda)},
                        capacity=64)
    for _ in range(12):
        a, b = torch.argmax(lc, -1).to(torch.int32), torch.argmax(
            lg, -1).to(torch.int32)
        want.append(a.numpy())
        got.append(b.cpu().numpy())
        lc, cc = tm.decode(tp, cc, {"token": a[:, None]})
        lg, cg = tm.decode(gp, cg, {"token": b[:, None]})
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
