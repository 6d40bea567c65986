"""The port's Mamba2 and Zamba2 against the reference's on the same
weights and inputs: ``causal_conv``, ``conv_step``, ``ssd_step``,
``ssd_chunked`` (a length a multiple of ``chunk`` and not, with and
without ``initial_state``), ``mamba_seq`` and ``mamba_step``; and a
reduced f32 ``zamba2_7b`` of 5 layers with ``attn_every`` 2 (two
applications of the shared block, the last Mamba2 layer after them):
prefill logits and every cache leaf, decode logits past a ring wrap,
greedy continuations, the in-place decode contract, ``param_shapes``,
the loss and its gradients. In bf16 one Mamba2 layer op by op and the
whole model within ``BF16_SCALE_TOL`` of its scale.

The init's ``dt_bias`` = 0 gives dt = softplus(N(0, 1)) ~ 0.3-1.3 and,
with A_log up to log 16, decays of exp(-16 x 0.7) or less a step: the
state carried across 16-token chunks (or given as ``initial_state``)
would vanish from the output, and a wrong carry pass unseen. So the
tests set ``dt_bias`` as a trained checkpoint has it, log(expm1(dt))
for dt in [1e-3, 1e-1] (``trained_like``), where the carry is a large
part of the output; ``D_skip`` and ``ssm_norm`` get noise around their
init's ones, so a misplaced head axis shows.

Tolerances: rtol = atol = 2e-5 for the exact recurrences and the conv;
``ssd_chunked`` and ``mamba_seq`` sum their chunk products and cumsums
in another order than XLA's and are held at rtol = atol = 1e-4 (as
``wkv_chunked``), the observed error printed; model logits and cache
leaves within 1e-4 of the reference's largest magnitude; gradients at
``GRAD_TOL``.
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
from repro.models import mamba2 as jmamba
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config as tget
from repro_torch.models import build_model as tbuild
from repro_torch.models import mamba2 as tmamba
from repro_torch.serve.core import _in_place
from repro_torch.tree import leaves, value_and_grad
from test_torch_moe import _assert_tree
from test_torch_rwkv import BF16_FLIPS, _f32, _scale_close

F32_TOL = 2e-5
CHUNKED_TOL = 1e-4
SCALE_TOL = 1e-4
#: gradients through ``mamba_seq``: XLA's own f32 gradients of this model
#: sit up to 6.9e-5 (of |want| + max|want|) from a float64 evaluation of
#: it, the port's up to 2.6e-5, so they are 9.3e-5 apart at most
GRAD_TOL = 2e-4
#: a reduced zamba2_7b with A = 2 applications and a Mamba layer after
#: the last one
SMALL = {"n_layers": 5, "attn_every": 2}


def trained_like(params, seed):
    """``dt_bias`` = log(expm1(dt)) for dt ~ U[1e-3, 1e-1] (softplus
    gives dt back), ``D_skip`` and ``ssm_norm`` 1 + N(0, 0.2): a trained
    checkpoint's scale, where the inter-chunk carry matters."""
    rng = np.random.default_rng(seed)
    layers = dict(params["layers"])
    dt = rng.uniform(1e-3, 1e-1, size=layers["dt_bias"].shape)
    layers["dt_bias"] = np.log(np.expm1(dt)).astype(np.float32)
    for name in ("D_skip", "ssm_norm"):
        shape = layers[name].shape
        layers[name] = (1 + 0.2 * rng.standard_normal(shape)).astype(
            np.float32)
    return {**params, "layers": layers}


@functools.lru_cache(maxsize=None)
def _pair(dtype="float32"):
    kw = {"param_dtype": dtype, "compute_dtype": dtype, **SMALL}
    cfg = get_config("zamba2_7b").reduced(**kw)
    jm = build_model(cfg)
    jp = trained_like(jax.device_get(jm.init(jax.random.PRNGKey(3))), 3)
    tm = tbuild(tget("zamba2_7b").reduced(**kw))
    return cfg, jm, jp, tm, to_torch(jp, device="cpu"), jax.jit(jm.decode)


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _err(got, want):
    return float(np.abs(got.detach().float().numpy()
                        - np.asarray(want, np.float32)).max())


def _scaled(got, want, tol=SCALE_TOL):
    """max |got - want| within ``tol`` of max |want|."""
    want = np.asarray(want, np.float32)
    err, scale = _err(got, want), float(np.abs(want).max())
    assert err <= tol * scale, (err, scale)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _ssd_inputs(B, L, H, P, N, seed):
    """x, dt (trained-like), A (the init's spread), B, C, s0."""
    rng = np.random.default_rng(seed)
    x = _rand(rng, B, L, H, P)
    dt = rng.uniform(1e-3, 1e-1, size=(B, L, H)).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    Bm, Cm = _rand(rng, B, L, 1, N), _rand(rng, B, L, 1, N)
    s0 = _rand(rng, B, H, N, P)
    return x, dt, A, Bm, Cm, s0


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("L", [1, 8, 13])
def test_causal_conv_matches_reference(L):
    rng = np.random.default_rng(L)
    (jx, jw), (tx, tw) = _both(_rand(rng, 2, L, 24), _rand(rng, 4, 24))
    _close(tmamba.causal_conv(tx, tw), jmamba.causal_conv(jx, jw))


def test_conv_step_matches_reference():
    rng = np.random.default_rng(1)
    (jx, jw), (tx, tw) = _both(_rand(rng, 3, 4, 40), _rand(rng, 4, 40))
    _close(tmamba.conv_step(tx, tw), jmamba.conv_step(jx, jw))


def test_ssd_step_matches_reference():
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(2, 1, 6, 16, 8, seed=2)
    j, t = _both(s0, x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
    js, jy = jmamba.ssd_step(*j)
    ts, ty = tmamba.ssd_step(*t)
    _close(ts, js)
    _close(ty, jy)
    # with ``out`` the new state lands in the given buffer
    out = torch.empty_like(t[0])
    got, _ = tmamba.ssd_step(*t, out=out)
    assert got is out and torch.equal(out, ts)


@pytest.mark.parametrize("L,init", [(32, False), (32, True), (24, False),
                                    (40, True)],
                         ids=["2chunks", "2chunks-init", "pad", "pad-init"])
def test_ssd_chunked_matches_reference(L, init):
    """chunk 16: 32 tokens are two whole chunks; 24 and 40 pad with dt =
    0 steps."""
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(2, L, 4, 8, 16, seed=L + init)
    j, t = _both(x, dt, A, Bm, Cm, s0)
    jy, js = jmamba.ssd_chunked(*j[:5], 16, j[5] if init else None)
    ty, ts = tmamba.ssd_chunked(*t[:5], 16, t[5] if init else None)
    print(f"ssd_chunked L={L} init={init}: y err {_err(ty, jy):.2e}, "
          f"state err {_err(ts, js):.2e}")
    _close(ty, jy, CHUNKED_TOL)
    _close(ts, js, CHUNKED_TOL)
    # the carry is a visible part of the output
    if init:
        ty0, _ = tmamba.ssd_chunked(*t[:5], 16)
        assert not torch.allclose(ty0, ty, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init"])
def test_ssd_chunked_equals_chained_steps(init):
    """In the port itself: the chunked scan over 40 tokens (two chunks
    and a padded third) against 40 exact ``ssd_step`` calls."""
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(2, 40, 4, 8, 16, seed=7)
    _, (tx, tdt, tA, tB, tC, ts0) = _both(x, dt, A, Bm, Cm, s0)
    y, s = tmamba.ssd_chunked(tx, tdt, tA, tB, tC, 16, ts0 if init else None)
    state = ts0 if init else torch.zeros_like(ts0)
    ys = []
    for i in range(40):
        state, yi = tmamba.ssd_step(state, tx[:, i], tdt[:, i], tA,
                                    tB[:, i], tC[:, i])
        ys.append(yi)
    _close(y, torch.stack(ys, 1), CHUNKED_TOL)
    _close(s, state, CHUNKED_TOL)


def _layer(dtype="float32"):
    cfg, _, jp, _, tp, _ = _pair(dtype)
    jl = {k: jnp.asarray(v[1]) for k, v in jp["layers"].items()}
    tl = {k: v[1] for k, v in tp["layers"].items()}
    return cfg, jl, tl


@pytest.mark.parametrize("L,init", [(16, False), (24, True)])
def test_mamba_seq_matches_reference(L, init):
    cfg, jl, tl = _layer()
    rng = np.random.default_rng(L)
    x = _rand(rng, 2, L, cfg.d_model)
    s0 = _rand(rng, 2, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)
    jo, js = jmamba.mamba_seq(jl, jnp.asarray(x), cfg,
                              jnp.asarray(s0) if init else None)
    to, ts = tmamba.mamba_seq(tl, torch.from_numpy(x), cfg,
                              torch.from_numpy(s0) if init else None)
    print(f"mamba_seq L={L}: out err {_err(to, jo):.2e}, "
          f"state err {_err(ts, js):.2e}")
    _close(to, jo, CHUNKED_TOL)
    _close(ts, js, CHUNKED_TOL)


def test_mamba_step_matches_reference_in_place():
    cfg, jl, tl = _layer()
    rng = np.random.default_rng(5)
    W, B = cfg.ssm_conv_width, 3
    x = _rand(rng, B, 1, cfg.d_model)
    s0 = _rand(rng, B, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)
    bufs = {"x": _rand(rng, B, W - 1, cfg.d_inner),
            "B": _rand(rng, B, W - 1, cfg.ssm_state),
            "C": _rand(rng, B, W - 1, cfg.ssm_state)}
    jo, js, jb = jmamba.mamba_step(jl, jnp.asarray(x), jnp.asarray(s0),
                                   {k: jnp.asarray(v)
                                    for k, v in bufs.items()}, cfg)
    state = torch.from_numpy(s0.copy())
    tb = {k: torch.from_numpy(v.copy()) for k, v in bufs.items()}
    given = dict(tb)
    to, ts, tb2 = tmamba.mamba_step(tl, torch.from_numpy(x), state, tb, cfg)
    assert ts is state and tb2 is tb
    assert all(tb[k] is given[k] for k in given)
    _close(to, jo)
    _close(state, js)
    for k in bufs:
        _close(tb[k], jb[k])


def _prompt(B, S, vocab, seed=0):
    rng = np.random.default_rng(seed + B * 1000 + S)
    return rng.integers(0, vocab, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("S", [8, 24, 32])
def test_prefill_last_logits_and_every_cache_leaf(S):
    """8 and 24 pad to the 16-token chunk; 32 is two whole chunks."""
    cfg, jm, jp, tm, tp, _ = _pair()
    toks = _prompt(2, S, cfg.vocab_size)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, capacity=40)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, capacity=40)
    _scaled(tl, jl)
    assert set(tc) == set(jc)
    assert tc["attn_k"].shape[0] == tm.n_attn_apps == 2
    for key in jc:
        assert tuple(tc[key].shape) == tuple(jc[key].shape), key
        assert str(tc[key].dtype).split(".")[-1] == str(jc[key].dtype), key
        _scaled(tc[key], jc[key])
    np.testing.assert_array_equal(tc["attn_pos"].numpy(), jc["attn_pos"])
    assert int(tc["t"]) == int(jc["t"]) == S


def test_decode_logits_past_a_ring_wrap():
    """Teacher-forced: 6 steps after a 24-token prefill into a ring of
    capacity 28, so slots 24-27 fill and steps 5-6 overwrite slots 0-1;
    every step's logits and then every leaf agree."""
    cfg, jm, jp, tm, tp, jdec = _pair()
    toks = _prompt(3, 24, cfg.vocab_size)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, capacity=28)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, capacity=28)
    for _ in range(6):
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        jl, jc = jdec(jp, jc, {"token": jnp.asarray(tok)})
        tl, tc = tm.decode(tp, tc, {"token": torch.from_numpy(tok)})
        _scaled(tl, jl)
    for key in jc:
        _scaled(tc[key], jc[key])
    np.testing.assert_array_equal(tc["attn_pos"].numpy(), jc["attn_pos"])
    assert tc["attn_pos"].min() == 2 and int(tc["t"]) == 30


def test_greedy_continuations_equal():
    """Each side feeds its own argmax for 12 tokens after a 16-token
    prefill (capacity 24, so the ring wraps): equal token sequences."""
    cfg, jm, jp, tm, tp, jdec = _pair()
    toks = _prompt(2, 16, cfg.vocab_size)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, capacity=24)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, capacity=24)
    jt, tt = [], []
    for _ in range(12):
        jtok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        ttok = torch.argmax(tl, -1).to(torch.int32)
        jt.append(jtok)
        tt.append(ttok.numpy())
        jl, jc = jdec(jp, jc, {"token": jnp.asarray(jtok[:, None])})
        tl, tc = tm.decode(tp, tc, {"token": ttok[:, None]})
    np.testing.assert_array_equal(np.stack(tt), np.stack(jt))


def test_decode_writes_every_leaf_in_place():
    """The serving engine's contract (``serve/core.py`` ``_in_place``):
    decode returns the very tensors it was given, each written where it
    changes (the SSM states, conv windows, both applications' K/V slot,
    ``attn_pos`` and ``t``)."""
    cfg, _, _, tm, tp, _ = _pair()
    toks = torch.from_numpy(_prompt(2, 8, cfg.vocab_size))
    _, cache = tm.prefill(tp, {"tokens": toks}, capacity=16)
    before = {k: v.clone() for k, v in cache.items()}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    given = dict(cache)
    _, out = tm.decode(tp, dict(cache), {"token": toks[:, :1]})
    for key in given:
        _in_place(given[key], out[key])
        assert out[key].data_ptr() == ptrs[key]
        assert not torch.equal(out[key], before[key]), key
    # slot 8 of both applications written, the rest untouched
    for key in ("attn_k", "attn_v"):
        assert torch.equal(out[key][:, :, :8], before[key][:, :, :8])
        assert out[key][:, :, 8].abs().min() > 0
    assert out["attn_pos"][8] == 8 and int(out["t"]) == 9
    assert not tm.supports_paged_kv and not tm.supports_verify


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_shapes_equal_the_reference_init(dtype):
    """``param_shapes()`` (the ``meta`` init), the CPU init and the
    reference's init: one tree of shapes and dtypes, with ``shared`` a
    single unstacked dense layer. Also at published widths."""
    kw = {"param_dtype": dtype, **SMALL}
    jm = build_model(get_config("zamba2_7b").reduced(**kw))
    tm = tbuild(tget("zamba2_7b").reduced(**kw))

    def sig(tree):
        return jax.tree_util.tree_map(
            lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]), tree)

    want = sig(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    assert sig(tm.param_shapes()) == want
    assert sig(tm.init(0, device="cpu")) == want
    assert set(want["shared"]) == {"ln1", "ln2", "wq", "wk", "wv", "wo",
                                   "mlp"}
    full_j = build_model(get_config("zamba2_7b"))
    full_t = tbuild(tget("zamba2_7b"))
    assert sig(full_t.param_shapes()) == sig(
        jax.eval_shape(full_j.init, jax.random.PRNGKey(0)))
    assert full_t.n_attn_apps == 13


def test_loss_and_gradients_match_reference():
    """The loss and every gradient leaf against ``jax.value_and_grad``,
    each leaf at ``|got - want| <= GRAD_TOL * (|want| + max|want|)``;
    ``remat`` runs each layer under ``torch.utils.checkpoint`` and gives
    the same loss and gradients."""
    cfg, jm, jp, tm, tp, _ = _pair()
    toks = _prompt(2, 25, cfg.vocab_size, seed=11)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, jb)
    (tl, taux), tg = value_and_grad(tm.loss, tp, tb)
    _close(tl, jl)
    _close(taux["ce"], jaux["ce"])
    _assert_tree(tg, jg, GRAD_TOL, "zamba grad")
    assert float(leaves(tg["shared"])[0].abs().max()) > 0
    rm = tbuild(tm.cfg.replace(remat=True))
    (rl, _), rg = value_and_grad(rm.loss, tp, tb)
    assert float(rl) == float(tl)
    for a, b in zip(leaves(rg), leaves(tg)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def _same_bits(got, want):
    """bf16 ``got`` equals ``want`` bit for bit but on at most
    ``BF16_FLIPS`` of the elements, each within two bf16 roundings of
    its value plus one of the largest: an input that rounded the other
    way (a product summed in another order) moves an output summed over
    ``d_inner`` by about an ulp of the largest one, which near zero is
    many of its own."""
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    got, want = _f32(got), _f32(want)
    diff = got != want
    assert diff.sum() <= BF16_FLIPS * diff.size, (diff.sum(), diff.size)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -6,
                               atol=2.0 ** -8 * np.abs(want).max())


def _silu_rounded_once(x):
    """``jax.nn.silu`` with one rounding to x's dtype, as compiled XLA
    fuses it and as ``F.silu`` computes it. Run op by op, JAX expands a
    bf16 ``logistic`` into exp, add and divide and rounds after each (a
    third of the elements round the other way), an artefact of eager
    JAX rather than of the layer's casts."""
    return (x.astype(jnp.float32) * jax.nn.sigmoid(x.astype(jnp.float32))
            ).astype(x.dtype)


@pytest.mark.parametrize("L", [24, 1], ids=["prefill", "decode"])
def test_bf16_layer_rounds_where_the_reference_does(L, monkeypatch):
    """One bf16 Mamba2 layer (rmsnorm, mixer, residual) on the same
    inputs against the reference run op by op under ``jax.disable_jit()``
    (``_same_bits``: bit for bit but for at most 1% of the elements, a
    product summed in another order), so every cast sits where the
    reference's does; L = 24 through ``mamba_seq`` (a padded chunk), L =
    1 through ``mamba_step`` with its state and conv windows. The
    reference's silu is rounded once (``_silu_rounded_once``)."""
    from repro.models.common import rmsnorm as jrms
    from repro_torch.models.common import rmsnorm as trms
    monkeypatch.setattr(jax.nn, "silu", _silu_rounded_once)
    cfg, jl, tl = _layer("bfloat16")
    rng = np.random.default_rng(L)
    B, W = 2, cfg.ssm_conv_width
    x = _rand(rng, B, L, cfg.d_model)
    s0 = _rand(rng, B, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim,
               scale=0.5)
    bufs = {"x": _rand(rng, B, W - 1, cfg.d_inner),
            "B": _rand(rng, B, W - 1, cfg.ssm_state),
            "C": _rand(rng, B, W - 1, cfg.ssm_state)}
    bf = jnp.bfloat16
    xj, s0j = jnp.asarray(x).astype(bf), jnp.asarray(s0).astype(bf)
    xt, s0t = (torch.from_numpy(a).bfloat16() for a in (x, s0))
    with jax.disable_jit():
        hj = jrms(xj, jl["ln1"], cfg.norm_eps)
        if L == 1:
            oj, sj, bj = jmamba.mamba_step(jl, hj, s0j, {
                k: jnp.asarray(v).astype(bf) for k, v in bufs.items()}, cfg)
        else:
            oj, sj = jmamba.mamba_seq(jl, hj, cfg)
        yj = xj + oj
    ht = trms(xt, tl["ln1"], cfg.norm_eps)
    _same_bits(ht, hj)
    if L == 1:
        bt = {k: torch.from_numpy(v).bfloat16() for k, v in bufs.items()}
        ot, st, _ = tmamba.mamba_step(tl, ht, s0t.clone(), bt, cfg)
        for k in bufs:
            _same_bits(bt[k], bj[k])
    else:
        ot, st = tmamba.mamba_seq(tl, ht, cfg)
    _same_bits(ot, oj)
    _same_bits(st, sj)
    _same_bits(xt + ot, yj)


def test_bf16_prefill_and_decode_match_reference():
    """bf16 weights, activations and cache, as served: the prefill's
    logits and cache leaves (a 24-token prompt, padded chunk) and 8
    teacher-forced decode steps' logits, within ``BF16_SCALE_TOL`` of the
    compiled reference's scale."""
    cfg, jm, jp, tm, tp, jdec = _pair("bfloat16")
    toks = _prompt(3, 24, cfg.vocab_size)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, capacity=32)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, capacity=32)
    assert tl.dtype == torch.bfloat16 and tc["ssm"].dtype == torch.bfloat16
    _scale_close(tl, jl)
    for key in ("ssm", "conv_x", "attn_k", "attn_v"):
        _scale_close(tc[key], jc[key])
    for _ in range(8):
        tok = np.argmax(_f32(jl), -1).astype(np.int32)[:, None]
        jl, jc = jdec(jp, jc, {"token": jnp.asarray(tok)})
        tl, tc = tm.decode(tp, tc, {"token": torch.from_numpy(tok)})
        _scale_close(tl, jl)
    _scale_close(tc["ssm"], jc["ssm"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_decode_is_bit_stable_and_equals_cpu(cuda):
    """Two launches of one decode step from the same cache give the same
    bits; greedy tokens on the card equal the CPU's over a ring wrap."""
    cfg, _, jp, tm, tp, _ = _pair()
    gp = to_torch(jp, device=cuda)
    toks = _prompt(3, 24, cfg.vocab_size)
    lg, cg = tm.prefill(gp, {"tokens": torch.from_numpy(toks).to(cuda)},
                        capacity=28)
    tok = torch.argmax(lg, -1).to(torch.int32)[:, None]
    saved = {k: v.clone() for k, v in cg.items()}
    outs = []
    for _ in range(2):
        for k, v in saved.items():
            cg[k].copy_(v)
        outs.append(tm.decode(gp, cg, {"token": tok})[0])
    assert torch.equal(outs[0], outs[1])
    lc, cc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, capacity=28)
    lg, cg = tm.prefill(gp, {"tokens": torch.from_numpy(toks).to(cuda)},
                        capacity=28)
    want, got = [], []
    for _ in range(10):
        a = torch.argmax(lc, -1).to(torch.int32)
        b = torch.argmax(lg, -1).to(torch.int32)
        want.append(a.numpy())
        got.append(b.cpu().numpy())
        lc, cc = tm.decode(tp, cc, {"token": a[:, None]})
        lg, cg = tm.decode(gp, cg, {"token": b[:, None]})
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
