"""The port's RWKV6 against the reference's on the same weights and
inputs, in f32: the WKV evaluators (scan, one step, chunked with its
logw clamp), prefill logits and every state leaf on both prefill branches
(scan: Sb 8 and the non-multiple Sb 24; chunked: Sb 16, 32, 48), 16
teacher-forced decode steps and 16-token greedy continuations. In bf16,
the serving precision: one layer op by op, bit for bit but for rare
roundings, and the model's prefill and decode on a scan and a chunked
bucket.

The leaves the reference's init sets to zero (token-shift mixes, the
ddlerp LoRA input, the bonus ``first_u``) are filled with seeded numpy
noise in both trees, as a trained checkpoint has them; at zero the
bonus, token-shift and ddlerp terms would vanish untested.

Tolerances: rtol = atol = 2e-5 (the f32 tolerance of the kernel tests),
except where ``wkv_chunked`` runs: its chunk products and cumsums sum in
another order than XLA's, which the 1/exp(cumsum) factors amplify, so
its outputs, and the logits and states of chunked prefills, are held at
rtol = atol = 1e-4.

In bf16 the reference's compiled graph fuses each elementwise chain and
rounds once at its end, where the port rounds after every op, as JAX run
op by op does. So a bf16 layer is held to the reference run under
``jax.disable_jit()`` bit for bit, but for at most 1% of the elements
that round the other way because a product was summed in another order
(a cast missing or out of place changes far more), and the whole model to the compiled reference within
``BF16_SCALE_TOL`` of the reference's largest magnitude: the roundings
differ by an ulp and spread through the layers and the recurrence (3.5%
at most, measured on these seeds).
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
from repro.models import rwkv6 as jrwkv
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config as tget
from repro_torch.kernels.wkv_step import wkv_step_plain
from repro_torch.models import build_model as tbuild
from repro_torch.models import rwkv6 as trwkv

F32_TOL = 2e-5
CHUNKED_TOL = 1e-4
BF16_SCALE_TOL = 5e-2
BF16_FLIPS = 0.01
#: leaves the reference's ``_init_layer`` zeroes
ZERO_LEAVES = ("maa_x", "maa_base", "maa_w1", "first_u", "ch_maa_k",
               "ch_maa_r")


def trained_like(params, seed):
    """Fill the zero-initialised leaves with seeded noise of a trained
    checkpoint's scale: mixes in [0, 1), a small LoRA input, bonus ~0.5."""
    rng = np.random.default_rng(seed)
    layers = dict(params["layers"])
    for name in ZERO_LEAVES:
        shape = layers[name].shape
        if name == "maa_w1":
            a = rng.standard_normal(shape) * 0.05
        elif name == "first_u":
            a = rng.standard_normal(shape) * 0.5
        else:
            a = rng.uniform(size=shape)
        layers[name] = a.astype(np.float32)
    return {**params, "layers": layers}


@functools.lru_cache(maxsize=None)
def _pair(dtype="float32"):
    kw = {"param_dtype": dtype, "compute_dtype": dtype}
    cfg = get_config("rwkv6_7b").reduced(**kw)
    jm = build_model(cfg)
    jp = trained_like(jax.device_get(jm.init(jax.random.PRNGKey(3))), 3)
    tm = tbuild(tget("rwkv6_7b").reduced(**kw))
    return cfg, jm, jp, tm, to_torch(jp, device="cpu"), jax.jit(jm.decode)


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def _wkv_inputs(B, L, H, P, seed, low=False):
    rng = np.random.default_rng(seed)
    f = np.float32
    r, k, v = (rng.standard_normal((B, L, H, P)).astype(f) for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, L, H, P)) * 0.5).astype(f)
    if low:     # decays below the chunked evaluator's -8 clamp
        logw[:, ::3] = -9.0 - rng.uniform(size=logw[:, ::3].shape)
    u = (rng.standard_normal((H, P)) * 0.2).astype(f)
    s0 = rng.standard_normal((B, H, P, P)).astype(f)
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("L", [1, 7, 16])
def test_wkv_scan_matches_reference(L):
    args = _wkv_inputs(2, L, 3, 16, seed=L)
    jo, js = jrwkv.wkv_scan(*map(jnp.asarray, args))
    to, ts = trwkv.wkv_scan(*map(torch.from_numpy, args))
    _close(to, jo)
    _close(ts, js)


def test_wkv_step_matches_reference():
    r, k, v, logw, u, s0 = _wkv_inputs(2, 1, 4, 32, seed=9)
    js, jo = jrwkv.wkv_step(*map(jnp.asarray, (s0, r[:, 0], k[:, 0],
                                                v[:, 0], logw[:, 0], u)))
    to, ts = wkv_step_plain(*map(torch.from_numpy, (r[:, 0], k[:, 0],
                                                     v[:, 0], logw[:, 0], u,
                                                     s0)))
    _close(to, jo)
    _close(ts, js)


@pytest.mark.parametrize("L,chunk,low", [(32, 16, False), (64, 16, True),
                                         (32, 32, True), (24, 16, False)],
                         ids=["2chunks", "4chunks-clamp", "1chunk-clamp",
                              "fallback"])
def test_wkv_chunked_matches_reference(L, chunk, low):
    args = _wkv_inputs(2, L, 2, 16, seed=L + chunk, low=low)
    jo, js = jrwkv.wkv_chunked(*map(jnp.asarray, args), chunk=chunk)
    to, ts = trwkv.wkv_chunked(*map(torch.from_numpy, args), chunk=chunk)
    tol = F32_TOL if L % chunk else CHUNKED_TOL
    _close(to, jo, tol)
    _close(ts, js, tol)
    if low:
        # the clamp acted: the exact scan gives another result
        so, _ = trwkv.wkv_scan(*map(torch.from_numpy, args))
        assert not torch.allclose(so, to, rtol=1e-3, atol=1e-3)


def test_groupnorm_heads_uses_population_variance():
    from repro.models.common import groupnorm_heads as jgn
    from repro_torch.models.common import groupnorm_heads as tgn
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4, 16)).astype(np.float32) * 3 + 1
    s = rng.standard_normal((4, 16)).astype(np.float32)
    _close(tgn(torch.from_numpy(x), torch.from_numpy(s)),
           jgn(jnp.asarray(x), jnp.asarray(s)))


def _prompt(B, S, vocab):
    rng = np.random.default_rng(B * 1000 + S)
    return rng.integers(0, vocab, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("S", [8, 24, 16, 32, 48])
def test_prefill_last_logits_and_state(S):
    """Sb 8 and 24 take the scan (24 % ssm_chunk != 0); 16, 32 and 48
    the chunked evaluator."""
    cfg, jm, jp, tm, tp, _ = _pair()
    toks = _prompt(2, S, cfg.vocab_size)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    tol = F32_TOL if S % cfg.ssm_chunk else CHUNKED_TOL
    _close(tl, jl, tol)
    assert set(tc) == set(jc)
    for key in ("S", "x_tm", "x_cm"):
        assert tc[key].dtype == torch.float32
        _close(tc[key], jc[key], tol)
    assert int(tc["t"]) == int(jc["t"]) == S


def test_decode_logits_per_step():
    """Teacher-forced: both sides decode the reference's greedy token for
    16 steps after a scan-branch prefill; every step's logits and the
    final state agree."""
    cfg, jm, jp, tm, tp, jdec = _pair()
    toks = _prompt(3, 8, cfg.vocab_size)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    for _ in range(16):
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        jl, jc = jdec(jp, jc, {"token": jnp.asarray(tok)})
        tl, tc = tm.decode(tp, tc, {"token": torch.from_numpy(tok)})
        _close(tl, jl)
    for key in ("S", "x_tm", "x_cm"):
        _close(tc[key], jc[key])
    assert int(tc["t"]) == int(jc["t"]) == 8 + 16


@pytest.mark.parametrize("S", [8, 32])
def test_greedy_continuations_equal(S):
    """Each side feeds its own argmax for 16 tokens after a scan (8) or
    chunked (32) prefill: the token sequences must be equal."""
    cfg, jm, jp, tm, tp, jdec = _pair()
    toks = _prompt(2, S, cfg.vocab_size)
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


def test_decode_writes_the_state_in_place():
    """The decode step updates the cache it is given (no second state
    buffer); a paged engine refuses the family."""
    from repro_torch.serve import ExpertEngine
    cfg, _, _, tm, tp, _ = _pair()
    toks = torch.from_numpy(_prompt(2, 8, cfg.vocab_size))
    _, cache = tm.prefill(tp, {"tokens": toks})
    ptrs = {k: cache[k].data_ptr() for k in ("S", "x_tm", "x_cm")}
    before = cache["S"].clone()
    _, out = tm.decode(tp, cache, {"token": toks[:, :1]})
    assert out is cache
    assert {k: out[k].data_ptr() for k in ptrs} == ptrs
    assert not torch.equal(out["S"], before)
    assert not tm.supports_paged_kv and tm.cache_capacity(100) == 1
    with pytest.raises(ValueError, match="paged KV cache protocol"):
        ExpertEngine(tm, tp, kv_layout="paged", device="cpu")


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor)
                      else jnp.asarray(a).astype(jnp.float32))


def _same_bits(got, want):
    """bf16 ``got`` equals ``want`` bit for bit but on at most
    ``BF16_FLIPS`` of the elements, and there within two bf16 roundings
    (2**-6 of the value): a product summed in another order than XLA's
    may round the other way."""
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    got, want = _f32(got), _f32(want)
    diff = got != want
    assert diff.sum() <= BF16_FLIPS * diff.size, (diff.sum(), diff.size)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -6, atol=0)


@pytest.mark.parametrize("L", [8, 1], ids=["prefill", "decode"])
def test_bf16_layer_rounds_where_the_reference_does(L):
    """One bf16 layer on the same inputs: the ddlerp branches, time mix,
    channel mix and the layer's output and token-shift states equal the
    reference run op by op (``_same_bits``), so every cast sits where the
    reference's does; the f32 state agrees at the f32 tolerance. L = 8
    takes the scan fallback, L = 1 the decode step."""
    cfg, _, jp, tm, tp, _ = _pair("bfloat16")
    jl = {k: jnp.asarray(v[0]) for k, v in jp["layers"].items()}
    tl = {k: v[0] for k, v in tp["layers"].items()}
    rng = np.random.default_rng(L)
    B, D, H, P = 2, cfg.d_model, cfg.n_heads, cfg.dh
    x, xp, xc = (rng.standard_normal(s).astype(np.float32)
                 for s in ((B, L, D), (B, D), (B, D)))
    S0 = (rng.standard_normal((B, H, P, P)) * 0.5).astype(np.float32)
    xj, xpj, xcj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, xp, xc))
    xt, xpt, xct = (torch.from_numpy(a).bfloat16() for a in (x, xp, xc))
    mode = "step" if L == 1 else "chunked"
    with jax.disable_jit():
        j_mix = jrwkv._ddlerp(jl, xj, jrwkv._shift(xj, xpj))
        j_tm = jrwkv.time_mix(jl, xj, cfg, xpj, jnp.asarray(S0), "scan")
        j_cm = jrwkv.channel_mix(jl, xj, xcj)
        j_x, j_state = jrwkv._layer(jl, xj, cfg, {
            "S": jnp.asarray(S0), "x_tm": xpj, "x_cm": xcj}, "scan")
    for got, want in zip(trwkv._ddlerp(tl, xt, trwkv._shift(xt, xpt)),
                         j_mix):
        _same_bits(got, want)
    t_out, t_xtm, t_S = trwkv.time_mix(tl, xt, cfg, xpt,
                                       torch.from_numpy(S0.copy()), mode)
    _same_bits(t_out, j_tm[0])
    _same_bits(t_xtm, j_tm[1])
    _close(t_S, j_tm[2])
    t_cm, t_xcm = trwkv.channel_mix(tl, xt, xct)
    _same_bits(t_cm, j_cm[0])
    _same_bits(t_xcm, j_cm[1])
    state = {"S": torch.from_numpy(S0.copy()), "x_tm": xpt.clone(),
             "x_cm": xct.clone()}
    _same_bits(trwkv._layer(tl, xt, cfg, state, mode), j_x)
    _same_bits(state["x_tm"], j_state["x_tm"])
    _same_bits(state["x_cm"], j_state["x_cm"])
    _close(state["S"], j_state["S"])


def _scale_close(got, want):
    """max |got - want| within BF16_SCALE_TOL of max |want|."""
    got, want = _f32(got), _f32(want)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= BF16_SCALE_TOL * scale, (err, scale)


@pytest.mark.parametrize("S", [8, 32], ids=["scan", "chunked"])
def test_bf16_prefill_and_decode_match_reference(S):
    """bf16 weights and activations, as served: the prefill's logits and
    state leaves on a scan (8) and a chunked (32) bucket, then 8
    teacher-forced decode steps' logits and the final state, against the
    compiled reference."""
    cfg, jm, jp, tm, tp, jdec = _pair("bfloat16")
    toks = _prompt(3, S, cfg.vocab_size)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.bfloat16 and jl.dtype == jnp.bfloat16
    _scale_close(tl, jl)
    for key in ("S", "x_tm", "x_cm"):
        assert str(tc[key].dtype).split(".")[-1] == str(jc[key].dtype)
        _scale_close(tc[key], jc[key])
    for _ in range(8):
        tok = np.argmax(_f32(jl), -1).astype(np.int32)[:, None]
        jl, jc = jdec(jp, jc, {"token": jnp.asarray(tok)})
        tl, tc = tm.decode(tp, tc, {"token": torch.from_numpy(tok)})
        _scale_close(tl, jl)
    for key in ("S", "x_tm", "x_cm"):
        _scale_close(tc[key], jc[key])
