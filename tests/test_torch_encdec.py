"""The port's encoder-decoder (``repro_torch.models.encdec``) against the
reference's ``repro.models.encdec`` on the same bridged weights and
inputs, reduced ``seamless_m4t_large_v2`` in f32: ``param_shapes`` (also
at published widths), ``encode``, the prefill's logits and every cache
leaf, decode logits past a ring wrap, greedy continuations, decode
against a teacher-forced prefill, the in-place decode contract, the loss
and its gradients, one ``make_train_step`` step, the bf16 model, and the
serving engine's refusal of the family in both packages.

Traps the cases are built to catch:

- (a) the encoder and the cross-attention are the port's first
  ``causal=False`` callers. The reduced config (``enc_seq_len`` 16,
  ``attn_chunk`` 64) takes only the plain branch of ``attention``; the
  ``flash`` variant (``enc_seq_len`` 128, ``attn_chunk`` 32) sends the
  encoder (Sq = Sk = 128) and the prefill's cross-attention (Sk = 128)
  through the blockwise ``_flash`` with ``_edge_mask(causal=False)``.
- (b) a decode query sits at ``t``, below most encoder positions: a
  causal mask slipped into the cross-attention would hide most of the
  encoder and still give finite logits. The decode cases run at ``t``
  below ``enc_seq_len``.
- (c) the reduced config is GQA (4 heads over 2 KV heads); published
  widths are MHA (16 over 16, dh 64): ``param_shapes`` checks both.
- (d) decoding past the ring's capacity wraps it as ``DecoderLM`` does.

Tolerances: ``encode`` at rtol = atol = 2e-5; logits and cache leaves
within 2e-5 of the reference's largest magnitude; gradients at
``|got - want| <= 2e-5 * (|want| + max|want|)``, the dense family's
(``tests/test_torch_train_loop.py``); bf16 within 5% of scale.
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
from repro.optim import constant_lr as jconstant_lr
from repro.serve import ExpertEngine as JEngine
from repro.train.loop import init_train_state as jinit_state
from repro.train.loop import make_train_step as jmake_step
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config as tget
from repro_torch.models import build_model as tbuild
from repro_torch.optim import constant_lr
from repro_torch.serve import ExpertEngine
from repro_torch.serve.core import _in_place
from repro_torch.train import make_train_step
from repro_torch.tree import leaves, value_and_grad
from test_torch_rwkv import _f32, _scale_close
from test_torch_train_loop import GRAD_FLOOR, _assert_tree, _leaves_np

ARCH = "seamless_m4t_large_v2"
TOL = 2e-5
LR = 1e-3
#: trap (a): the flash branch in the encoder and the cross-attention
VARIANTS = {"plain": {}, "flash": {"enc_seq_len": 128, "attn_chunk": 32}}


@functools.lru_cache(maxsize=None)
def _pair(variant="plain", dtype="float32"):
    kw = {"param_dtype": dtype, "compute_dtype": dtype, **VARIANTS[variant]}
    cfg = get_config(ARCH).reduced(**kw)
    jm = build_model(cfg)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tm = tbuild(tget(ARCH).reduced(**kw))
    return cfg, jm, jp, tm, to_torch(jp, device="cpu"), jax.jit(jm.decode)


def _inputs(cfg, B, S, seed=0):
    """Stub frames (normal x 0.1, as the reference's smoke batch draws
    them) and prompt tokens, from numpy."""
    rng = np.random.default_rng(seed)
    frames = (rng.standard_normal((B, cfg.enc_seq_len, cfg.d_model))
              * 0.1).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return frames, toks


def _jbatch(frames, toks, dtype=jnp.float32):
    return {"frames": jnp.asarray(frames).astype(dtype),
            "tokens": jnp.asarray(toks)}


def _tbatch(frames, toks, dtype=torch.float32, device="cpu"):
    return {"frames": torch.from_numpy(frames).to(device, dtype),
            "tokens": torch.from_numpy(toks).to(device)}


def _scaled(got, want, tol=TOL):
    """max |got - want| within ``tol`` of max |want|."""
    got, want = _f32(got), _f32(want)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, (err, scale)


def _sig(tree):
    return jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_shapes_equal_the_reference_init(dtype):
    """``param_shapes()`` (the ``meta`` init), the CPU init and the
    reference's init give one tree of shapes and dtypes (``ln*`` f32),
    reduced (GQA 4 over 2) and at published widths (MHA 16 over 16, dh
    64, padded vocab 256256), trap (c)."""
    kw = {"param_dtype": dtype}
    jm = build_model(get_config(ARCH).reduced(**kw))
    tm = tbuild(tget(ARCH).reduced(**kw))
    want = _sig(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    assert _sig(tm.param_shapes()) == want
    assert _sig(tm.init(0, device="cpu")) == want
    assert want["dec_layers"]["ln_x"] == ((2, 128), "float32")
    assert want["enc_layers"]["attn"]["wk"][0] == (2, 128, 2 * 32)
    full_j, full_t = build_model(get_config(ARCH)), tbuild(tget(ARCH))
    full = _sig(full_t.param_shapes())
    assert full == _sig(jax.eval_shape(full_j.init, jax.random.PRNGKey(0)))
    assert full["dec_layers"]["xattn"]["wk"] == ((24, 1024, 1024),
                                                 "bfloat16")
    assert full["unembed"] == ((1024, 256256), "bfloat16")
    n = sum(int(np.prod(s)) for s, _ in jax.tree_util.tree_leaves(
        full, is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
        and isinstance(x[1], str)))
    assert 2.0e9 < n < 2.1e9


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_encode_matches_reference(variant):
    """Bidirectional encoder, trap (a): plain and blockwise branches."""
    cfg, jm, jp, tm, tp, _ = _pair(variant)
    frames, _ = _inputs(cfg, 2, 4, seed=1)
    want = jm.encode(jp, jnp.asarray(frames))
    got = tm.encode(tp, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    # bidirectional: the first position sees the last frame
    moved = frames.copy()
    moved[:, -1] += 1.0
    again = tm.encode(tp, torch.from_numpy(moved))
    assert not torch.allclose(again[:, 0], got[:, 0])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_logits_and_every_cache_leaf(variant):
    cfg, jm, jp, tm, tp, _ = _pair(variant)
    frames, toks = _inputs(cfg, 2, 12, seed=2)
    jl, jc = jm.prefill(jp, _jbatch(frames, toks), capacity=14)
    tl, tc = tm.prefill(tp, _tbatch(frames, toks), capacity=14)
    _scaled(tl, jl)
    assert set(tc) == set(jc) == {"k", "v", "xk", "xv", "pos", "t"}
    for key in jc:
        assert tuple(tc[key].shape) == tuple(jc[key].shape), key
        assert str(tc[key].dtype).split(".")[-1] == str(jc[key].dtype), key
        _scaled(tc[key], jc[key])
    np.testing.assert_array_equal(tc["pos"].numpy(), jc["pos"])
    assert int(tc["t"]) == 12
    assert tc["xk"].shape == (2, 2, cfg.enc_seq_len, 2, 32)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_logits_past_a_ring_wrap(variant):
    """Teacher-forced: 6 steps after a 12-token prefill into a ring of
    capacity 14, so steps 3-6 overwrite slots 0-3 (trap (d)), at t = 12
    .. 17, below ``enc_seq_len`` in both variants for the first steps
    (trap (b)); every step's logits and then every leaf agree."""
    cfg, jm, jp, tm, tp, jdec = _pair(variant)
    frames, toks = _inputs(cfg, 3, 12, seed=3)
    jl, jc = jm.prefill(jp, _jbatch(frames, toks), capacity=14)
    tl, tc = tm.prefill(tp, _tbatch(frames, toks), capacity=14)
    assert int(tc["t"]) < cfg.enc_seq_len
    for _ in range(6):
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        jl, jc = jdec(jp, jc, {"token": jnp.asarray(tok)})
        tl, tc = tm.decode(tp, tc, {"token": torch.from_numpy(tok)})
        _scaled(tl, jl)
    for key in jc:
        _scaled(tc[key], jc[key])
    np.testing.assert_array_equal(tc["pos"].numpy(), jc["pos"])
    assert int(tc["pos"].min()) == 4 and int(tc["t"]) == 18


def test_cross_attention_is_not_causal():
    """Trap (b) in the port alone: at t = 12 a decode step's logits move
    when only the encoder's late frames (positions 12-15, after t) move."""
    cfg, _, _, tm, tp, _ = _pair()
    frames, toks = _inputs(cfg, 2, 12, seed=4)
    moved = frames.copy()
    moved[:, 12:] += 1.0
    outs = []
    for f in (frames, moved):
        _, cache = tm.prefill(tp, _tbatch(f, toks), capacity=16)
        # the same cross K/V up to the late frames, then one decode step
        outs.append(tm.decode(tp, cache, {"token": torch.from_numpy(
            toks[:, -1:])})[0])
    assert not torch.allclose(outs[0], outs[1], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_greedy_continuations_equal(variant):
    """Each side feeds its own argmax for 10 tokens after an 8-token
    prefill into a ring of 12 (it wraps): equal token sequences."""
    cfg, jm, jp, tm, tp, jdec = _pair(variant)
    frames, toks = _inputs(cfg, 2, 8, seed=5)
    jl, jc = jm.prefill(jp, _jbatch(frames, toks), capacity=12)
    tl, tc = tm.prefill(tp, _tbatch(frames, toks), capacity=12)
    jt, tt = [], []
    for _ in range(10):
        jtok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        ttok = torch.argmax(tl, -1).to(torch.int32)
        jt.append(jtok)
        tt.append(ttok.numpy())
        jl, jc = jdec(jp, jc, {"token": jnp.asarray(jtok[:, None])})
        tl, tc = tm.decode(tp, tc, {"token": ttok[:, None]})
    np.testing.assert_array_equal(np.stack(tt), np.stack(jt))


def test_decode_equals_teacher_forced_prefill():
    """Four decode steps after a prefill of S tokens give the logits of a
    prefill of all S + 4 (rel < 2e-2, the reference's smoke bar)."""
    cfg, _, _, tm, tp, _ = _pair()
    frames, toks = _inputs(cfg, 2, 20, seed=6)
    logits, cache = tm.prefill(tp, _tbatch(frames, toks[:, :16]),
                               capacity=28)
    for i in range(16, 20):
        logits, cache = tm.decode(tp, cache, {"token": torch.from_numpy(
            toks[:, i:i + 1])})
    full, _ = tm.prefill(tp, _tbatch(frames, toks))
    rel = float((logits - full).abs().max() / (full.abs().max() + 1e-9))
    assert rel < 2e-2, rel


def test_decode_writes_every_leaf_in_place():
    """The serving engine's contract (``serve/core.py`` ``_in_place``):
    decode returns the very tensors it was given, writing slot ``t % C``
    of every layer's self K/V, ``pos`` and ``t``; ``xk`` / ``xv`` are
    read only."""
    cfg, _, _, tm, tp, _ = _pair()
    frames, toks = _inputs(cfg, 2, 8, seed=7)
    _, cache = tm.prefill(tp, _tbatch(frames, toks), capacity=16)
    before = {k: v.clone() for k, v in cache.items()}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    given = dict(cache)
    _, out = tm.decode(tp, dict(cache), {"token": torch.from_numpy(
        toks[:, :1])})
    for key in given:
        _in_place(given[key], out[key])
        assert out[key].data_ptr() == ptrs[key]
    for key in ("xk", "xv"):
        assert torch.equal(out[key], before[key])
    for key in ("k", "v"):
        assert torch.equal(out[key][:, :, :8], before[key][:, :, :8])
        assert torch.equal(out[key][:, :, 9:], before[key][:, :, 9:])
        assert out[key][:, :, 8].abs().min() > 0
    assert int(out["pos"][8]) == 8 and int(out["t"]) == 9
    assert not tm.supports_paged_kv and not tm.supports_verify


def _loss_batch(cfg, B, S, seed):
    frames, toks = _inputs(cfg, B, S + 1, seed=seed)
    return {"frames": frames, "tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_gradients_match_reference(variant):
    """The loss and every gradient leaf against ``jax.value_and_grad``;
    ``remat`` (each layer under ``torch.utils.checkpoint``) gives the
    same loss bits and gradients."""
    cfg, jm, jp, tm, tp, _ = _pair(variant)
    batch = _loss_batch(cfg, 2, 16, seed=8)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (tl, taux), tg = value_and_grad(tm.loss, tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)
    np.testing.assert_allclose(float(taux["ce"]), float(jaux["ce"]),
                               rtol=TOL)
    _assert_tree(tg, jg, TOL, "encdec grad")
    assert float(tg["enc_layers"]["attn"]["wq"].abs().max()) > 0
    rm = tbuild(tm.cfg.replace(remat=True))
    (rl, _), rg = value_and_grad(rm.loss, tp, tb)
    assert float(rl) == float(tl)
    for a, b in zip(leaves(rg), leaves(tg)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_train_step_matches_reference():
    """One ``make_train_step`` step (clip 1.0, constant lr) against the
    reference's: the loss at ``TOL``, each param leaf at rtol 1e-5 where
    the reference's clipped gradient is at least ``GRAD_FLOOR`` and
    within the step's bound ``lr`` elsewhere, the moments at ``TOL``."""
    cfg, jm, jp, tm, _, _ = _pair()
    batch = _loss_batch(cfg, 4, 16, seed=9)
    s0 = jinit_state(jm, jax.random.PRNGKey(0))
    s0 = {**s0, "params": jax.tree_util.tree_map(jnp.asarray, jp)}
    ts0 = {"params": to_torch(jp, device="cpu"),
           "opt": to_torch(jax.device_get(s0["opt"]), device="cpu"),
           "step": torch.zeros((), dtype=torch.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    js, jmet = jax.jit(jmake_step(jm, lr_fn=jconstant_lr(LR),
                                  microbatches=1))(s0, jb)
    ts, tmet = make_train_step(tm, lr_fn=constant_lr(LR), microbatches=1)(
        ts0, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=TOL)
    g = jax.grad(lambda p: jm.loss(p, jb)[0])(
        jax.tree_util.tree_map(jnp.asarray, jp))
    gn = float(jnp.sqrt(sum(jnp.sum(jnp.square(a))
                            for a in jax.tree_util.tree_leaves(g))))
    grad = [a * min(1.0, 1.0 / max(gn, 1e-9)) for a in _leaves_np(g)]
    for i, (a, b, p0, gi) in enumerate(zip(
            leaves(ts["params"]), _leaves_np(js["params"]), _leaves_np(jp),
            grad)):
        a = a.numpy()
        big = np.abs(gi) >= GRAD_FLOOR
        np.testing.assert_allclose(a[big], b[big], rtol=1e-5, atol=1e-7,
                                   err_msg=f"leaf {i}")
        assert (np.abs(a - p0) <= LR * (1 + 1e-5)
                + np.spacing(np.abs(p0))).all()
    _assert_tree(ts["opt"]["m"], js["opt"]["m"], TOL, "m")
    _assert_tree(ts["opt"]["v"], js["opt"]["v"], TOL, "v")


def test_bf16_prefill_and_decode_match_reference():
    """bf16 weights, activations and caches: the prefill's logits and
    cache leaves, then 6 teacher-forced decode steps' logits, within 5%
    of the compiled reference's scale."""
    cfg, jm, jp, tm, tp, jdec = _pair("plain", "bfloat16")
    frames, toks = _inputs(cfg, 2, 12, seed=10)
    jl, jc = jm.prefill(jp, _jbatch(frames, toks, jnp.bfloat16),
                        capacity=14)
    tl, tc = tm.prefill(tp, _tbatch(frames, toks, torch.bfloat16),
                        capacity=14)
    assert tl.dtype == torch.bfloat16 and tc["xk"].dtype == torch.bfloat16
    _scale_close(tl, jl)
    for key in ("k", "v", "xk", "xv"):
        _scale_close(tc[key], jc[key])
    for _ in range(6):
        tok = np.argmax(_f32(jl), -1).astype(np.int32)[:, None]
        jl, jc = jdec(jp, jc, {"token": jnp.asarray(tok)})
        tl, tc = tm.decode(tp, tc, {"token": torch.from_numpy(tok)})
        _scale_close(tl, jl)


def test_serving_engine_refuses_the_family_in_both_packages():
    """The reference never serves this family (its launcher swaps it for
    a llama): its engine's token-only prefill fails for want of
    ``frames``, and so does the port's, at the first admission."""
    cfg, jm, jp, tm, tp, _ = _pair()
    prompt = np.arange(5, dtype=np.int32)
    with pytest.raises(KeyError, match="frames"):
        JEngine(jm, jp, max_len=32).admit([0], [prompt], [2])
    eng = ExpertEngine(tm, tp, max_len=32, device="cpu")
    with pytest.raises(KeyError, match="frames"):
        eng.admit([0], [prompt], [2])
    assert eng.n_active == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cuda_decode_is_bit_stable_and_equals_cpu(cuda, variant):
    """Two launches of one decode step from the same cache give the same
    bits; greedy tokens on the card equal the CPU's past a ring wrap."""
    cfg, _, jp, tm, tp, _ = _pair(variant)
    gp = to_torch(jp, device=cuda)
    frames, toks = _inputs(cfg, 3, 12, seed=11)
    lg, cg = tm.prefill(gp, _tbatch(frames, toks, device=cuda), capacity=14)
    tok = torch.argmax(lg, -1).to(torch.int32)[:, None]
    saved = {k: v.clone() for k, v in cg.items()}
    outs = []
    for _ in range(2):
        for k, v in saved.items():
            cg[k].copy_(v)
        outs.append(tm.decode(gp, cg, {"token": tok})[0])
    assert torch.equal(outs[0], outs[1])
    lc, cc = tm.prefill(tp, _tbatch(frames, toks), capacity=14)
    lg, cg = tm.prefill(gp, _tbatch(frames, toks, device=cuda), capacity=14)
    want, got = [], []
    for _ in range(8):
        a = torch.argmax(lc, -1).to(torch.int32)
        b = torch.argmax(lg, -1).to(torch.int32)
        want.append(a.numpy())
        got.append(b.cpu().numpy())
        lc, cc = tm.decode(tp, cc, {"token": a[:, None]})
        lg, cg = tm.decode(gp, cg, {"token": b[:, None]})
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
