"""The port's dense DecoderLM against the reference on bridged weights:
last-position prefill logits (plain and flash attention paths, full and
ring caches), per-step decode logits, and 16-token greedy continuations,
which must be equal. f32 reduced configs, rtol 2e-5."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro.configs import get_config
from repro.models import build_model
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config as tget
from repro_torch.models import build_model as tbuild

CONFIGS = {
    "smollm": ("smollm_135m", {}),
    "llama": ("llama3_2_1b", {}),
    # a ring cache: capacity 48 < the 128-token prompt
    "llama-swa": ("llama3_2_1b", {"sliding_window": 48}),
}


@functools.lru_cache(maxsize=None)
def _pair(key):
    name, kw = CONFIGS[key]
    jm = build_model(get_config(name).reduced(**kw))
    tm = tbuild(tget(name).reduced(**kw))
    jp = jax.device_get(jm.init(jax.random.PRNGKey(len(key))))
    return jm, jp, tm, to_torch(jp, device="cpu"), jax.jit(jm.decode)


def _prompt(key, B, S):
    vocab = get_config(CONFIGS[key][0]).reduced().vocab_size
    rng = np.random.default_rng(B * 1000 + S)
    return rng.integers(0, vocab, size=(B, S)).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("S", [24, 128])   # 128 > attn_chunk: flash path
@pytest.mark.parametrize("key", list(CONFIGS))
def test_prefill_last_logits_and_cache(key, S):
    jm, jp, tm, tp, _ = _pair(key)
    toks = _prompt(key, 2, S)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert int(tc["t"]) == int(jc["t"]) == S
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


@pytest.mark.parametrize("key", list(CONFIGS))
def test_decode_logits_per_step(key):
    """Teacher-forced: both sides decode the reference's greedy token, and
    every step's logits agree."""
    jm, jp, tm, tp, jdec = _pair(key)
    toks = _prompt(key, 3, 40)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, capacity=64)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, capacity=64)
    for _ in range(16):
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        jl, jc = jdec(jp, jc, {"token": jnp.asarray(tok)})
        tl, tc = tm.decode(tp, tc, {"token": torch.from_numpy(tok)})
        _close(tl, jl)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("key", list(CONFIGS))
def test_greedy_continuations_equal(key):
    """Each side feeds its own argmax for 16 tokens (the ring wraps in
    the windowed config): the token sequences must be equal."""
    jm, jp, tm, tp, jdec = _pair(key)
    toks = _prompt(key, 2, 30)
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


def test_cache_append_wraps_the_ring_like_the_reference():
    from repro.models.attention import cache_append as j_append
    from repro.models.attention import init_kv_cache as j_init
    from repro_torch.models.attention import cache_append, init_kv_cache
    jc = j_init(2, 4, 2, 8, jnp.float32)
    tc = init_kv_cache(2, 4, 2, 8, torch.float32)
    rng = np.random.default_rng(0)
    for _ in range(7):                  # 7 appends wrap a 4-slot ring
        k, v = (rng.standard_normal((2, 1, 2, 8)).astype(np.float32)
                for _ in range(2))
        jc = j_append(jc, jnp.asarray(k), jnp.asarray(v))
        tc = cache_append(tc, torch.from_numpy(k), torch.from_numpy(v))
    for key in ("k", "v", "pos"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))
    assert int(tc["t"]) == int(jc["t"]) == 7


def test_init_layout_matches_reference():
    """The port's own init draws the reference's layout: L-stacked (in,
    out) weights, padded vocab, f32 norms; for a MoE config the stacked
    ``moe`` tree (f32 router (L, D, E), experts (L, E, D, F) / (L, E, F,
    D)) in place of ``mlp``, also on the ``meta`` device."""
    jm, jp, tm, _, _ = _pair("llama")
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}

    assert shapes(tp) == shapes(jp)
    assert tp["layers"]["ln1"].dtype == torch.float32
    for arch in ("olmoe_1b_7b", "mixtral_8x22b"):
        jcfg = get_config(arch).reduced(param_dtype="bfloat16")
        want = shapes(jax.eval_shape(build_model(jcfg).init,
                                     jax.random.PRNGKey(0)))
        tm = tbuild(tget(arch).reduced(param_dtype="bfloat16"))
        got = tm.init(torch.Generator().manual_seed(0), device="cpu")
        assert shapes(got) == shapes(tm.param_shapes()) == want
        moe = got["layers"]["moe"]
        assert moe["router"].dtype == torch.float32
        assert moe["w_gate"].dtype == torch.bfloat16
        assert "mlp" not in got["layers"]


def test_other_families_name_their_slice():
    assert tbuild(tget("seamless_m4t_large_v2").reduced()).cfg.family == \
        "encdec"
    assert tbuild(tget("zamba2_7b").reduced()).cfg.family == "hybrid"
    for arch in ("olmoe_1b_7b", "mixtral_8x22b", "internvl2_26b"):
        assert tbuild(tget(arch).reduced()).cfg.family in ("moe", "vlm")
