"""Weight bridge: reference params -> port tensors -> numpy gives back the
same bits, for f32 and bf16 leaves, with shapes and the L axis kept."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro.configs import get_config
from repro.core import build_matcher, init_ae
from repro.models import build_model
from repro_torch.bridge import to_numpy, to_torch


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_params_round_trip_bit_exact(dtype):
    cfg = get_config("llama3_2_1b").reduced(param_dtype=dtype,
                                            compute_dtype=dtype)
    params = jax.device_get(build_model(cfg).init(jax.random.PRNGKey(0)))
    tp = to_torch(params, device="cpu")
    want_t = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert tp["layers"]["wq"].dtype == want_t
    assert tp["layers"]["ln1"].dtype == torch.float32   # norms stay f32
    assert tp["layers"]["wq"].shape == (cfg.n_layers, cfg.d_model,
                                        cfg.n_heads * cfg.dh)
    assert tp["embed"].shape == (cfg.padded_vocab, cfg.d_model)
    back = to_numpy(tp)
    got, want = dict(_leaves(back)), dict(_leaves(params))
    assert got.keys() == want.keys()
    for path, a in want.items():
        assert got[path].shape == a.shape, path
        np.testing.assert_array_equal(got[path], _bits(a), err_msg=path)


def test_bf16_values_survive_the_view():
    """The uint16 crossing is a reinterpretation, not a conversion: the
    tensor holds the same numbers the reference holds."""
    x = jnp.asarray(np.linspace(-3, 3, 97, dtype=np.float32), jnp.bfloat16)
    t = to_torch(jax.device_get(x), device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x, np.float32))


def test_matcher_state_round_trip():
    """AE bank (params + BN states, K-stacked) and centroids/mask."""
    rng = np.random.default_rng(0)
    aes = [init_ae(jax.random.PRNGKey(i), 784, 128) for i in range(3)]
    data = [(rng.uniform(size=(40, 784)).astype(np.float32),
             np.arange(40) % (i + 2)) for i in range(3)]
    m = build_matcher(aes, ["a", "b", "c"], data)
    tree = jax.device_get({"bank_params": m.bank_params,
                           "bank_states": m.bank_states,
                           "centroids": m.centroids,
                           "centroid_mask": m.centroid_mask})
    tt = to_torch(tree, device="cpu")
    assert tt["bank_params"]["w_enc"].shape == (3, 784, 128)
    assert tt["centroids"].shape == (3, 4, 128)
    back = dict(_leaves(to_numpy(tt)))
    for path, a in _leaves(tree):
        np.testing.assert_array_equal(back[path], a, err_msg=path)


def test_paged_pool_and_table_round_trip():
    """A reference engine's bf16 page pool (E, P1, L, page, KV, dh) and
    int32 page table cross unchanged: the port keeps the pool layout."""
    cfg = get_config("llama3_2_1b").reduced(param_dtype="bfloat16",
                                            compute_dtype="bfloat16")
    model = build_model(cfg)
    pool = model.init_paged_pool(6, 8)
    pool = {k: jnp.stack([v, v + 1]) for k, v in pool.items()}
    pool["k"] = pool["k"] + jax.random.normal(
        jax.random.PRNGKey(0), pool["k"].shape, jnp.bfloat16)
    table = jnp.asarray([[3, 0, 6, 6], [1, 2, 5, 6]], jnp.int32)
    tree = jax.device_get({"pool": pool, "table": table})
    tt = to_torch(tree, device="cpu")
    assert tt["pool"]["k"].dtype == torch.bfloat16
    assert tuple(tt["pool"]["k"].shape) == (2, 7, cfg.n_layers, 8,
                                            cfg.n_kv_heads, cfg.dh)
    assert tt["table"].dtype == torch.int32
    back = dict(_leaves(to_numpy(tt)))
    for path, a in _leaves(tree):
        np.testing.assert_array_equal(back[path], _bits(a), err_msg=path)


def test_rwkv6_init_tree_matches_reference():
    """The port's own RWKV6 init draws the reference's tree: the same
    keys, L-stacked shapes and dtypes (bf16 projections, f32 mixes,
    decay and norms at the full config's dtypes)."""
    from repro_torch.configs import get_config as tget
    from repro_torch.models import build_model as tbuild
    cfg = get_config("rwkv6_7b").reduced(param_dtype="bfloat16",
                                         compute_dtype="bfloat16")
    jp = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0))
    tp = tbuild(tget("rwkv6_7b").reduced(
        param_dtype="bfloat16", compute_dtype="bfloat16")).init(
        torch.Generator().manual_seed(0), device="cpu")
    want = {p: (tuple(a.shape), str(a.dtype)) for p, a in _leaves(jp)}
    got = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in _leaves(tp)}
    assert got == want
    lay = tp["layers"]
    for name in ("maa_x", "maa_base", "maa_w1", "first_u", "ch_maa_k",
                 "ch_maa_r"):
        assert not lay[name].any(), name
    assert (lay["decay_w0"] == -6.0).all()
    assert (lay["ln1"] == 1).all() and (lay["g_norm"] == 1).all()


def test_train_state_round_trip():
    """A reference train state — bf16 params, their f32 AdamW moments and
    the int32 step, after one step — crosses unchanged, and the port's
    AdamW takes it as its own state."""
    from repro.optim import constant_lr
    from repro.train.loop import init_train_state, make_train_step
    from repro_torch.optim import adamw_update
    from repro_torch.tree import tree_map
    cfg = get_config("llama3_2_1b").reduced(param_dtype="bfloat16",
                                            compute_dtype="bfloat16")
    model = build_model(cfg)
    state = init_train_state(model, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9))
    state, _ = make_train_step(model, lr_fn=constant_lr(1e-3))(
        state, {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
                "labels": jnp.asarray(toks[:, 1:], jnp.int32)})
    tree = jax.device_get(state)
    tt = to_torch(tree, device="cpu")
    assert tt["params"]["layers"]["wq"].dtype == torch.bfloat16
    assert tt["opt"]["m"]["layers"]["wq"].dtype == torch.float32
    assert tt["opt"]["v"]["embed"].dtype == torch.float32
    assert tt["opt"]["step"].dtype == torch.int32 and int(
        tt["opt"]["step"]) == 1
    assert tt["step"].dtype == torch.int32 and tt["step"].shape == ()
    back = dict(_leaves(to_numpy(tt)))
    for path, a in _leaves(tree):
        np.testing.assert_array_equal(back[path], _bits(a), err_msg=path)
    grads = tree_map(torch.zeros_like, tt["params"])
    _, opt = adamw_update(grads, tt["opt"], tt["params"],
                          torch.tensor(1e-3))
    assert int(opt["step"]) == 2 and opt["step"].dtype == torch.int32


def test_trained_ae_bn_state_round_trip():
    """A trained AE's params and BatchNorm state (mean, var and the
    f32 update count) cross bit for bit."""
    from repro.core import train_ae
    x = np.random.default_rng(1).random((96, 784), dtype=np.float32)
    params, bn = jax.device_get(train_ae(x, epochs=2, batch_size=32))
    assert float(bn["count"]) == 6
    tp, tb = to_torch(params, device="cpu"), to_torch(bn, device="cpu")
    assert tb["count"].dtype == torch.float32 and tb["count"].shape == ()
    assert float(tb["count"]) == 6
    for tree, t in ((params, tp), (bn, tb)):
        back = dict(_leaves(to_numpy(t)))
        for path, a in _leaves(tree):
            np.testing.assert_array_equal(back[path], a, err_msg=path)
