"""The port's LM training path against the reference's, on the CPU in
f32 at reduced widths.

- ``DecoderLM.loss`` and ``RWKV6.loss`` with their gradients against
  ``jax.value_and_grad`` on the same bridged params and batch: dense at
  S 128 (the flash path's two KV chunks), RWKV6 at S 32 (``wkv_chunked``,
  two chunks) and S 24 (its scan fallback), with the leaves the
  reference's init zeroes filled with noise. Each gradient leaf is held
  at ``|got - want| <= tol * (|want| + max|want|)``: tol 2e-5 for dense
  (the kernel tests' f32 rtol) and 1e-4 where ``wkv_chunked`` runs (its
  sums run in another order than XLA's; ``tests/test_torch_rwkv.py``).
  ``remat`` (``torch.utils.checkpoint``) gives the same loss bits and
  gradients as without.
- ``make_train_step`` with 1 and 4 microbatches: equal to each other (the
  ``tests/test_system.py`` check, loss rtol 1e-4 and params atol 2e-4)
  and each to the reference's step: loss at tol, every param leaf at
  rtol 1e-5 where the reference's clipped gradient is at least 1e-5 and
  within the step's bound ``lr`` elsewhere (AdamW's first step is ``lr *
  g / (|g| + 1e-8)``, which for a gradient near 1e-8 hangs on rounding),
  the f32 moments at tol.
- ``Trainer`` lowers the loss by > 0.25 in 60 steps (the reference's
  ``tests/test_system.py`` bar).
- ``cuda``: one step of each reduced f32 model on the card against the
  same step on the CPU, on the inputs the CPU is held to JAX on, at the
  same tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro.configs import get_config
from repro.models import build_model
from repro.optim import constant_lr as jconstant_lr
from repro.train.loop import init_train_state as jinit_state
from repro.train.loop import make_train_step as jmake_step
from repro_torch.bridge import to_numpy, to_torch
from repro_torch.configs import get_config as tget
from repro_torch.data import synthetic_token_stream
from repro_torch.models import build_model as tbuild
from repro_torch.optim import constant_lr
from repro_torch.train import Trainer, make_train_step
from repro_torch.tree import leaves, tree_map, value_and_grad

DENSE_TOL = 2e-5
CHUNKED_TOL = 1e-4
LR = 1e-3
GRAD_FLOOR = 1e-5
#: leaves the reference's RWKV6 init zeroes
ZERO_LEAVES = ("maa_x", "maa_base", "maa_w1", "first_u", "ch_maa_k",
               "ch_maa_r")


def trained_like(params, seed):
    """Seeded noise of a trained checkpoint's scale in the zero leaves:
    mixes in [0, 1), a small LoRA input, a bonus ~0.5."""
    rng = np.random.default_rng(seed)
    lay = dict(params["layers"])
    D = lay["maa_x"].shape[-1]
    for name in ZERO_LEAVES:
        shape = lay[name].shape
        if name == "maa_w1":
            v = rng.normal(size=shape) * (0.5 / np.sqrt(D))
        elif name == "first_u":
            v = rng.normal(size=shape) * 0.5
        else:
            v = rng.random(shape)
        lay[name] = v.astype(np.float32)
    return {**params, "layers": lay}


def _models(arch):
    cfg = get_config(arch).reduced()
    jm, tm = build_model(cfg), tbuild(tget(arch).reduced())
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    if cfg.family == "rwkv":
        jp = trained_like(jp, 1)
    return cfg, jm, tm, jp


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _t(batch, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _leaves_np(tree):
    return [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(
        jax.device_get(tree))]


def _assert_tree(got, want, tol, label):
    """got: port tree; want: reference tree (both walked by sorted key)."""
    g, w = [t.float().numpy() for t in leaves(got)], _leaves_np(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        bound = tol * (np.abs(b) + np.abs(b).max())
        assert (np.abs(a - b) <= bound).all(), (
            f"{label} leaf {i}: max err {np.abs(a - b).max()}, scale "
            f"{np.abs(b).max()}")


CASES = [("llama3_2_1b", 128, DENSE_TOL), ("rwkv6_7b", 32, CHUNKED_TOL),
         ("rwkv6_7b", 24, CHUNKED_TOL)]
IDS = ["dense-S128", "rwkv-S32-chunked", "rwkv-S24-scan"]


@pytest.mark.parametrize("arch,S,tol", CASES, ids=IDS)
def test_loss_and_grads_match_reference(arch, S, tol):
    cfg, jm, tm, jp = _models(arch)
    batch = _batch(cfg, 4, S)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = to_torch(jp, device="cpu")
    (tl, taux), tg = value_and_grad(tm.loss, tp, _t(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=tol)
    assert set(taux) == set(jaux)
    np.testing.assert_allclose(float(taux["ce"]), float(jaux["ce"]),
                               rtol=tol)
    _assert_tree(tg, jg, tol, f"{arch} grad")
    # checkpointed layers recompute the same forward: the same loss bits
    # and gradients (a tied embedding's two gradient terms may add in
    # another order: within 1e-6 of the leaf's scale)
    rm = tbuild(tm.cfg.replace(remat=True))
    (rl, _), rg = value_and_grad(rm.loss, tp, _t(batch))
    assert float(rl) == float(tl)
    for a, b in zip(leaves(rg), leaves(tg)):
        assert (a - b).abs().max() <= 1e-6 * b.abs().max()


def _clipped_grad(jm, jp, batch, mb):
    """The reference's clipped gradient of one step (microbatches summed
    in f32, divided by their count, clipped to global norm 1)."""
    B = batch["tokens"].shape[0]
    grad = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))
    gs = [grad(jp, {k: jnp.asarray(v[i * B // mb:(i + 1) * B // mb])
                    for k, v in batch.items()}) for i in range(mb)]
    g = jax.tree_util.tree_map(lambda *x: sum(a.astype(jnp.float32)
                                              for a in x) / mb, *gs)
    gn = float(jnp.sqrt(sum(jnp.sum(jnp.square(l))
                            for l in jax.tree_util.tree_leaves(g))))
    return [a * min(1.0, 1.0 / max(gn, 1e-9)) for a in _leaves_np(g)]


@pytest.mark.parametrize("arch,S,tol", CASES[:2], ids=IDS[:2])
def test_train_step_matches_reference(arch, S, tol):
    cfg, jm, tm, jp = _models(arch)
    batch = _batch(cfg, 8, S, seed=1)
    s0 = jinit_state(jm, jax.random.PRNGKey(0))
    s0 = {**s0, "params": jax.tree_util.tree_map(jnp.asarray, jp)}
    ts0 = {"params": to_torch(jp, device="cpu"),
           "opt": to_torch(jax.device_get(s0["opt"]), device="cpu"),
           "step": torch.zeros((), dtype=torch.int32)}
    out = {}
    for mb in (1, 4):
        js, jmet = jax.jit(jmake_step(jm, lr_fn=jconstant_lr(LR),
                                      microbatches=mb))(s0, {
            k: jnp.asarray(v) for k, v in batch.items()})
        ts, tmet = make_train_step(tm, lr_fn=constant_lr(LR),
                                   microbatches=mb)(ts0, _t(batch))
        assert int(ts["step"]) == 1 and int(ts["opt"]["step"]) == 1
        np.testing.assert_allclose(float(tmet["loss"]),
                                   float(jmet["loss"]), rtol=tol)
        assert float(tmet["lr"]) == float(jmet["lr"])
        grad = _clipped_grad(jm, jp, batch, mb)
        for i, (a, b, p0, g) in enumerate(zip(
                leaves(ts["params"]), _leaves_np(js["params"]),
                _leaves_np(jp), grad)):
            a = a.numpy()
            big = np.abs(g) >= GRAD_FLOOR
            np.testing.assert_allclose(a[big], b[big], rtol=1e-5, atol=1e-7,
                                       err_msg=f"{arch} mb {mb} leaf {i}")
            assert (np.abs(a - p0) <= LR * (1 + 1e-5)
                    + np.spacing(np.abs(p0))).all()
        _assert_tree(ts["opt"]["m"], js["opt"]["m"], tol, "m")
        _assert_tree(ts["opt"]["v"], js["opt"]["v"], tol, "v")
        out[mb] = ts, tmet
        # the step modifies none of its inputs
        assert all(torch.equal(a, b) for a, b in zip(
            leaves(ts0["params"]), leaves(to_torch(jp, device="cpu"))))
    (s1, m1), (s4, m4) = out[1], out[4]
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-4)
    for a, b in zip(leaves(s1["params"]), leaves(s4["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4)


def test_trainer_reduces_loss():
    cfg = tget("llama3.2-1b").reduced(n_layers=2, d_model=64,
                                      vocab_size=256)
    tr = Trainer(tbuild(cfg), lr=3e-3, total_steps=60, device="cpu")
    stream = synthetic_token_stream(cfg.vocab_size, 32, 8, seed=0)
    hist = tr.fit(stream, steps=60, log_every=10)
    assert [i for i, _ in hist] == [0, 10, 20, 30, 40, 50, 59]
    first, last = hist[0][1], hist[-1][1]
    assert last < first - 0.25, f"loss did not decrease: {first} -> {last}"
    assert int(tr.state["step"]) == 60
    assert int(tr.state["opt"]["step"]) == 60


# ---------------------------------------------------------------------------
# on the card: one step against the same step on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch,S,tol", CASES[:2], ids=IDS[:2])
def test_cuda_train_step_matches_cpu(cuda, arch, S, tol):
    cfg, _, tm, jp = _models(arch)
    # the inputs test_train_step_matches_reference holds the CPU to JAX on
    batch = _batch(cfg, 8, S, seed=1)
    step = make_train_step(tm, lr_fn=constant_lr(LR), microbatches=2)
    out = {}
    for dev in ("cpu", cuda):
        p = to_torch(jp, device=dev)
        state = {"params": p, "opt": tree_map(lambda x: x, {
            "m": tree_map(torch.zeros_like, p),
            "v": tree_map(torch.zeros_like, p),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}
        (_, _), g = value_and_grad(tm.loss, p, _t(batch, dev))
        s, met = step(state, _t(batch, dev))
        out[str(dev)] = (to_numpy(g), to_numpy(s), float(met["loss"]))
    (gc, sc, lc), (gd, sd, ld) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(ld, lc, rtol=tol)
    for i, (a, b) in enumerate(zip(leaves(to_torch(gd, device="cpu")),
                                   leaves(to_torch(gc, device="cpu")))):
        a, b = a.numpy(), b.numpy()
        err, scale = np.abs(a - b), np.abs(b).max()
        assert (err <= tol * (np.abs(b) + scale)).all(), (
            f"{arch} grad leaf {i} {b.shape}: max err {err.max()}, worst "
            f"err / bound {(err / (tol * (np.abs(b) + scale))).max()}")
    for a, b, g in zip(leaves(to_torch(sd["params"], device="cpu")),
                       leaves(to_torch(sc["params"], device="cpu")),
                       leaves(to_torch(gc, device="cpu"))):
        big = np.abs(g.numpy()) >= GRAD_FLOOR * 10
        np.testing.assert_allclose(a.numpy()[big], b.numpy()[big],
                                   rtol=1e-5, atol=1e-7)
