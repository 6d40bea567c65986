"""The port's AE and MLP trainers against ``repro.core.trainer``.

One step: the reference's ``train_ae`` / ``train_mlp`` run one epoch of
one batch from ``PRNGKey(seed)``; the port's ``fit_ae`` / ``fit_mlp``
run the same from that init, bridged, on the same rows in the same order
(the same numpy permutation). Loss, BatchNorm state (``count`` too) and
the gradients must agree at rtol 1e-5 (atol 1e-7), and every parameter
leaf after the step at rtol 1e-5 where the reference's gradient is at
least 1e-5: AdamW's first step moves an entry by ``lr * g / (|g| +
1e-8)``, which for a gradient within a few decades of 1e-8 hangs on
digits that rounding decides (a hidden unit active in one row, an input
pixel near zero); those entries (at most 1.6% of a leaf on these seeds,
5% allowed) are held to the first step's bound, ``lr``.

The bias in front of BatchNorm (the AE's ``b_enc``, each MLP layer's
``b``) is left out altogether. Train-mode BatchNorm subtracts the batch
mean, so that bias's gradient is zero in exact arithmetic and rounding
noise (~1e-9) in f32; AdamW's first step divides it by ``|g| + 1e-8``,
so the leaf moves by noise, differently in each implementation. Its
gradient is asserted below 1e-6 in both instead, and whole training
runs are compared by their decisions (routing accuracy), not their
weights.

Whole run: a bank trained by the port on the ``tests/test_system.py``
fixture routes each client split with mean coarse accuracy > 0.9,
within 2 points of the JAX-trained bank's, and the ``mnist`` fine match
beats twice chance. The ``cuda`` cases hold one step on the card to the
same step on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro.core import autoencoder as jae
from repro.core import build_matcher as jbuild_matcher
from repro.core import mlp_baseline as jmlp
from repro.core import train_ae as jtrain_ae
from repro.core import train_bank as jtrain_bank
from repro.core import train_mlp as jtrain_mlp
from repro.data import load_benchmark
from repro_torch import core as tcore
from repro_torch.bridge import to_numpy, to_torch
from repro_torch.core import autoencoder as tae
from repro_torch.core import mlp_baseline as tmlp
from repro_torch.core.trainer import fit_ae, fit_mlp
from repro_torch.optim import adamw_init
from repro_torch.tree import value_and_grad

RTOL, ATOL = 1e-5, 1e-7
PRE_BN_GRAD = 1e-6


@pytest.fixture(scope="module")
def small_bench():
    return load_benchmark(names=["mnist", "har", "reuters"],
                          n_per_dataset=1200, seed=0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _close(got, want, skip=(), label=""):
    """Every leaf of two {name: array} dicts, but ``skip``."""
    assert set(got) == set(want), label
    for k in want:
        if k in skip:
            continue
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{label}{k}")


GRAD_FLOOR = 1e-5
LR = 1e-2     # the trainers' base_lr


def _step_close(got, want, p0, grad, skip=(), label=""):
    """Leaves after one AdamW step (flat {path: array}): rtol 1e-5 where
    |grad| >= GRAD_FLOOR (95% of every leaf at least), else moved by at
    most LR from ``p0``."""
    assert set(got) == set(want), label
    for k in want:
        if k.split("/")[-1] in skip:
            continue
        big = np.abs(grad[k]) >= GRAD_FLOOR
        assert big.mean() > 0.95, (label, k, big.mean())
        np.testing.assert_allclose(got[k][big], want[k][big], rtol=RTOL,
                                   atol=ATOL, err_msg=f"{label}{k}")
        assert (np.abs(got[k] - p0[k]) <= LR * (1 + RTOL)
                + np.spacing(np.abs(p0[k]))).all(), (label, k)


def _batch(small_bench, n=64):
    x, y = small_bench["mnist"]["server"]
    return x[:n], y[:n]


def test_ae_step_matches_reference(small_bench):
    x, _ = _batch(small_bench)
    key = jax.random.PRNGKey(5)
    jp0, js0 = jae.init_ae(key)
    tp0, ts0 = (to_torch(_np(t), device="cpu") for t in (jp0, js0))

    # loss, BN update and the pre-BN bias's gradient on the batch
    (jl, jst), jg = jax.value_and_grad(jae.loss_fn, has_aux=True)(
        jp0, js0, jnp.asarray(x))
    (tl, tst), tg = value_and_grad(tae.loss_fn, tp0, ts0,
                                   torch.from_numpy(x))
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    _close({k: v.numpy() for k, v in tst.items()}, _np(jst), label="bn ")
    assert float(tst["count"]) == 1.0
    _close({k: v.numpy() for k, v in tg.items()}, _np(jg), skip=("b_enc",),
           label="grad ")
    assert float(jnp.abs(jg["b_enc"]).max()) < PRE_BN_GRAD
    assert float(tg["b_enc"].abs().max()) < PRE_BN_GRAD

    # one trainer step: one epoch of one batch, the reference's order
    jp1, js1 = jtrain_ae(x, key=key, epochs=1, batch_size=len(x), seed=0)
    tp1, ts1, opt = fit_ae(x, tp0, ts0, adamw_init(tp0), epochs=1,
                           batch_size=len(x), seed=0)
    assert int(opt["step"]) == 1
    _step_close(_flat(to_numpy(tp1)), _flat(_np(jp1)), _flat(_np(jp0)),
                _flat(_np(jg)), skip=("b_enc",), label="params ")
    _close(to_numpy(ts1), _np(js1), label="bn ")
    assert float(ts1["count"]) == 1.0
    # the inputs were not modified
    _close(to_numpy(tp0), _np(jp0), label="init ")


def test_mlp_step_matches_reference(small_bench):
    x, y = _batch(small_bench)
    y = (y % 4).astype(np.int32)
    jp0, js0 = jmlp.init_mlp(jax.random.PRNGKey(3), 784, 4)
    tp0, ts0 = (to_torch(_np(t), device="cpu") for t in (jp0, js0))

    (jl, _), jg = jax.value_and_grad(jmlp.loss_fn, has_aux=True)(
        jp0, js0, jnp.asarray(x), jnp.asarray(y))
    (tl, _), tg = value_and_grad(tmlp.loss_fn, tp0, ts0,
                                 torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    for i, (a, b) in enumerate(zip(tg["layers"], jg["layers"])):
        _close({k: v.numpy() for k, v in a.items()}, _np(b), skip=("b",),
               label=f"grad layer {i} ")
        assert float(jnp.abs(b["b"]).max()) < PRE_BN_GRAD
        assert float(a["b"].abs().max()) < PRE_BN_GRAD

    jp1, js1 = jtrain_mlp(x, y, n_classes=4, epochs=1, batch_size=len(x),
                          seed=3)
    tp1, ts1, _ = fit_mlp(x, y, tp0, ts0, adamw_init(tp0), epochs=1,
                          batch_size=len(x), seed=3)
    got = to_numpy(tp1)
    _step_close(_flat(got), _flat(_np(jp1)), _flat(_np(jp0)),
                _flat(_np(jg)), skip=("b",), label="params ")
    for i in range(2):
        _close(to_numpy(ts1[i]), _np(js1[i]), label=f"bn layer {i} ")
    # the port's predict is the reference's argmax on the same weights
    np.testing.assert_array_equal(
        tmlp.predict(tp1, ts1, torch.from_numpy(x)).numpy(),
        np.asarray(jmlp.predict(
            to_torch_np(got), to_torch_np(to_numpy(ts1)), jnp.asarray(x))))


def to_torch_np(tree):
    """A ``to_numpy`` tree as reference arrays."""
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _coarse_accs(assign, bench, names):
    """Mean coarse accuracy over datasets, per client split."""
    out = {}
    for client in ("client_a", "client_b"):
        accs = [float((assign(bench[n][client][0]) == i).mean())
                for i, n in enumerate(names)]
        out[client] = float(np.mean(accs))
    return out


def test_port_trained_bank_routes_like_the_reference(small_bench):
    names = list(small_bench)
    data = [(n, small_bench[n]["server"][0]) for n in names]
    cents = [small_bench[n]["server"] for n in names]
    taes, tnames = tcore.train_bank(data, epochs=40, batch_size=64,
                                    device="cpu")
    assert tnames == names
    assert all(float(s["count"]) == 40 * (600 // 64) for _, s in taes)
    tm = tcore.build_matcher(taes, names, cents, device="cpu")
    jaes, _ = jtrain_bank(data, epochs=40, batch_size=64)
    jm = jbuild_matcher(jaes, names, cents)

    got = _coarse_accs(lambda x: tm.assign_coarse(
        torch.from_numpy(x)).numpy(), small_bench, names)
    want = _coarse_accs(lambda x: np.asarray(jm.assign_coarse(
        jnp.asarray(x))), small_bench, names)
    for client in got:
        assert got[client] > 0.9, (client, got, want)
        assert abs(got[client] - want[client]) <= 0.02, (client, got, want)

    i = names.index("mnist")
    x, y = small_bench["mnist"]["client_a"]
    fine = tm.assign_fine(torch.from_numpy(x),
                          torch.full((len(x),), i)).numpy()
    assert (fine == y).mean() > 2.0 / (int(y.max()) + 1)


# ---------------------------------------------------------------------------
# on the card: one step against the same step on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_ae_and_mlp_steps_match_cpu(cuda, small_bench):
    x, y = _batch(small_bench, 256)
    y = (y % 4).astype(np.int32)
    for init, fit, skip, args in (
            (lambda d: tae.init_ae(7, device=d), fit_ae, ("b_enc",), (x,)),
            (lambda d: tmlp.init_mlp(7, 784, 4, device=d), fit_mlp, ("b",),
             (x, y))):
        p0, s0 = init("cpu")
        loss = tae.loss_fn if fit is fit_ae else tmlp.loss_fn
        _, grad = value_and_grad(loss, p0, s0, *map(torch.from_numpy, args))
        out = {}
        for dev in ("cpu", cuda):
            p = to_torch(to_numpy(p0), device=dev)
            s = to_torch(to_numpy(s0), device=dev)
            out[str(dev)] = to_numpy(fit(*args, p, s, adamw_init(p),
                                         epochs=1, batch_size=len(x))[:2])
        (gp, gs), (wp, ws) = out["cuda"], out["cpu"]
        _step_close(_flat(gp), _flat(wp), _flat(to_numpy(p0)),
                    _flat(to_numpy(grad)), skip=skip, label="card ")
        _close(_flat(gs), _flat(ws), label="card bn ")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in tree
                for k2, v2 in _flat(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}
