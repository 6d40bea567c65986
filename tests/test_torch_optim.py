"""The port's AdamW and schedules against ``repro.optim`` on the same
numpy params and gradients: three steps of ``adamw_update`` with and
without clipping and weight decay, on f32 and bf16 leaves (f32 moments
in both), and each schedule at its decay and warm-up boundaries, all at
rtol 1e-6 (leaves also at atol 1e-6 of the leaf's largest magnitude:
the global norm sums in another order than XLA's, one ulp apart on one
of these steps, and a moment entry whose steps cancel carries that ulp
into its low digits). The bf16 case guards the promotion trap: torch's
``g * scale`` with a bf16 ``g`` and a 0-d f32 ``scale`` stays bf16,
JAX's is f32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro import optim as jopt
from repro_torch import optim as topt
from repro_torch.bridge import to_numpy, to_torch
from repro_torch.tree import leaves

RTOL = 1e-6


def _tree(rng, dtype):
    """A nested tree (dict of dicts and a list) of mixed shapes."""
    def a(*shape):
        return jnp.asarray(rng.normal(size=shape).astype(np.float32), dtype)
    return {"w": a(7, 5), "layers": [{"b": a(5), "s": a(3, 2)},
                                     {"b": a(5), "s": a(3, 2)}],
            "ln": jnp.ones((4,), jnp.float32)}


def _f32(tree):
    """bf16 leaves of a ``to_numpy`` tree (uint16 views) as f32."""
    def rec(node):
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, list):
            return [rec(v) for v in node]
        if node.dtype == np.uint16:
            return (node.astype(np.uint32) << 16).view(np.float32)
        return node
    return rec(tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm,weight_decay",
                         [(None, 0.0), (1.0, 0.0), (0.5, 0.01)],
                         ids=["plain", "clip", "clip-wd"])
def test_adamw_update(dtype, clip_norm, weight_decay):
    rng = np.random.default_rng(0)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = _tree(rng, jdt)
    tp = to_torch(jp, device="cpu")
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    assert all(l.dtype == torch.float32 for l in leaves(ts["m"]))
    lr = 1e-2
    for _ in range(3):
        g = _tree(rng, jdt)
        # the clip must bite: these gradients' global norm is ~7
        jp, js = jopt.adamw_update(g, js, jp, jnp.float32(lr),
                                   weight_decay=weight_decay,
                                   clip_norm=clip_norm)
        tp, ts = topt.adamw_update(to_torch(g, device="cpu"), ts, tp,
                                   torch.tensor(lr, dtype=torch.float32),
                                   weight_decay=weight_decay,
                                   clip_norm=clip_norm)
    assert int(ts["step"]) == int(js["step"]) == 3
    assert ts["step"].dtype == torch.int32
    for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        got_np = _f32(to_numpy(got))
        for path_got, path_want in zip(leaves_np(got_np), leaves_np(want)):
            want_f = np.asarray(path_want, np.float32)
            np.testing.assert_allclose(
                path_got, want_f, rtol=RTOL,
                atol=RTOL * float(np.abs(want_f).max()))
    assert leaves(tp)[0].dtype == (torch.bfloat16 if dtype == "bfloat16"
                                   else torch.float32)


def leaves_np(tree):
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in leaves_np(tree[k])]
    if isinstance(tree, list):
        return [l for v in tree for l in leaves_np(v)]
    return [tree]


def test_global_norm():
    rng = np.random.default_rng(1)
    for dtype in (jnp.float32, jnp.bfloat16):
        t = _tree(rng, dtype)
        np.testing.assert_allclose(
            float(topt.global_norm(to_torch(t, device="cpu"))),
            float(jopt.global_norm(t)), rtol=RTOL)


@pytest.mark.parametrize("name,make", [
    ("constant", lambda m: m.constant_lr(3e-4)),
    ("step_decay", lambda m: m.step_decay(1e-2, every_steps=15)),
    ("step_decay_half", lambda m: m.step_decay(1e-2, decay=0.5,
                                               every_steps=7)),
    ("cosine", lambda m: m.cosine_warmup(3e-4, warmup_steps=10,
                                         total_steps=100)),
    ("cosine_nowarm", lambda m: m.cosine_warmup(1e-3, warmup_steps=0,
                                                total_steps=4)),
])
def test_schedules(name, make):
    """Every step around the boundaries: a decay boundary moved by one
    step (reading ``step`` after the increment) shows here."""
    jf, tf = make(jopt), make(topt)
    for s in [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 14, 15, 16, 29, 30,
              31, 44, 45, 46, 50, 99, 100, 101, 150]:
        want = float(jf(jnp.asarray(s, jnp.int32)))
        got = tf(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=RTOL, atol=0,
                                   err_msg=f"{name} step {s}")
