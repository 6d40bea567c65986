"""Kernel 5: one RWKV6 decode step for every (row, head) — one launch per
layer of every RWKV decode step, updating the recurrent state in place.

    o[j]    = sum_i r[i] * (S[i,j] + u[i] k[i] v[j])
    S'[i,j] = exp(logw[i]) * S[i,j] + k[i] v[j]

Source note:

* Replaces ``src/repro/kernels/wkv_step.py:wkv_step_pallas`` (body
  ``_kernel``), reached through ``ops.wkv_decode_step``. (The reference's
  serving decode runs ``wkv_scan`` over one token, the same function; the
  port's decode takes the kernel.)
* Bound on the H100 at the serving shapes (``rwkv6_7b``: H 64, P 64, f32
  state, bf16 r/k/v, B = decode bucket): bytes. The (B, H, P, P) state
  must be read and written once, 2.1 MB a row, for about 5 flops per
  state element: 8.6 MB and 2.58 us at 3.35 TB/s at B = 4 (the serving
  bucket), 67 MB and 20.6 us at B = 32.
* Design: one block of 4P threads per (row, head) makes one pass over
  the state tile and one round trip to device memory: its first
  instructions issue every thread's state loads (16-byte vectors, whole
  rows per warp) together with r, k, v, logw and ``u``, so one barrier
  waits for all of them. Each thread keeps its share of ``r @ S`` in
  registers and writes S' back at once as 16-byte vectors; the partial
  sums are added in a fixed order (a shuffle butterfly, then warp
  order), so two launches give the same bits. The new state may be
  written over the old (``out_state=state``), which saves a second
  state buffer on every layer of every step. ``state`` and
  ``out_state`` must start on 16 bytes (the wrapper raises otherwise).
* Measured time: see ``PERF.md`` (``chip_smoke.py`` on the H100).

CUDA source: ``csrc/wkv_step.cu``. On a CPU tensor the wrapper runs the
plain version (the reference's ``rwkv6.wkv_step`` arithmetic); on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..sharding.context import _clean_spec, local_apply, placements
from .build import check, check_aligned, fake_launch, is_fake, library

SUPPORTED_P = (16, 32, 64)


def wkv_step_plain(r, k, v, logw, u, state,
                   out_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version. r/k/v/logw (B, H, P), u (H, P), state (B, H, P, P)
    -> (o (B, H, P) f32, new state (B, H, P, P) f32). Inputs are upcast
    to f32. With ``out_state`` (which may be ``state`` itself) the new
    state is written there, with the same values either way."""
    S = state.float()
    rt, kt, vt, wt = (a.float() for a in (r, k, v, logw))
    kv = kt[..., :, None] * vt[..., None, :]
    o = torch.einsum("bhi,bhij->bhj", rt,
                     S + (u.float() * kt)[..., :, None] * vt[..., None, :])
    S_new = torch.exp(wt)[..., :, None] * S + kv
    if out_state is None:
        return o, S_new
    return o, out_state.copy_(S_new)


def _check(r, k, v, logw, u, state, out_state) -> None:
    B, H, P = r.shape
    if k.shape != r.shape or v.shape != r.shape or logw.shape != r.shape \
            or u.shape != (H, P) or state.shape != (B, H, P, P) \
            or out_state.shape != state.shape:
        raise ValueError(
            f"wkv_step: shape mismatch r {tuple(r.shape)} k "
            f"{tuple(k.shape)} v {tuple(v.shape)} logw {tuple(logw.shape)} "
            f"u {tuple(u.shape)} state {tuple(state.shape)}")
    if r.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"wkv_step: r/k/v must share one dtype, float32 or "
                         f"bfloat16; got {r.dtype} {k.dtype} {v.dtype}")
    for name, t in (("logw", logw), ("u", u), ("state", state),
                    ("out_state", out_state)):
        if t.dtype != torch.float32:
            raise ValueError(f"wkv_step: {name} must be float32, got "
                             f"{t.dtype}")


def wkv_step(r, k, v, logw, u, state, out_state: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One RWKV6 decode step: r/k/v (B, H, P) f32 or bf16, logw (B, H, P)
    f32, u (H, P) f32, state (B, H, P, P) f32 -> (o (B, H, P) f32,
    ``out_state``). ``out_state`` receives the new state; it is ``state``
    itself (in place, as the decode runs it) or a tensor that does not
    overlap it."""
    if isinstance(state, DTensor):
        return _sharded(r, k, v, logw, u, state, out_state)
    _check(r, k, v, logw, u, state, out_state)
    if r.device.type == "cpu":
        return wkv_step_plain(r, k, v, logw, u, state, out_state)
    if r.device.type != "cuda":
        raise ValueError(f"wkv_step: unsupported device {r.device}")
    B, H, P = r.shape
    if P not in SUPPORTED_P:
        raise ValueError(f"wkv_step: unsupported head size P={P} (P in "
                         f"{SUPPORTED_P})")
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u),
                    ("state", state), ("out_state", out_state)):
        if not t.is_contiguous() or t.device != r.device:
            raise ValueError(f"wkv_step: {name} must be contiguous on "
                             f"{r.device}")
    if is_fake(r):
        # the dry run's fake tensors: the launch's output, its work
        # reported, nothing launched or counted
        fake_launch("wkv_step", 5.0 * B * H * P * P)
        return torch.empty((B, H, P), dtype=torch.float32,
                           device=r.device), out_state
    check_aligned("wkv_step", state=state, out_state=out_state)
    a, b = state.data_ptr(), out_state.data_ptr()
    n = state.numel() * state.element_size()
    if a != b and a < b + n and b < a + n:
        raise ValueError("wkv_step: out_state overlaps state without being "
                         "state itself")
    o = torch.empty((B, H, P), dtype=torch.float32, device=r.device)
    # the library launches on the current device: the tensors' one
    with torch.cuda.device(r.device):
        rc = library().wkv_step(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), state.data_ptr(), o.data_ptr(), out_state.data_ptr(),
            B, H, P, int(r.dtype == torch.bfloat16),
            torch.cuda.current_stream(r.device).cuda_stream)
    check(rc, "wkv_step")
    wkv_step.launches += 1
    return o, out_state


wkv_step.launches = 0


def _sharded(r, k, v, logw, u, state, out_state):
    """``wkv_step`` of a sharded decode: each rank steps its own rows, and
    its own heads where ``model`` divides them, writing its shard of
    ``out_state``. A state laid out otherwise (``cache_specs`` splits the
    largest of a reduced model's (H, P, P) dims) is stepped in that
    layout and copied back."""
    row, head = ("pod", "data"), "model"
    spec3, spec4 = (row, head, None), (row, head, None, None)
    mesh = state.device_mesh
    want = placements(_clean_spec(mesh, spec4, state.shape), mesh)

    def lay(x):
        return x if tuple(x.placements) == want else x.redistribute(mesh,
                                                                    want)

    src = lay(state)
    dst = src if out_state is state else lay(out_state)
    o = local_apply(
        lambda r, k, v, logw, u, s, out: wkv_step(r, k, v, logw, u, s,
                                                  out)[0],
        (spec3, spec3, spec3, spec3, (head, None), None, None),
        r, k, v, logw, u, src, dst)
    if dst is not out_state:
        out_state.copy_(dst)
    return o, out_state
