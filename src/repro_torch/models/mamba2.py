"""Mamba2 (SSD) block, the reference's ``repro.models.mamba2``.

The selective scan is computed chunkwise (the SSD decomposition of Dao &
Gu 2024): intra-chunk contributions are dense (Q x Q) products, the
inter-chunk state a short loop over n_chunks carries of (H, N, P). The
reference writes these as XLA einsums outside any Pallas kernel, and the
port keeps them plain PyTorch ops. Single-token decode runs the exact
recurrence with a carried (B, H, N, P) state and a depthwise-conv window
of the last W - 1 raw inputs; ``mamba_step`` writes both in place, so a
captured decode step replays on the same buffers.

Casts follow the reference's: projections in the compute dtype, the
scan, the skip, the gate and the group norm in f32, and the output
projection of the f32 activations against ``w_out`` promoted to f32 (the
reference's ``f32 @ bf16``).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor

from ..sharding.context import _clean_spec, local_apply, placements
from .common import ArchConfig, dense_init, groupnorm_heads

G = 1  # B/C projection groups (ngroups=1, standard for mamba2 LMs)
BATCH = ("pod", "data")


def init_mamba_layer(gen, cfg: ArchConfig, dtype, n_layers: int) -> Dict:
    """The reference's ``init_mamba_layer`` tree, every leaf stacked on a
    leading ``n_layers`` axis: ``dt_bias`` starts at 0, ``A_log`` at
    log(linspace(1, 16, H)) and the norms and skip at 1, as there; the
    projections and conv filters are drawn on their fan-in axis -2."""
    L = n_layers
    D, di, H, N, W = (cfg.d_model, cfg.d_inner, cfg.ssm_heads,
                      cfg.ssm_state, cfg.ssm_conv_width)
    dev = gen.device
    f32 = torch.float32

    def full(shape, value):
        return torch.full((L,) + shape, value, dtype=f32, device=dev)

    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=f32, device=dev))
    return {
        "ln1": full((D,), 1.0),
        "w_in_z": dense_init(gen, (L, D, di), dtype),
        "w_in_x": dense_init(gen, (L, D, di), dtype),
        "w_B": dense_init(gen, (L, D, G * N), dtype),
        "w_C": dense_init(gen, (L, D, G * N), dtype),
        "w_dt": dense_init(gen, (L, D, H), dtype),
        "dt_bias": full((H,), 0.0),
        "A_log": a_log.expand(L, H).clone(),
        "D_skip": full((H,), 1.0),
        "conv_x": dense_init(gen, (L, W, di), dtype),
        "conv_B": dense_init(gen, (L, W, G * N), dtype),
        "conv_C": dense_init(gen, (L, W, G * N), dtype),
        "ssm_norm": full((di,), 1.0),
        "w_out": dense_init(gen, (L, di, D), dtype),
    }


def causal_conv(x, w):
    """Depthwise causal conv: x (B, L, C), w (W, C); y_t = sum_j w[j]
    x_{t-W+1+j}, summed in f32 in the reference's order, cast back."""
    W, L = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(W):
        y = y + pad[:, j:j + L].float() * w[j].float()
    return y.to(x.dtype)


def conv_step(window, w):
    """window: (B, W, C), the last W inputs (current last); w: (W, C)."""
    return torch.einsum("bwc,wc->bc", window.float(),
                        w.float()).to(window.dtype)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """Chunked SSD scan.

    x: (B, L, H, P) inputs (dt applied inside); dt: (B, L, H) softplus'd
    step sizes; A: (H,) negative decay rates; Bm, Cm: (B, L, G, N).
    Returns (y (B, L, H, P), final state (B, H, N, P)), both in x.dtype.
    A length that is not a multiple of ``chunk`` is padded with dt = 0
    steps, an exact identity for the recurrence.
    """
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    if L % chunk:
        pad = chunk - L % chunk

        def padt(t):
            return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))

        y, s = ssd_chunked(padt(x), padt(dt), A, padt(Bm), padt(Cm), chunk,
                           initial_state)
        return y[:, :L], s
    nc, Q = L // chunk, chunk
    hg = H // G
    f32 = torch.float32
    xg = x.reshape(Bsz, nc, Q, G, hg, P).to(f32)
    dtg = dt.reshape(Bsz, nc, Q, G, hg)
    Bc = Bm.reshape(Bsz, nc, Q, G, N).to(f32)
    Cc = Cm.reshape(Bsz, nc, Q, G, N).to(f32)
    cs = torch.cumsum(dtg * A.reshape(G, hg), dim=2)  # inclusive, negative

    # intra-chunk (diagonal blocks): scores[b,c,q,r,g] = C_q . B_r
    scores = torch.einsum("bcqgn,bcrgn->bcqrg", Cc, Bc)
    gap = cs[:, :, :, None] - cs[:, :, None, :]        # (B,nc,Q,Q,G,hg)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    # mask before exp: a masked gap is > 0 and would overflow
    gap = torch.where(tri[None, None, :, :, None, None], gap,
                      torch.full_like(gap, -1e30))
    w_qr = scores[..., None] * torch.exp(gap) * dtg[:, :, None]  # dt at r
    y_diag = torch.einsum("bcqrgh,bcrghp->bcqghp", w_qr, xg)

    # chunk states, and each chunk's total decay
    tail = cs[:, :, -1:] - cs
    st = torch.einsum("bcqgh,bcqgn,bcqghp->bcghnp", torch.exp(tail) * dtg,
                      Bc, xg)                          # (B, nc, G, hg, N, P)
    total = torch.exp(cs[:, :, -1])                    # (B, nc, G, hg)

    # inter-chunk carry: the state before each chunk
    s = (torch.zeros((Bsz, G, hg, N, P), dtype=f32, device=x.device)
         if initial_state is None
         else initial_state.reshape(Bsz, G, hg, N, P).to(f32))
    before = []
    for c in range(nc):
        before.append(s)
        s = s * total[:, c][..., None, None] + st[:, c]
    s_before = torch.stack(before, dim=1)              # (B, nc, G, hg, N, P)

    y_off = torch.einsum("bcqgn,bcghnp,bcqgh->bcqghp", Cc, s_before,
                         torch.exp(cs))
    y = (y_diag + y_off).reshape(Bsz, L, H, P)
    return y.to(x.dtype), s.reshape(Bsz, H, N, P).to(x.dtype)


def _ssd_local(x, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """``ssd_chunked``, on each rank's own rows and heads where the
    arguments are DTensors (``model`` splits the heads where it divides
    them; B and C, one group, stay whole): DTensor has no sharded rule
    for the scan's batched products over flattened split dims."""
    if not isinstance(x, DTensor):
        return ssd_chunked(x, dt, A, Bm, Cm, chunk, initial_state)
    seq, heads = (BATCH, None, "model", None), (BATCH, "model", None, None)
    group = (BATCH, None, None, None)
    specs = [seq, (BATCH, None, "model"), ("model",), group, group]
    args = [x, dt, A, Bm, Cm]
    if initial_state is not None:
        specs.append(heads)
        args.append(initial_state)
    return local_apply(
        lambda x, dt, A, Bm, Cm, *s: ssd_chunked(x, dt, A, Bm, Cm, chunk,
                                                 *s),
        specs, *args, n_out=2, out_specs=(seq, heads))


def _ssd_step_local(state, x1, dt1, A, B1, C1):
    """``ssd_step`` in place on ``state``, on each rank's own rows and
    heads where the arguments are DTensors (DTensor has no sharded rule
    for its batched product over flattened split dims). A state laid out
    otherwise (``cache_specs`` splits a reduced model's largest of (H,
    N, P)) is stepped in the rows-and-heads layout and copied back.
    Returns y (B, H, P)."""
    if not isinstance(state, DTensor):
        return ssd_step(state, x1, dt1, A, B1, C1, out=state)[1]
    heads = (BATCH, "model", None, None)
    mesh = state.device_mesh
    want = placements(_clean_spec(mesh, heads, state.shape), mesh)
    work = state if tuple(state.placements) == want else \
        state.redistribute(mesh, want)
    y = local_apply(
        lambda x, dt, A, B, C, s: ssd_step(s, x, dt, A, B, C, out=s)[1],
        ((BATCH, "model", None), (BATCH, "model"), ("model",),
         (BATCH, None, None), (BATCH, None, None), None),
        x1, dt1, A, B1, C1, work)
    if work is not state:
        state.copy_(work)
    return y


def ssd_step(state, x1, dt1, A, B1, C1, out=None):
    """Exact single-step recurrence. state: (B, H, N, P); x1: (B, H, P);
    dt1: (B, H); B1, C1: (B, G, N). Returns (new state in state.dtype, y
    (B, H, P) in x1.dtype); y reads the f32 state before its cast. With
    ``out`` (``state`` itself for an in-place step) the new state is
    written there and returned."""
    H = state.shape[1]
    hg = H // G
    dt32 = dt1.float()
    dA = torch.exp(dt32 * A)                            # (B, H)
    Bh = B1.repeat_interleave(hg, dim=1).float()       # (B, H, N)
    Ch = C1.repeat_interleave(hg, dim=1).float()
    upd = dt32[..., None, None] * Bh[..., :, None] * x1.float()[..., None, :]
    new = state.float() * dA[..., None, None] + upd
    y = torch.einsum("bhnp,bhn->bhp", new, Ch)
    if out is None:
        out = new.to(state.dtype)
    else:
        out.copy_(new)
    return out, y.to(x1.dtype)


def mamba_seq(lp, x, cfg: ArchConfig, initial_state=None):
    """Full-sequence Mamba2 mixer on pre-normed input x (B, L, D).
    Returns (out (B, L, D) in x.dtype, final SSM state (B, H, N, P))."""
    Bsz, L, _ = x.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    z = x @ lp["w_in_z"]
    xr = F.silu(causal_conv(x @ lp["w_in_x"], lp["conv_x"]))
    Bm = F.silu(causal_conv(x @ lp["w_B"], lp["conv_B"]))
    Cm = F.silu(causal_conv(x @ lp["w_C"], lp["conv_C"]))
    dtv = F.softplus((x @ lp["w_dt"]).float() + lp["dt_bias"])  # (B, L, H)
    A = -torch.exp(lp["A_log"])
    xh = xr.reshape(Bsz, L, H, P)
    y, s_fin = _ssd_local(xh, dtv, A, Bm.reshape(Bsz, L, G, N),
                          Cm.reshape(Bsz, L, G, N), cfg.ssm_chunk,
                          initial_state)
    y = y + lp["D_skip"].reshape(H, 1) * xh.float()
    y = y * F.silu(z.float()).reshape(Bsz, L, H, P)
    y = groupnorm_heads(y, lp["ssm_norm"].reshape(H, P))
    out = y.reshape(Bsz, L, cfg.d_inner) @ lp["w_out"].float()
    return out.to(x.dtype), s_fin


def mamba_step(lp, x, state, conv_buf, cfg: ArchConfig):
    """Single-token Mamba2 mixer, in place.

    x: (B, 1, D) pre-normed; state: (B, H, N, P); conv_buf: {"x", "B",
    "C"} the last W - 1 raw conv inputs, each (B, W - 1, C). The new
    state is written into ``state`` and each buffer rolled in place (the
    window is read before the buffer is overwritten). Returns (out (B, 1,
    D), state, conv_buf): the same tensors and dict it was given.
    """
    Bsz = x.shape[0]
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    x0 = x[:, 0]
    z = x0 @ lp["w_in_z"]
    wins = {}
    for key, w in (("x", "w_in_x"), ("B", "w_B"), ("C", "w_C")):
        buf = conv_buf[key]
        wins[key] = torch.cat([buf, (x0 @ lp[w])[:, None]], dim=1)
        buf.copy_(wins[key][:, 1:])
    xr = F.silu(conv_step(wins["x"], lp["conv_x"]))
    Bm = F.silu(conv_step(wins["B"], lp["conv_B"]))
    Cm = F.silu(conv_step(wins["C"], lp["conv_C"]))
    dtv = F.softplus((x0 @ lp["w_dt"]).float() + lp["dt_bias"])  # (B, H)
    A = -torch.exp(lp["A_log"])
    xh = xr.reshape(Bsz, H, P)
    y = _ssd_step_local(state, xh, dtv, A, Bm.reshape(Bsz, G, N),
                        Cm.reshape(Bsz, G, N))
    y = y.float() + lp["D_skip"].reshape(H, 1) * xh.float()
    y = y * F.silu(z.float()).reshape(Bsz, H, P)
    y = groupnorm_heads(y, lp["ssm_norm"].reshape(H, P))
    out = (y.reshape(Bsz, cfg.d_inner) @ lp["w_out"].float()).to(x.dtype)
    return out[:, None], state, conv_buf
