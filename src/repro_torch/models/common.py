"""Shared model-zoo building blocks: configs, norms, RoPE, initializers.

Params are nested dicts of tensors with the reference package's layouts:
layer stacks carry a leading ``L`` axis and weights are ``(in, out)``,
applied as ``x @ w``. Every initializer draws from an explicit
``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterator, Sequence

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..device import resolve_device
from ..sharding.context import (_clean_spec, all_reduce, as_dtensor,
                                local_apply, placements, replicate_dim,
                                shard_dims, shard_index, unshard_batch_axes)

BATCH = ("pod", "data")

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "f32": torch.float32,
    "bf16": torch.bfloat16,
}


def dt(name: str) -> torch.dtype:
    return DTYPES[name]


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    """One config describes any architecture family in the zoo."""

    name: str
    family: str  # dense | moe | rwkv | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    moe_impl: str = "dispatch"  # dispatch | dense
    # --- attention variants ---
    sliding_window: int = 0  # 0 = full attention
    attn_chunk: int = 1024  # KV block for chunked flash attention
    # --- SSM / RWKV ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    rwkv_lora_dim: int = 32
    # --- hybrid (zamba-style shared attention) ---
    attn_every: int = 0  # apply shared attn block after every N core layers
    # --- encoder-decoder ---
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    enc_seq_len: int = 0  # stub encoder frames (audio)
    # --- multimodal stub ---
    n_stub_embeds: int = 0  # patch embeddings prepended (vlm)
    # --- dtypes / memory policy ---
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = False
    train_microbatches: int = 1
    seq_parallel: bool = False  # shard the seq dim of activations over model
    # provenance
    source: str = ""

    @property
    def dh(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256, as the reference pads it, so
        both packages share embedding-table shapes (and bridged weights).
        Tokens always stay < vocab_size."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self, **kw) -> "ArchConfig":
        """A tiny same-family variant for CPU smoke tests."""
        small = dict(
            n_layers=2,
            d_model=min(self.d_model, 128),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=min(self.d_ff, 256),
            vocab_size=min(self.vocab_size, 512),
            head_dim=32 if self.head_dim else 0,
            n_experts=min(self.n_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=16,
            attn_chunk=64,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_dec_layers=min(self.n_dec_layers, 2),
            enc_seq_len=min(self.enc_seq_len, 16) if self.enc_seq_len else 0,
            n_stub_embeds=min(self.n_stub_embeds, 8) if self.n_stub_embeds else 0,
            rwkv_lora_dim=8,
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
            train_microbatches=1,
            name=self.name + "-smoke",
        )
        # keep GQA ratio valid
        if small["n_heads"] % max(small["n_kv_heads"], 1):
            small["n_kv_heads"] = small["n_heads"]
        small.update(kw)
        return self.replace(**small)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape (training / prefill / decode)."""

    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


class ShapesOnly:
    """Stands in for the generator of a family's ``init`` asked for
    ``device="meta"``: every leaf comes out with its shape and dtype, no
    storage, and nothing is drawn (``BaseModel.param_shapes``)."""
    device = torch.device("meta")


def init_device(generator, device):
    """(device, generator) for a family's ``init``. ``device="meta"``
    builds shapes only and ignores ``generator``; otherwise the params go
    to ``cuda`` unless ``device="cpu"``, drawn from ``generator``, a
    ``torch.Generator`` on that device or an int seed for one."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta"), ShapesOnly()
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params "
                         f"asked for on {dev}")
    return dev, generator


def _randn(gen, shape: Sequence[int]) -> torch.Tensor:
    return torch.randn(tuple(shape), device=gen.device, generator=(
        None if isinstance(gen, ShapesOnly) else gen))


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype,
               in_axis: int = -2) -> torch.Tensor:
    """LeCun-normal style init on the fan-in axis (drawn in f32, then
    cast, as the reference does)."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    std = 1.0 / np.sqrt(fan_in)
    return (_randn(gen, shape) * std).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int], dtype
               ) -> torch.Tensor:
    return (_randn(gen, shape) * 0.02).to(dtype)


def stack_views(stack: Dict) -> Iterator[Dict]:
    """Per-layer views of an L-stacked layer tree with an ``ln1`` leaf
    (nested dicts, as ``mlp``, ``moe`` or ``attn``, keep their nesting),
    one at a time; under FSDP specs each layer's weights are gathered
    over the batch axes as its turn comes (``unshard_batch_axes``)."""
    def unbind(node):
        return {k: unbind(v) if isinstance(v, dict) else v.unbind(0)
                for k, v in node.items()}

    def pick(node, i):
        return {k: pick(v, i) if isinstance(v, dict)
                else unshard_batch_axes(v[i]) for k, v in node.items()}

    per = unbind(stack)
    return (pick(per, i) for i in range(len(per["ln1"])))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """f32 inside, f32 scale, cast back to the input dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def groupnorm_heads(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
                    ) -> torch.Tensor:
    """GroupNorm over the last dim of x (..., H, P): each head on its own.
    The variance is the population variance (``correction=0``), as the
    reference's ``jnp.var``; f32 inside, cast back to the input dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(dh: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, dh), positions: broadcastable to (..., S).

    Split-halves rotation (not interleaved), computed in f32."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)  # (dh/2,)
    angles = positions[..., None].float() * freqs   # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]            # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def embed_lookup(table, tokens) -> torch.Tensor:
    """``table[tokens]`` (tokens (...) int, table (V, D)). A DTensor table
    split over the vocab (``embed``'s spec, over ``model``) is read
    rank-locally: each rank looks up the tokens its rows hold, 0 for the
    others, and the pieces are summed over the vocab's ranks (one
    all-reduce; its gradient needs none): the masked local gather the
    reference's sharded lookup lowers to. DTensor's own plan moves the
    whole table between shard dims (an all-to-all, or on the CPU an
    all-gather, of every row)."""
    if not isinstance(table, DTensor) or not shard_dims(table, 0):
        return table[tokens.long()]
    mesh = table.device_mesh
    vdims = shard_dims(table, 0)
    table = table.redistribute(mesh, tuple(
        Shard(0) if i in vdims else Replicate() for i in range(mesh.ndim)))
    tspec = (BATCH,) + (None,) * (tokens.ndim - 1)
    n = table.shape[0] // int(np.prod([mesh.size(i) for i in vdims]))
    lo = shard_index(mesh, vdims) * n
    groups = [mesh.get_group(i) for i in vdims]

    def local(w, t):
        t = t.long() - lo
        inside = ((t >= 0) & (t < n))[..., None]
        return _SumForward.apply(w[t.clamp(0, n - 1)] * inside.to(w.dtype),
                                 groups)

    return local_apply(local, (None, tspec), table,
                       as_dtensor(tokens, mesh), out_specs=(tspec + (None,),))


class _SumForward(torch.autograd.Function):
    """All-reduce (sum) over each of ``groups`` forward, the identity
    backward: Megatron's ``g``, for a value every rank of the groups then
    uses whole (its gradient is already every rank's)."""

    @staticmethod
    def forward(ctx, x, groups):
        for g in groups:
            x = all_reduce(x, "sum", g)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, mask=None
                 ) -> torch.Tensor:
    """Mean cross-entropy; logits (..., V) any dtype (the padded vocab: the
    logsumexp runs over every column, as the reference's does), reduction
    in f32. ``mask`` (labels' shape) weights each position. DTensor logits
    stay split over the vocab (``_vocab_parallel_nll``), as the
    reference's equality-mask contraction keeps them."""
    if isinstance(logits, DTensor):
        nll = _vocab_parallel_nll(logits, labels)
    else:
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.long()[..., None])[..., 0]
        nll = lse - gold
    if mask is not None:
        mask = mask.float()
        out = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    else:
        out = nll.mean()
    # DTensor's backward of a Partial(avg) mean added to a replicated
    # term (the balance loss) views a strided gradient: reduce it here
    return replicate_dim(out)


def _vocab_parallel_nll(logits, labels):
    """Each position's ``logsumexp - gold logit`` of DTensor logits
    (rows over ``pod`` x ``data``, the vocab over ``model``), computed
    rank-locally: the local max all-reduced with max over ``model``, then
    the sum of exps and the gold logit (the one shard holding the label
    gives it, the others 0) all-reduced with sum: partial sums and one
    reduction, the reference's pattern. Neither the logits nor their
    gradient is gathered; the result is split by rows."""
    mesh = logits.device_mesh
    lspec = (BATCH,) + (None,) * (logits.ndim - 2) + ("model",)
    yspec = (BATCH,) + (None,) * (labels.ndim - 1)
    pl = placements(_clean_spec(mesh, lspec, logits.shape), mesh)
    vdims = [i for i, p in enumerate(pl)
             if isinstance(p, Shard) and p.dim == logits.ndim - 1]
    group = mesh.get_group(vdims[0]) if vdims else None
    lo = shard_index(mesh, vdims) * (logits.shape[-1] // int(np.prod(
        [mesh.size(i) for i in vdims])))
    return local_apply(lambda x, y: _VocabNLL.apply(x, y, lo, group),
                       (lspec, yspec), logits, as_dtensor(labels, mesh),
                       out_specs=(yspec,))


class _VocabNLL(torch.autograd.Function):
    """One rank's vocab shard x (..., Vl) of logits, labels (...) over the
    whole vocab, the shard's first column ``lo`` and the group of ranks
    that split the vocab (None: x is the whole vocab) -> nll (...) f32,
    equal on every rank of the group. Its gradient needs no collective:
    softmax - onehot on each shard, from the saved global logsumexp."""

    @staticmethod
    def forward(ctx, x, labels, lo, group):
        x32 = x.float()
        local = labels.long() - lo
        inside = (local >= 0) & (local < x.shape[-1])
        idx = local.clamp(0, x.shape[-1] - 1)[..., None]
        m = x32.amax(dim=-1)
        if group is not None:
            m = all_reduce(m, "max", group)
        sums = torch.stack([
            torch.exp(x32 - m[..., None]).sum(dim=-1),
            torch.where(inside, x32.gather(-1, idx)[..., 0],
                        torch.zeros_like(m))])
        if group is not None:
            sums = all_reduce(sums, "sum", group)
        lse = m + torch.log(sums[0])
        ctx.save_for_backward(x, lse, idx, inside)
        return lse - sums[1]

    @staticmethod
    def backward(ctx, g):
        x, lse, idx, inside = ctx.saved_tensors
        p = torch.exp(x.float() - lse[..., None])
        p = p.scatter_add(-1, idx, -inside.float()[..., None])
        return (p * g[..., None]).to(x.dtype), None, None, None


def tree_size(tree) -> int:
    """Elements over every leaf of ``tree`` (tensors or meta tensors)."""
    from ..tree import leaves
    return sum(int(np.prod(tuple(x.shape))) for x in leaves(tree))
