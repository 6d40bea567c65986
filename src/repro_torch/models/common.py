"""Shared model-zoo building blocks: configs, norms, RoPE, initializers.

Params are nested dicts of tensors with the reference package's layouts:
layer stacks carry a leading ``L`` axis and weights are ``(in, out)``,
applied as ``x @ w``. Every initializer draws from an explicit
``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..sharding.context import replicate_dim

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


def stack_views(stack: Dict) -> List[Dict]:
    """Per-layer views of an L-stacked layer tree with an ``ln1`` leaf
    (nested dicts, as ``mlp``, ``moe`` or ``attn``, keep their nesting)."""
    def unbind(node):
        return {k: unbind(v) if isinstance(v, dict) else v.unbind(0)
                for k, v in node.items()}

    def pick(node, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in node.items()}

    per = unbind(stack)
    return [pick(per, i) for i in range(len(per["ln1"]))]


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


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, mask=None
                 ) -> torch.Tensor:
    """Mean cross-entropy; logits (..., V) any dtype (the padded vocab: the
    logsumexp runs over every column, as the reference's does), reduction
    in f32. ``mask`` (labels' shape) weights each position."""
    # DTensor's vocab-parallel gather (_MaskPartial) fails on logits
    # sharded over the vocab: gather the gold logit from replicated ones
    logits = replicate_dim(logits.float(), logits.ndim - 1)
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
