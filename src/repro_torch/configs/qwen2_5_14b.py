"""Qwen2.5-14B — dense GQA with QKV bias.

[hf:Qwen/Qwen2.5-14B family] 48L, d_model=5120, 40H (GQA kv=8), d_ff=13824,
vocab=152064, qkv_bias=True.
"""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    train_microbatches=8,
    source="hf:Qwen/Qwen2.5-0.5B (family card)",
)
