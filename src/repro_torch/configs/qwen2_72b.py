"""Qwen2-72B — dense GQA with QKV bias.

[arXiv:2407.10671] 80L, d_model=8192, 64H (GQA kv=8), d_ff=29568,
vocab=152064, qkv_bias=True.
"""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    train_microbatches=16,
    source="arXiv:2407.10671 (Qwen2)",
)
