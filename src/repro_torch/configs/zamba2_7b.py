"""Zamba2-7B — Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242] 81L, d_model=3584, 32H (kv=32, MHA in the shared block),
d_ff=14336, vocab=32000, ssm_state=64. Shared attn applied every 6th layer.
"""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    attn_every=6,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    train_microbatches=8,
    source="arXiv:2411.15242 (Zamba2)",
)
