"""Llama-3.2-1B — small llama3 dense GQA.

[hf:meta-llama/Llama-3.2-1B] 16L, d_model=2048, 32H (GQA kv=8), d_ff=8192,
vocab=128256, tied embeddings.
"""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    tie_embeddings=True,
    rope_theta=5e5,
    remat=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    train_microbatches=2,
    source="hf:meta-llama/Llama-3.2-1B",
)
