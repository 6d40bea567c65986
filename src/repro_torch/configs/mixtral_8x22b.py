"""Mixtral-8x22B — 8-expert top-2 MoE with sliding-window attention.

[arXiv:2401.04088] 56L, d_model=6144, 48H (GQA kv=8), d_ff=16384,
vocab=32768, 8 experts top-2, SWA window 4096. SWA makes long_500k decode
sub-quadratic (ring KV cache of window size).
"""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    n_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    rope_theta=1e6,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    train_microbatches=8,
    source="arXiv:2401.04088 (Mixtral of Experts)",
)
