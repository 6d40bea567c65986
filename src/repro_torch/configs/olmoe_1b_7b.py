"""OLMoE-1B-7B — 64-expert top-8 MoE (1B active / 7B total).

[arXiv:2409.02060] 16L, d_model=2048, 16H (kv=16, MHA), d_ff=1024 (per
expert), vocab=50304, 64 experts top-8. 64 experts shard cleanly over the
16-way model axis => expert parallelism.
"""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    n_experts=64,
    experts_per_token=8,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    train_microbatches=8,
    source="arXiv:2409.02060 (OLMoE)",
)
