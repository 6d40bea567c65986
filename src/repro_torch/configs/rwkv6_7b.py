"""RWKV6 "Finch" 7B — attention-free SSM with data-dependent decay.

[arXiv:2404.05892] 32L, d_model=4096, d_ff=14336, vocab=65536; head size 64
(=> 64 wkv heads). No attention => long_500k runs on constant-size state.
"""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="rwkv",
    n_layers=32,
    d_model=4096,
    n_heads=64,          # wkv heads = d_model / 64
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    rwkv_lora_dim=64,
    ssm_chunk=32,        # wkv chunk length (chunked path)
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    train_microbatches=8,
    source="arXiv:2404.05892 (RWKV-6 Finch)",
)
