"""SmolLM-135M — llama-arch small dense LM.

[hf:HuggingFaceTB/SmolLM-135M] 30L, d_model=576, 9H (GQA kv=3), d_ff=1536,
vocab=49152, tied embeddings.
"""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
    remat=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    train_microbatches=4,
    source="hf:HuggingFaceTB/SmolLM-135M",
)
