"""InternVL2-26B language backbone (InternLM2-20B) + stub ViT projector.

[arXiv:2404.16821] 48L, d_model=6144, 48H (GQA kv=8), d_ff=16384,
vocab=92553. Vision encoder (InternViT-6B) is a stub: input_specs supplies
(B, 256, 6144) projected patch embeddings prepended to the text sequence.
"""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    n_stub_embeds=256,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    train_microbatches=8,
    source="arXiv:2404.16821 (InternVL2)",
)
