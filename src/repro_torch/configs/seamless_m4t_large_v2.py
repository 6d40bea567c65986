"""SeamlessM4T-large-v2 transformer backbone (speech enc + text dec).

[arXiv:2308.11596] 24L enc + 24L dec, d_model=1024, 16H (kv=16, MHA),
d_ff=8192, vocab=256206. Modality frontend (mel + conv) is a stub:
input_specs supplies (B, enc_seq_len, 1024) frame embeddings.
"""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=48,           # 24 enc + 24 dec (accounting)
    n_enc_layers=24,
    n_dec_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    enc_seq_len=4096,      # stub audio frames
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    train_microbatches=2,
    source="arXiv:2308.11596 (SeamlessM4T v2)",
)
