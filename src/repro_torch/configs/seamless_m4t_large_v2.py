"""seamless-m4t-large-v2 [audio]: enc-dec, 24L encoder + 24L decoder,
d_model=1024 16H (kv=16) d_ff=8192 vocab=256206. [arXiv:2308.11596; hf]

The speech frontend (w2v-BERT conformer feature extractor) is a STUB per
the assignment: ``input_specs`` provides precomputed frame embeddings
``(batch, n_frames, d_frontend)``; a learned projection maps them into the
backbone. Decoder layers are self+cross ("attn_cross+mlp"). Vocab is
padded 256206 → 256256 for the 16-way model axis.
"""
from .common import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,                 # decoder
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab=256206,
    pattern=("attn_cross+mlp",),
    enc_pattern=("attn+mlp",),
    d_frontend=1024,
    rope_theta=1e4,
)
