"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — gated cross-attn image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision]

Vision frontend is a STUB: ``input_specs`` provides precomputed patch
embeddings ``(batch, 1601, 7680)`` (the ViT-H 1601-token output); a learned
projection maps them to d_model. Cross-attn layers are zero-init gated
(tanh gate), as in the reference implementation.
"""
from .common import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=128256,
    pattern=("attn+mlp", "attn+mlp", "attn+mlp", "xattn+mlp", "attn+mlp"),
    n_img_tokens=1601,
    d_frontend=7680,
    rope_theta=5e5,
)
