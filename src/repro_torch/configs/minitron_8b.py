"""minitron-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000 — pruned nemotron. [arXiv:2407.14679; hf]

Deviation note (DESIGN.md §Arch-applicability): nemotron uses squared-ReLU
MLPs; we use the framework-uniform SwiGLU (same parameter count with the
gate matrix folded in).
"""
from .common import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=256000,
    pattern=("attn+mlp",),
    rope_theta=5e5,
)
