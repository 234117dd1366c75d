"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576, MoE 16e top-2, Mamba:attn 7:1 interleave. [arXiv:2403.19887]

Pattern of 8 (scanned ×9): attention at position 4, MoE on odd positions
(4 MoE / 8 layers) — reproduces the published 398B total / ~94B active
split (our analytic count: 399.5B total / 94.5B active).

Numerics: ``param_dtype=bfloat16`` + Adafactor — required to fit the
16 GB/chip v5e budget at 256-way sharding (fp32 AdamW would need
18.6 GB/chip for optimizer state alone; see EXPERIMENTS.md §Dry-run).
"""
from .common import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    pattern=("mamba+mlp", "mamba+moe", "mamba+mlp", "mamba+moe",
             "attn+mlp", "mamba+moe", "mamba+mlp", "mamba+moe"),
    n_experts=16,
    top_k=2,
    d_ff_expert=24576,
    d_state=128,
    ssm_headdim=128,
    ssm_groups=8,
    ssm_chunk=256,
    rope_theta=1e6,
    param_dtype="bfloat16",
    grad_accum_dtype="bfloat16",   # fp32 grads alone are 12.4 GB/chip at
    optimizer="adafactor",         # 256-way sharding — documented trade-off
    sub_quadratic=True,
)
