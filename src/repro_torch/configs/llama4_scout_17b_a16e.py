"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16e top-1 + 1 shared expert, iRoPE chunked-local
attention (3 local : 1 global). [hf:meta-llama/Llama-4-Scout-17B-16E]

``sub_quadratic=True``: 3/4 of the layers use 8192-chunk local attention,
so the arch is run for ``long_500k`` as a bonus cell (global layers decode
O(S); local layers O(window)). Early-fusion multimodality is out of scope
for the LM backbone cells (frontend stub rule).
"""
from .common import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    pattern=("attn_local+moe", "attn_local+moe", "attn_local+moe",
             "attn+moe"),
    window=8192,
    n_experts=16,
    top_k=1,
    n_shared_experts=1,
    d_ff_expert=8192,
    rope_theta=5e5,
    sub_quadratic=True,
    note="iRoPE 3:1 local:global; long_500k runs as a bonus cell",
)
