"""mamba2-370m [ssm]: 48L d_model=1024, attn-free SSD (state-space
duality), ssm_state=128, vocab=50280. [arXiv:2405.21060]

No attention, no FFN (the Mamba2 block IS the layer). ``sub_quadratic``:
the decode state is O(1) in context length, so all long-context cells run.
Vocab padded 50280 → 50304 for the model axis. Embeddings tied (as in the
reference 370m checkpoint).
"""
from .common import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=16,          # unused (attention-free); kept for schema validity
    n_kv_heads=16,
    head_dim=64,
    d_ff=0,
    vocab=50280,
    pattern=("mamba",),
    d_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_groups=1,
    ssm_chunk=256,
    tie_embeddings=True,
    sub_quadratic=True,
)
