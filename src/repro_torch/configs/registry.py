"""Architecture registry + reduced smoke configs.

A copy of ``repro/configs/registry.py``: the same ten configs and the
same smoke reductions.

``get_config(name)`` returns the full published config; ``smoke_config``
shrinks every dimension (layers, width, experts, vocab, state) while
preserving the *family structure* (pattern, GQA ratio, MoE top-k, SSD
grouping) so the CPU smoke tests exercise the same code paths as the full
dry-run cells.
"""
from __future__ import annotations

import dataclasses

from .common import ArchConfig, SHAPES, ShapeSpec, applicable, skip_reason
from .qwen3_32b import CONFIG as _qwen3
from .phi3_mini_3_8b import CONFIG as _phi3
from .internlm2_20b import CONFIG as _internlm2
from .minitron_8b import CONFIG as _minitron
from .qwen2_moe_a2_7b import CONFIG as _qwen2moe
from .llama4_scout_17b_a16e import CONFIG as _llama4
from .jamba_1_5_large_398b import CONFIG as _jamba
from .seamless_m4t_large_v2 import CONFIG as _seamless
from .llama_3_2_vision_11b import CONFIG as _llamav
from .mamba2_370m import CONFIG as _mamba2

__all__ = ["ARCHS", "get_config", "smoke_config", "smoke_shape",
           "SHAPES", "applicable", "skip_reason"]

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in (
        _qwen3, _phi3, _internlm2, _minitron, _qwen2moe, _llama4, _jamba,
        _seamless, _llamav, _mamba2,
    )
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ArchConfig:
    """Reduced config of the same family (2 pattern repeats, tiny dims)."""
    cfg = get_config(name)
    kw: dict = dict(
        n_layers=2 * len(cfg.pattern),
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        rope_theta=1e4,
        window=16 if cfg.window else 0,
    )
    if cfg.n_kv_heads == cfg.n_heads:      # MHA archs stay MHA
        kw["n_kv_heads"] = kw["n_heads"]
    if cfg.n_experts:
        # capacity_factor ≥ n_experts_padded ⇒ drop-free: smoke tests can
        # assert exact train/serve consistency (production keeps 1.25 and
        # counts drops in metrics instead).
        kw.update(n_experts=6, top_k=min(cfg.top_k, 2),
                  n_shared_experts=min(cfg.n_shared_experts, 1),
                  d_ff_expert=32, capacity_factor=16.0)
    if "mamba" in "".join(cfg.pattern):
        kw.update(d_state=16, ssm_headdim=16, ssm_expand=2,
                  ssm_groups=min(cfg.ssm_groups, 2), ssm_chunk=8)
    if cfg.n_enc_layers:
        kw["n_enc_layers"] = 2 * len(cfg.enc_pattern)
    if cfg.family == "vlm":
        kw.update(n_img_tokens=8, d_frontend=24)
    if cfg.family == "encdec":
        kw.update(d_frontend=24)
    kw["param_dtype"] = "float32"
    return dataclasses.replace(cfg, **kw)


def smoke_shape(kind: str = "train") -> ShapeSpec:
    """Tiny shape for smoke tests (CPU, 1 device)."""
    if kind == "train":
        return ShapeSpec("smoke_train", 32, 2, "train")
    if kind == "prefill":
        return ShapeSpec("smoke_prefill", 32, 2, "prefill")
    return ShapeSpec("smoke_decode", 32, 2, "decode")
