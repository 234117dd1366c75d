"""Architecture + input-shape schema for the assigned (arch × shape) grid.

A field-for-field copy of ``repro/configs/common.py`` (the port imports
nothing of the JAX package).

Every assigned architecture is an :class:`ArchConfig`; every input shape a
:class:`ShapeSpec`. ``applicable(cfg, shape)`` encodes the skip rules from
the assignment (documented in DESIGN.md §Shape-skips):

* ``long_500k`` runs only for sub-quadratic archs (SSM / hybrid / archs with
  chunked-local attention);
* decode shapes are skipped for encoder-only archs (none assigned here —
  seamless-m4t is enc-*dec* and decodes with its decoder).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "applicable", "skip_reason"]

LayerKind = str  # "<mixer>+<ffn>": mixer ∈ attn|attn_local|mamba|attn_cross; ffn ∈ mlp|moe|none


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "encdec", "vlm", "ssm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # Repeating layer pattern; len(pattern) must divide n_layers. The whole
    # pattern group is the scan body (stacked n_layers/len(pattern) times).
    pattern: tuple[LayerKind, ...] = ("attn+mlp",)
    qk_norm: bool = False
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 / SSD)
    d_state: int = 0
    d_conv: int = 4
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 256
    # attention variants
    window: int = 0                  # attn_local chunk width (llama4 iRoPE)
    # encoder–decoder
    n_enc_layers: int = 0
    enc_pattern: tuple[LayerKind, ...] = ("attn+mlp",)
    # multimodal stubs (precomputed embeddings; frontend out of scope per spec)
    n_img_tokens: int = 0            # vlm: patch embeddings per image
    d_frontend: int = 0              # stub embedding dim (0 → d_model)
    # numerics / optimizer (per-arch so 398B fits the dry-run memory budget)
    param_dtype: str = "float32"
    act_dtype: str = "bfloat16"
    grad_accum_dtype: str = "float32"   # 398B-scale configs use bfloat16
    optimizer: str = "adamw"
    # ---- perf levers (§Perf hillclimb; defaults = paper-faithful baseline)
    kv_cache_dtype: str = "bfloat16"    # "int8" → quantized KV cache
    exact_causal_attn: bool = False     # block-skip causal flash attention
    remat_policy: str = "nothing"       # "nothing" | "dots"
    moe_impl: str = "auto"              # auto | owner | gather (§Perf A/B)
    sub_quadratic: bool = False      # eligible for long_500k
    note: str = ""

    # -- derived ---------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up so the `model` mesh axis (16) divides it."""
        return -(-self.vocab // 128) * 128

    @property
    def n_experts_padded(self) -> int:
        """Experts rounded up to the `model` axis size (padding experts are
        masked to -inf in the router; weight overhead is reported)."""
        if self.n_experts == 0:
            return 0
        return -(-self.n_experts // 16) * 16

    @property
    def n_repeats(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (
            self.name, self.n_layers, self.pattern)
        return self.n_layers // len(self.pattern)

    @property
    def d_inner(self) -> int:                  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count; ``active_only`` counts top_k routed +
        shared experts only (MODEL_FLOPS = 6·N_active·D for MoE)."""
        d, dh = self.d_model, self.head_dim
        total = 2 * self.vocab_padded * d if not self.tie_embeddings \
            else self.vocab_padded * d
        def attn():
            return d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        def mlp(ff):
            return 3 * d * ff
        def mamba():
            di, g, n, h = self.d_inner, self.ssm_groups, self.d_state, self.ssm_heads
            in_p = d * (2 * di + 2 * g * n + h)
            conv = self.d_conv * (di + 2 * g * n)
            return in_p + conv + 2 * h + di + di * d
        def moe():
            e = self.n_experts if not active_only else self.top_k
            routed = e * 3 * d * self.d_ff_expert
            shared = self.n_shared_experts * 3 * d * self.d_ff_expert
            router = d * self.n_experts
            return routed + shared + router
        kinds = list(self.pattern) * self.n_repeats
        if self.n_enc_layers:
            kinds += list(self.enc_pattern) * (
                self.n_enc_layers // len(self.enc_pattern))
        for kind in kinds:
            mixer, _, ffn = kind.partition("+")
            if mixer in ("attn", "attn_local"):
                total += attn()
            elif mixer == "attn_cross":
                total += 2 * attn()
            elif mixer == "mamba":
                total += mamba()
            if ffn == "mlp":
                total += mlp(self.d_ff)
            elif ffn == "moe":
                total += moe()
            total += 2 * d   # norms
        return total


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def skip_reason(cfg: ArchConfig, shape: ShapeSpec) -> str | None:
    """None if the cell runs; otherwise the documented skip reason."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("pure full-attention arch: 500k context requires "
                "sub-quadratic attention (assignment skip rule)")
    return None


def applicable(cfg: ArchConfig, shape: ShapeSpec) -> bool:
    return skip_reason(cfg, shape) is None
