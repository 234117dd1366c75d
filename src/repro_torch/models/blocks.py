"""Layer blocks: ``<mixer>+<ffn>`` kinds, with forward / prefill / decode.

Port of ``repro/models/blocks.py`` for the dense, MoE, SSM and hybrid
families: the ``attn`` (causal self-attention), ``attn_local``
(chunked-local causal, llama4 iRoPE) and ``mamba`` (SSD) mixers, and the
``mlp`` (SwiGLU), ``moe`` and ``none`` FFNs. The cross-attention mixers of
the reference (``xattn``, ``attn_cross``) and the int8 KV cache raise
``NotImplementedError``: they come with a later part of ROADMAP A15 (3).

Every kind exposes the same three entry points so the model can loop over
a heterogeneous pattern uniformly:

  * ``block_apply``   — full-sequence training/encoding forward;
  * ``block_prefill`` — forward + build this block's decode cache;
  * ``block_decode``  — one-token step writing the new K/V (or the new
    SSM state) into the cache in place (the reference's
    ``dynamic_update_slice`` on a donated cache).

The reference's ``shard(...)`` activation constraints are the identity
without a mesh; they return with the mesh (ROADMAP A15 (3)).
"""
from __future__ import annotations

import torch

from . import attention as attn_lib
from . import moe as moe_lib
from . import ssm as ssm_lib
from .layers import apply_rope, mlp_apply, mlp_specs, norm_spec, rms_norm
from .params import ParamSpec

__all__ = [
    "parse_kind", "block_specs", "block_apply", "block_prefill",
    "block_decode", "block_cache_specs", "require_supported",
]

_LATER = "ROADMAP A15 (3)"


def parse_kind(kind: str) -> tuple[str, str]:
    mixer, _, ffn = kind.partition("+")
    return mixer, (ffn or "none")


def require_supported(cfg, kind: str) -> tuple[str, str]:
    """``parse_kind``, raising ``NotImplementedError`` for what the port
    does not run yet (the ``xattn`` and ``attn_cross`` mixers, the int8
    KV cache)."""
    mixer, ffn = parse_kind(kind)
    if mixer in ("xattn", "attn_cross"):
        raise NotImplementedError(
            f"the {mixer!r} mixer ({cfg.name}) is not ported yet: "
            f"{_LATER}")
    if mixer not in ("attn", "attn_local", "mamba"):
        raise ValueError(f"unknown mixer {mixer!r}")
    if ffn not in ("mlp", "moe", "none"):
        raise ValueError(f"unknown ffn {ffn!r}")
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(
            "the int8 KV cache (kv_cache_dtype='int8') is not ported yet: "
            f"{_LATER}")
    return mixer, ffn


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def _attn_specs(cfg, dtype) -> dict:
    d, qd, kvd, dh = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.head_dim
    s = {
        "wq": ParamSpec((d, qd), ("embed", "heads"), dtype=dtype),
        "wk": ParamSpec((d, kvd), ("embed", "kv"), dtype=dtype),
        "wv": ParamSpec((d, kvd), ("embed", "kv"), dtype=dtype),
        "wo": ParamSpec((qd, d), ("heads", "embed"), dtype=dtype),
    }
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((dh,), (None,), init="ones", dtype=dtype)
        s["k_norm"] = ParamSpec((dh,), (None,), init="ones", dtype=dtype)
    return s


def block_specs(cfg, kind: str, dtype) -> dict:
    mixer, ffn = require_supported(cfg, kind)
    s: dict = {"ln1": norm_spec(cfg.d_model, dtype)}
    if mixer == "mamba":
        s.update(ssm_lib.mamba_specs(cfg, dtype))
    else:
        s.update(_attn_specs(cfg, dtype))
    if ffn == "mlp":
        s["ln2"] = norm_spec(cfg.d_model, dtype)
        s["mlp"] = mlp_specs(cfg.d_model, cfg.d_ff, dtype)
    elif ffn == "moe":
        s["ln2"] = norm_spec(cfg.d_model, dtype)
        s["moe"] = moe_lib.moe_specs(
            cfg.d_model, cfg.d_ff_expert or cfg.d_ff, cfg.n_experts_padded,
            cfg.n_shared_experts, cfg.n_experts, dtype)
    return s


# ---------------------------------------------------------------------------
# Attention helpers
# ---------------------------------------------------------------------------

def _qkv(cfg, p, h):
    b, l, _ = h.shape
    dh = cfg.head_dim
    q = torch.matmul(h, p["wq"].to(h.dtype)).reshape(b, l, cfg.n_heads, dh)
    k = torch.matmul(h, p["wk"].to(h.dtype)).reshape(b, l, cfg.n_kv_heads,
                                                      dh)
    v = torch.matmul(h, p["wv"].to(h.dtype)).reshape(b, l, cfg.n_kv_heads,
                                                      dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def _out_proj(cfg, p, out, h):
    b, l = h.shape[:2]
    return torch.matmul(out.reshape(b, l, cfg.q_dim), p["wo"].to(h.dtype))


def _self_attn(cfg, p, x, pos, mode):
    """Self-attention over the whole sequence: ``(mix, k, v)``."""
    q, k, v = _qkv(cfg, p, x)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    out = attn_lib.flash_attention(
        q, k, v, pos_q=pos, pos_k=pos, mode=mode, window=cfg.window,
        exact_causal=cfg.exact_causal_attn)
    return _out_proj(cfg, p, out, x), k, v


def _with_ffn(cfg, p, h, ffn: str):
    """``h`` plus the FFN of ``h`` → ``(h', metrics)``; ``"none"`` (mamba2
    has no FFN) leaves ``h`` as it is."""
    if ffn == "none":
        return h, {}
    y = rms_norm(h, p["ln2"])
    if ffn == "mlp":
        return h + mlp_apply(p["mlp"], y), {}
    y, metrics = moe_lib.moe_apply(
        p["moe"], y, n_real=cfg.n_experts, top_k=cfg.top_k,
        capacity_factor=cfg.capacity_factor, impl=cfg.moe_impl)
    return h + y, metrics


# ---------------------------------------------------------------------------
# Forward (train / encode)
# ---------------------------------------------------------------------------

def block_apply(cfg, kind: str, p, h, *, pos, memory=None, mode="causal"):
    """Full-sequence forward. Returns ``(h', metrics)``."""
    mixer, ffn = require_supported(cfg, kind)
    x = rms_norm(h, p["ln1"])
    if mixer == "mamba":
        mix = ssm_lib.mamba_apply(p, x, cfg)
    else:
        mix, _, _ = _self_attn(cfg, p, x, pos,
                               "local" if mixer == "attn_local" else mode)
    return _with_ffn(cfg, p, h + mix, ffn)


# ---------------------------------------------------------------------------
# Prefill / decode caches
# ---------------------------------------------------------------------------

def block_cache_specs(cfg, kind: str, batch: int, seq: int, mem_len: int,
                      dtype=torch.bfloat16) -> dict:
    """Cache (shape, logical axes, dtype) for one block: bf16 K/V of
    ``seq`` slots for attention, the float32 ``conv`` tail and ``ssd``
    state for mamba."""
    mixer, _ = require_supported(cfg, kind)
    if mixer == "mamba":
        shapes = ssm_lib.mamba_cache_shape(cfg, batch)
        return {"conv": (shapes["conv"], ("batch", None, "act_mlp"),
                         torch.float32),
                "ssd": (shapes["ssd"], ("batch", "act_heads", None, None),
                        torch.float32)}
    kv = ("batch", "seq_shard", None, None)
    shp = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": (shp, kv, dtype), "v": (shp, kv, dtype)}


def block_prefill(cfg, kind: str, p, h, *, pos, memory=None):
    """Forward + build this block's decode cache. Returns (h', cache).

    K/V are stored as bf16 whatever the activation dtype; the mamba state
    as float32."""
    mixer, ffn = require_supported(cfg, kind)
    x = rms_norm(h, p["ln1"])
    if mixer == "mamba":
        mix, cache = ssm_lib.mamba_prefill(p, x, cfg)
    else:
        mix, k, v = _self_attn(cfg, p, x, pos,
                               "local" if mixer == "attn_local"
                               else "causal")
        cache = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
    h, _ = _with_ffn(cfg, p, h + mix, ffn)
    return h, cache


def block_decode(cfg, kind: str, p, h, cache, *, pos: int, memory=None):
    """One-token step. ``h[(b, 1, d)]``; ``pos`` = slot of the new token
    (cache slots ``< pos`` already filled). Writes the new K/V into
    ``cache["k"]``/``cache["v"]`` at ``pos``, or the new ``conv`` /
    ``ssd`` state over the old, in place; returns ``(h', cache)``."""
    mixer, ffn = require_supported(cfg, kind)
    pos = int(pos)
    x = rms_norm(h, p["ln1"])
    if mixer == "mamba":
        mix, state = ssm_lib.mamba_decode(p, x, cache, cfg)
        for name, t in state.items():
            cache[name].copy_(t)
    else:
        b = h.shape[0]
        q, k, v = _qkv(cfg, p, x)
        pos_b = torch.full((b, 1), pos, dtype=torch.int32, device=h.device)
        q = apply_rope(q, pos_b, cfg.rope_theta)
        k = apply_rope(k, pos_b, cfg.rope_theta)
        kc, vc = cache["k"], cache["v"]
        kc[:, pos:pos + 1] = k.to(kc.dtype)
        vc[:, pos:pos + 1] = v.to(vc.dtype)
        out = attn_lib.decode_attention(
            q, kc.to(h.dtype), vc.to(h.dtype), cur_pos=pos,
            mode="local" if mixer == "attn_local" else "causal",
            window=cfg.window)
        mix = _out_proj(cfg, p, out, h)
    h, _ = _with_ffn(cfg, p, h + mix, ffn)
    return h, cache
