"""Layer blocks: ``<mixer>+<ffn>`` kinds, with forward / prefill / decode.

Port of ``repro/models/blocks.py`` for the dense family: the ``attn``
mixer (causal self-attention) and the ``mlp`` (SwiGLU) and ``none`` FFNs.
The other kinds of the reference (``attn_local``, ``xattn``,
``attn_cross``, ``mamba``, ``moe``) and the int8 KV cache raise
``NotImplementedError``: they come with ROADMAP A15, slice 3.

Every kind exposes the same three entry points so the model can loop over
a heterogeneous pattern uniformly:

  * ``block_apply``   — full-sequence training/encoding forward;
  * ``block_prefill`` — forward + build this block's decode cache;
  * ``block_decode``  — one-token step writing the new K/V into the cache
    in place (the reference's ``dynamic_update_slice`` on a donated
    cache).

The reference's ``shard(...)`` activation constraints are the identity
without a mesh; they return with ``mesh.py`` (slice 3).
"""
from __future__ import annotations

import torch

from . import attention as attn_lib
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
    does not run yet (every mixer but ``attn``, the ``moe`` FFN, the int8
    KV cache)."""
    mixer, ffn = parse_kind(kind)
    if mixer in ("attn_local", "xattn", "attn_cross", "mamba"):
        raise NotImplementedError(
            f"the {mixer!r} mixer ({cfg.name}) is not ported yet: "
            f"{_LATER}")
    if mixer != "attn":
        raise ValueError(f"unknown mixer {mixer!r}")
    if ffn == "moe":
        raise NotImplementedError(
            f"the 'moe' FFN ({cfg.name}) is not ported yet: {_LATER}")
    if ffn not in ("mlp", "none"):
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
    _, ffn = require_supported(cfg, kind)
    s: dict = {"ln1": norm_spec(cfg.d_model, dtype)}
    s.update(_attn_specs(cfg, dtype))
    if ffn == "mlp":
        s["ln2"] = norm_spec(cfg.d_model, dtype)
        s["mlp"] = mlp_specs(cfg.d_model, cfg.d_ff, dtype)
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


def _ffn(cfg, p, h, ffn: str):
    if ffn == "none":
        return h * 0.0, {}               # residual no-op (no FFN)
    return mlp_apply(p["mlp"], rms_norm(h, p["ln2"])), {}


# ---------------------------------------------------------------------------
# Forward (train / encode)
# ---------------------------------------------------------------------------

def block_apply(cfg, kind: str, p, h, *, pos, memory=None, mode="causal"):
    """Full-sequence forward. Returns ``(h', metrics)``."""
    _, ffn = require_supported(cfg, kind)
    x = rms_norm(h, p["ln1"])
    q, k, v = _qkv(cfg, p, x)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    out = attn_lib.flash_attention(
        q, k, v, pos_q=pos, pos_k=pos, mode=mode, window=cfg.window,
        exact_causal=cfg.exact_causal_attn)
    h = h + _out_proj(cfg, p, out, h)
    y, metrics = _ffn(cfg, p, h, ffn)
    if ffn != "none":
        h = h + y
    return h, metrics


# ---------------------------------------------------------------------------
# Prefill / decode caches
# ---------------------------------------------------------------------------

def block_cache_specs(cfg, kind: str, batch: int, seq: int, mem_len: int,
                      dtype=torch.bfloat16) -> dict:
    """Cache (shape, logical axes, dtype) for one block."""
    require_supported(cfg, kind)
    kv = ("batch", "seq_shard", None, None)
    shp = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": (shp, kv, dtype), "v": (shp, kv, dtype)}


def block_prefill(cfg, kind: str, p, h, *, pos, memory=None):
    """Forward + build this block's decode cache. Returns (h', cache).

    K/V are stored as bf16 whatever the activation dtype."""
    _, ffn = require_supported(cfg, kind)
    x = rms_norm(h, p["ln1"])
    q, k, v = _qkv(cfg, p, x)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    out = attn_lib.flash_attention(q, k, v, pos_q=pos, pos_k=pos,
                                   mode="causal", window=cfg.window,
                                   exact_causal=cfg.exact_causal_attn)
    cache = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
    h = h + _out_proj(cfg, p, out, h)
    y, _ = _ffn(cfg, p, h, ffn)
    if ffn != "none":
        h = h + y
    return h, cache


def block_decode(cfg, kind: str, p, h, cache, *, pos: int, memory=None):
    """One-token step. ``h[(b, 1, d)]``; ``pos`` = slot of the new token
    (cache slots ``< pos`` already filled). Writes the new K/V into
    ``cache["k"]``/``cache["v"]`` at ``pos`` in place; returns
    ``(h', cache)``."""
    _, ffn = require_supported(cfg, kind)
    pos = int(pos)
    x = rms_norm(h, p["ln1"])
    b = h.shape[0]
    q, k, v = _qkv(cfg, p, x)
    pos_b = torch.full((b, 1), pos, dtype=torch.int32, device=h.device)
    q = apply_rope(q, pos_b, cfg.rope_theta)
    k = apply_rope(k, pos_b, cfg.rope_theta)
    kc, vc = cache["k"], cache["v"]
    kc[:, pos:pos + 1] = k.to(kc.dtype)
    vc[:, pos:pos + 1] = v.to(vc.dtype)
    out = attn_lib.decode_attention(q, kc.to(h.dtype), vc.to(h.dtype),
                                    cur_pos=pos, mode="causal",
                                    window=cfg.window)
    h = h + _out_proj(cfg, p, out, h)
    y, _ = _ffn(cfg, p, h, ffn)
    if ffn != "none":
        h = h + y
    return h, cache
