"""Layer blocks: ``<mixer>+<ffn>`` kinds, with forward / prefill / decode.

Port of ``repro/models/blocks.py``. Mixers: ``attn`` (causal
self-attention), ``attn_local`` (chunked-local causal, llama4 iRoPE),
``xattn`` (cross-attention only, llama-3.2-vision style, with a learned
``tanh`` gate), ``attn_cross`` (self then cross: the enc-dec decoder) and
``mamba`` (SSD). FFNs: ``mlp`` (SwiGLU), ``moe`` and ``none``. The
self-attention K/V cache is bf16, or int8 with ``kv_cache_dtype="int8"``
(K per token and V per channel, with their float32 scales; prefill's
attention reads the unquantized K/V, decode's the quantized cache).

Every kind exposes the same three entry points so the model can loop over
a heterogeneous pattern uniformly:

  * ``block_apply``   — full-sequence training/encoding forward;
  * ``block_prefill`` — forward + build this block's decode cache;
  * ``block_decode``  — one-token step writing the new K/V (or the new
    SSM state) into the cache in place (the reference's
    ``dynamic_update_slice`` on a donated cache). The cross-attention
    K/V (``ck`` / ``cv``) are computed once from the memory at prefill
    and only read after.

The reference's ``shard(...)`` activation constraints sit at its sites
(``sharding.shard``: the identity on one card, the spec resolved under a
mesh context).
"""
from __future__ import annotations

import torch

from . import attention as attn_lib
from . import moe as moe_lib
from . import ssm as ssm_lib
from .layers import apply_rope, mlp_apply, mlp_specs, norm_spec, rms_norm
from .params import ParamSpec
from .sharding import shard

__all__ = [
    "parse_kind", "block_specs", "block_apply", "block_prefill",
    "block_decode", "block_cache_specs", "require_supported",
]


def parse_kind(kind: str) -> tuple[str, str]:
    mixer, _, ffn = kind.partition("+")
    return mixer, (ffn or "none")


_MIXERS = ("attn", "attn_local", "xattn", "attn_cross", "mamba")
_SELF = ("attn", "attn_local", "attn_cross")     # mixers with a K/V cache
_CROSS = ("xattn", "attn_cross")                 # mixers reading memory


def require_supported(cfg, kind: str) -> tuple[str, str]:
    """``parse_kind``, raising ``ValueError`` for an unknown mixer or
    FFN."""
    mixer, ffn = parse_kind(kind)
    if mixer not in _MIXERS:
        raise ValueError(f"unknown mixer {mixer!r}")
    if ffn not in ("mlp", "moe", "none"):
        raise ValueError(f"unknown ffn {ffn!r}")
    return mixer, ffn


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def _attn_specs(cfg, dtype, prefix="") -> dict:
    d, qd, kvd, dh = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.head_dim
    s = {
        prefix + "wq": ParamSpec((d, qd), ("embed", "heads"), dtype=dtype),
        prefix + "wk": ParamSpec((d, kvd), ("embed", "kv"), dtype=dtype),
        prefix + "wv": ParamSpec((d, kvd), ("embed", "kv"), dtype=dtype),
        prefix + "wo": ParamSpec((qd, d), ("heads", "embed"), dtype=dtype),
    }
    if cfg.qk_norm:
        s[prefix + "q_norm"] = ParamSpec((dh,), (None,), init="ones",
                                         dtype=dtype)
        s[prefix + "k_norm"] = ParamSpec((dh,), (None,), init="ones",
                                         dtype=dtype)
    return s


def block_specs(cfg, kind: str, dtype) -> dict:
    mixer, ffn = require_supported(cfg, kind)
    s: dict = {"ln1": norm_spec(cfg.d_model, dtype)}
    if mixer == "mamba":
        s.update(ssm_lib.mamba_specs(cfg, dtype))
    elif mixer == "xattn":
        s.update(_attn_specs(cfg, dtype, prefix="x_"))
        s["x_gate"] = ParamSpec((1,), (None,), init="zeros",
                                dtype=torch.float32)
    else:
        s.update(_attn_specs(cfg, dtype))
        if mixer == "attn_cross":
            s["ln_cross"] = norm_spec(cfg.d_model, dtype)
            s.update(_attn_specs(cfg, dtype, prefix="x_"))
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


def _kv_only(cfg, p, mem):
    """The cross-attention K/V of the memory ``mem[(b, lm, d)]``."""
    b, lm, _ = mem.shape
    dh = cfg.head_dim
    k = torch.matmul(mem, p["x_wk"].to(mem.dtype)).reshape(
        b, lm, cfg.n_kv_heads, dh)
    v = torch.matmul(mem, p["x_wv"].to(mem.dtype)).reshape(
        b, lm, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        k = rms_norm(k, p["x_k_norm"])
    return k, v


def _out_proj(cfg, p, out, h, name="wo"):
    b, l = h.shape[:2]
    return torch.matmul(out.reshape(b, l, cfg.q_dim), p[name].to(h.dtype))


def _cross_q(cfg, p, x):
    b, l, _ = x.shape
    q = torch.matmul(x, p["x_wq"].to(x.dtype)).reshape(b, l, cfg.n_heads,
                                                        cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["x_q_norm"])
    return q


def _gated(p, out):
    """``tanh(x_gate) · out`` where the block has a gate (``xattn``)."""
    if "x_gate" in p:
        out = torch.tanh(p["x_gate"]).to(out.dtype) * out
    return out


def _cross_attn(cfg, p, x, memory):
    """Cross-attention of ``x`` over the whole memory (``mode="full"``,
    every position 0, as the reference): ``(mix, k, v)``, ``k`` / ``v``
    the memory's K/V."""
    b, l, _ = x.shape
    q = _cross_q(cfg, p, x)
    k, v = _kv_only(cfg, p, memory)
    lm = memory.shape[1]
    out = attn_lib.flash_attention(
        q, k, v, mode="full",
        pos_q=torch.zeros((b, l), dtype=torch.int32, device=x.device),
        pos_k=torch.zeros((b, lm), dtype=torch.int32, device=x.device))
    return _gated(p, _out_proj(cfg, p, out, x, "x_wo")), k, v


def _decode_cross(cfg, p, x, cache):
    """One token's cross-attention over the cached memory K/V: every
    ``lm`` slot (``cur_pos = lm - 1``, ``mode="full"``)."""
    lm = cache["ck"].shape[1]
    out = attn_lib.decode_attention(
        _cross_q(cfg, p, x), cache["ck"].to(x.dtype),
        cache["cv"].to(x.dtype), cur_pos=lm - 1, mode="full")
    return _gated(p, _out_proj(cfg, p, out, x, "x_wo"))


def _self_attn(cfg, p, x, pos, mode):
    """Self-attention over the whole sequence: ``(mix, k, v)``."""
    q, k, v = _qkv(cfg, p, x)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    q = shard(q, "batch", "seq", "act_heads", None)
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
    """Full-sequence forward. Returns ``(h', metrics)``. ``memory``
    (``(b, lm, d)``) is what the ``xattn`` and ``attn_cross`` mixers
    attend to."""
    mixer, ffn = require_supported(cfg, kind)
    x = rms_norm(h, p["ln1"])
    if mixer == "mamba":
        mix = ssm_lib.mamba_apply(p, x, cfg)
    elif mixer == "xattn":
        mix, _, _ = _cross_attn(cfg, p, x, memory)
    else:
        mix, _, _ = _self_attn(cfg, p, x, pos,
                               "local" if mixer == "attn_local" else mode)
        if mixer == "attn_cross":
            h = h + mix
            mix, _, _ = _cross_attn(cfg, p, rms_norm(h, p["ln_cross"]),
                                    memory)
    h = shard(h + mix, "batch", "seq", "act_embed")
    return _with_ffn(cfg, p, h, ffn)


# ---------------------------------------------------------------------------
# Prefill / decode caches
# ---------------------------------------------------------------------------

def block_cache_specs(cfg, kind: str, batch: int, seq: int, mem_len: int,
                      dtype=torch.bfloat16) -> dict:
    """Cache (shape, logical axes, dtype) for one block: K/V of ``seq``
    slots for self-attention (bf16; or int8 with their float32 scales,
    ``k_scale`` per token, ``v_scale`` per channel), bf16 ``ck`` / ``cv``
    of ``mem_len`` slots for cross-attention, the float32 ``conv`` tail
    and ``ssd`` state for mamba."""
    mixer, _ = require_supported(cfg, kind)
    if mixer == "mamba":
        shapes = ssm_lib.mamba_cache_shape(cfg, batch)
        return {"conv": (shapes["conv"], ("batch", None, "act_mlp"),
                         torch.float32),
                "ssd": (shapes["ssd"], ("batch", "act_heads", None, None),
                        torch.float32)}
    out = {}
    if mixer in _SELF:
        kv = ("batch", "seq_shard", None, None)
        shp = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
        if cfg.kv_cache_dtype == "int8":
            out["k"], out["v"] = (shp, kv, torch.int8), (shp, kv, torch.int8)
            out["k_scale"] = ((batch, seq, cfg.n_kv_heads),
                              ("batch", "seq_shard", None), torch.float32)
            out["v_scale"] = ((batch, cfg.n_kv_heads, cfg.head_dim),
                              ("batch", None, None), torch.float32)
        else:
            out["k"], out["v"] = (shp, kv, dtype), (shp, kv, dtype)
    if mixer in _CROSS:
        shp = (batch, mem_len, cfg.n_kv_heads, cfg.head_dim)
        axes = ("batch", None, None, None)
        out["ck"], out["cv"] = (shp, axes, dtype), (shp, axes, dtype)
    return out


def _kv_cache(cfg, k, v) -> dict:
    """Prefill's self-attention cache of ``k`` / ``v`` ``(b, l, kh, dh)``:
    bf16, or int8 codes (K per token, V per channel) and their scales."""
    if cfg.kv_cache_dtype == "int8":
        kq, ks = attn_lib.quantize_per_token(k)
        vq, vs = attn_lib.quantize_per_channel(v)
        return {"k": shard(kq, "batch", "seq_shard", None, None),
                "v": shard(vq, "batch", "seq_shard", None, None),
                "k_scale": shard(ks, "batch", "seq_shard", None),
                "v_scale": vs}
    return {"k": shard(k.to(torch.bfloat16), "batch", "seq_shard", None,
                       None),
            "v": shard(v.to(torch.bfloat16), "batch", "seq_shard", None,
                       None)}


def block_prefill(cfg, kind: str, p, h, *, pos, memory=None):
    """Forward + build this block's decode cache. Returns (h', cache).

    K/V (and the memory's ``ck`` / ``cv``) are stored as bf16 whatever
    the activation dtype, or K/V as int8 codes with their scales; the
    mamba state as float32. The reference computes the memory's K/V
    twice, for the attention and for the cache; the port keeps them from
    the one computation."""
    mixer, ffn = require_supported(cfg, kind)
    x = rms_norm(h, p["ln1"])
    if mixer == "mamba":
        mix, cache = ssm_lib.mamba_prefill(p, x, cfg)
    elif mixer == "xattn":
        mix, ck, cv = _cross_attn(cfg, p, x, memory)
        cache = {"ck": ck.to(torch.bfloat16), "cv": cv.to(torch.bfloat16)}
    else:
        mix, k, v = _self_attn(cfg, p, x, pos,
                               "local" if mixer == "attn_local"
                               else "causal")
        cache = _kv_cache(cfg, k, v)
        if mixer == "attn_cross":
            h = h + mix
            mix, ck, cv = _cross_attn(cfg, p, rms_norm(h, p["ln_cross"]),
                                      memory)
            cache.update(ck=ck.to(torch.bfloat16), cv=cv.to(torch.bfloat16))
    h, _ = _with_ffn(cfg, p, h + mix, ffn)
    return h, cache


def block_decode(cfg, kind: str, p, h, cache, *, pos: int, memory=None):
    """One-token step. ``h[(b, 1, d)]``; ``pos`` = slot of the new token
    (cache slots ``< pos`` already filled). Writes the new K/V into
    ``cache["k"]``/``cache["v"]`` at ``pos`` (int8: K quantized per token
    into ``k_scale[pos]``, V clamped into prefill's ``v_scale``), or the
    new ``conv`` / ``ssd`` state over the old, in place; the
    cross-attention ``ck`` / ``cv`` are read; returns ``(h', cache)``."""
    mixer, ffn = require_supported(cfg, kind)
    pos = int(pos)
    x = rms_norm(h, p["ln1"])
    if mixer == "mamba":
        mix, state = ssm_lib.mamba_decode(p, x, cache, cfg)
        for name, t in state.items():
            cache[name].copy_(t)
    elif mixer == "xattn":
        mix = _decode_cross(cfg, p, x, cache)
    else:
        b = h.shape[0]
        q, k, v = _qkv(cfg, p, x)
        pos_b = torch.full((b, 1), pos, dtype=torch.int32, device=h.device)
        q = apply_rope(q, pos_b, cfg.rope_theta)
        k = apply_rope(k, pos_b, cfg.rope_theta)
        mode = "local" if mixer == "attn_local" else "causal"
        kc, vc = cache["k"], cache["v"]
        if cfg.kv_cache_dtype == "int8":
            kq, ks = attn_lib.quantize_per_token(k)
            # clamp the new V into the prefill-time per-channel scale
            vq = attn_lib.quantize_at(v.float(), cache["v_scale"][:, None])
            kc[:, pos:pos + 1] = kq
            vc[:, pos:pos + 1] = vq
            cache["k_scale"][:, pos:pos + 1] = ks
            out = attn_lib.decode_attention_int8(
                q, kc, cache["k_scale"], vc, cache["v_scale"], cur_pos=pos,
                mode=mode, window=cfg.window)
        else:
            kc[:, pos:pos + 1] = k.to(kc.dtype)
            vc[:, pos:pos + 1] = v.to(vc.dtype)
            out = attn_lib.decode_attention(
                q, kc.to(h.dtype), vc.to(h.dtype), cur_pos=pos, mode=mode,
                window=cfg.window)
        mix = _out_proj(cfg, p, out, h)
        if mixer == "attn_cross":
            h = h + mix
            mix = _decode_cross(cfg, p, rms_norm(h, p["ln_cross"]), cache)
    h, _ = _with_ffn(cfg, p, h + mix, ffn)
    return h, cache
