"""Memory-efficient attention in plain PyTorch: the online-softmax recurrence.

Port of ``repro/models/attention.py``. ``flash_attention`` never
materializes the (lq × lkv) score matrix: a loop over query chunks and an
inner loop over key/value chunks carry the running (max, denom,
accumulator) triple, as the reference's two ``lax.scan``s do, with its
chunk padding (padded queries at position 0, padded keys at -1, always
masked) and its ``-1e30`` masking. Probabilities are zeroed under the mask,
so a fully masked row stays finite.

GQA is handled by folding heads into (kv_heads, group); modes:
  * ``causal``  — autoregressive self-attention;
  * ``full``    — bidirectional (encoder) / cross-attention;
  * ``local``   — chunked-local causal attention (llama4 iRoPE style):
                  q attends only within its ``window``-sized block.

``decode_attention`` is the single-token path over a KV cache, masked by
cache position.

Scores and the PV sum are float32 whatever the activation dtype, as the
reference's ``preferred_element_type=jnp.float32``: the operands are
widened to float32 before each product (a bf16 × bf16 product is exact in
float32, so this is the same arithmetic), and the probabilities are
rounded to V's dtype before the PV product, as in the reference.

The int8 KV cache (``kv_cache_dtype="int8"``): ``quantize_per_token``
(K, a scale per (token, head)), ``quantize_per_channel`` (V, a scale per
(head, channel) shared over tokens, so that it factors out of the PV
sum) and ``decode_attention_int8``, with the reference's arithmetic in
its order: the float32 max-abs ÷ 127 floored at 1e-8, round half to even,
the clip to ±127. Both contractions are int8 × int8 → int32 in the
reference (``preferred_element_type=jnp.int32``). CUDA's ``torch.matmul``
has no batched int8 product (``torch._int_mm`` is 2-D and needs more
than 16 rows; a decode step has one query row per KV head), so
:func:`int8_contract` takes each product in float32 on the integer codes
and converts the result to int32. That is exact while every partial sum
stays below 2^24: a term is at most 127 · 127 = 16129, so any sum of up
to 1040 terms is exact in any order, TF32 or not (a code of 8 bits is
exact in TF32's 11). QK sums over ``head_dim`` (at most 128 in every
config); PV sums over the cache's slots and is cut into chunks of
:data:`INT8_CHUNK` slots, each chunk's exact sum converted to int32 and
the chunks added in int32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["flash_attention", "decode_attention", "quantize_per_token",
           "quantize_per_channel", "quantize_at", "decode_attention_int8",
           "int8_contract", "INT8_CHUNK"]

_NEG = -1e30
# Slots of one float32 PV product over int8 codes: at most 1040 terms of
# at most 127 · 127 keep every partial sum below 2^24, exact.
INT8_CHUNK = 1024


def _mask(mode: str, window: int, pos_q, pos_k):
    """(…, lq, lk) bool mask from broadcast position vectors.
    Negative key positions mark chunk padding and are always masked."""
    pq = pos_q[..., :, None]
    pk = pos_k[..., None, :]
    valid = pk >= 0
    if mode == "full":
        return torch.broadcast_to(
            valid, torch.broadcast_shapes(pq.shape, pk.shape))
    m = (pk <= pq) & valid
    if mode == "local" and window > 0:
        m = m & (torch.div(pq, window, rounding_mode="floor")
                 == torch.div(pk, window, rounding_mode="floor"))
    return m


def _kv_blocks(qc: int, kc: int, i: int) -> int:
    """KV blocks that query block ``i`` can see under exact causal."""
    return (i + 1) * (qc // kc) if qc >= kc else i // (kc // qc) + 1


def flash_attention(q, k, v, *, pos_q, pos_k, mode: str = "causal",
                    window: int = 0, q_chunk: int = 1024,
                    kv_chunk: int = 1024, exact_causal: bool = False):
    """Online-softmax attention.

    Args:
      q: ``(b, lq, h, dh)``; k/v: ``(b, lk, kh, dh)`` with ``h % kh == 0``.
      pos_q/pos_k: ``(b, lq)`` / ``(b, lk)`` integer absolute positions.
      exact_causal: query block ``i`` visits only KV blocks ``[0, i]``
        (causal mode, ``lq == lk``, more than one query block).
    Returns ``(b, lq, h, dh)`` in q.dtype.
    """
    b, lq0, h, dh = q.shape
    lk0, kh = k.shape[1], k.shape[2]
    qc = min(q_chunk, lq0)
    kc = min(kv_chunk, lk0)
    if lq0 % qc:                            # pad queries (output sliced back)
        pad = qc - lq0 % qc
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        pos_q = F.pad(pos_q, (0, pad), value=0)
    if lk0 % kc:                            # pad keys (masked via pos = -1)
        pad = kc - lk0 % kc
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        pos_k = F.pad(pos_k, (0, pad), value=-1)
    lq, lk = q.shape[1], k.shape[1]
    g = h // kh
    scale = dh ** -0.5
    nq, nk = lq // qc, lk // kc

    # (nq, b, kh, g, qc, dh) / (nk, b, kh, kc, dh), as the reference's scan
    # inputs.
    qr = q.reshape(b, nq, qc, kh, g, dh).permute(1, 0, 3, 4, 2, 5)
    pqr = pos_q.reshape(b, nq, qc).transpose(0, 1)
    kr = k.reshape(b, nk, kc, kh, dh).permute(1, 0, 3, 2, 4)
    vr = v.reshape(b, nk, kc, kh, dh).permute(1, 0, 3, 2, 4)
    pkr = pos_k.reshape(b, nk, kc).transpose(0, 1)

    def q_block(i: int, n_kv: int):
        qi = qr[i].float()                   # (b, kh, g, qc, dh)
        pqi = pqr[i]                         # (b, qc)
        m = torch.full((b, kh, g, qc), _NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, kh, g, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kh, g, qc, dh), dtype=torch.float32,
                          device=q.device)
        for j in range(n_kv):
            kj, vj, pkj = kr[j], vr[j], pkr[j]   # (b, kh, kc, dh), (b, kc)
            s = torch.matmul(qi, kj.float()[:, :, None].transpose(-1, -2))
            s = s * scale                    # (b, kh, g, qc, kc)
            msk = _mask(mode, window, pqi, pkj)[:, None, None]
            s = torch.where(msk, s, _NEG)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(msk, p, 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            pv = torch.matmul(p.to(vj.dtype).float(), vj.float()[:, :, None])
            acc = acc * corr[..., None] + pv
            m = m_new
        return acc / torch.clamp(l, min=1e-20)[..., None]

    if exact_causal and mode == "causal" and nq > 1 and lq == lk:
        outs = [q_block(i, _kv_blocks(qc, kc, i)) for i in range(nq)]
    else:
        outs = [q_block(i, nk) for i in range(nq)]
    out = torch.stack(outs)                  # (nq, b, kh, g, qc, dh)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, lq, h, dh)
    return out[:, :lq0].to(q.dtype)


def decode_attention(q, k_cache, v_cache, *, cur_pos, mode: str = "causal",
                     window: int = 0):
    """One-token attention over a KV cache.

    Args:
      q: ``(b, 1, h, dh)``; caches ``(b, S, kh, dh)``.
      cur_pos: int — position of the new token; cache slots ``> cur_pos``
        are masked (slot ``cur_pos`` holds the new K/V, written by the
        caller before this call).
    """
    b, _, h, dh = q.shape
    S, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    qr = q.reshape(b, kh, g, dh).float()
    # (b, kh, g, dh) x (b, kh, dh, S) -> (b, kh, g, S)
    s = torch.matmul(qr, k_cache.float().permute(0, 2, 3, 1)) * dh ** -0.5
    slot = torch.arange(S, device=q.device)
    msk = slot <= cur_pos
    if mode == "local" and window > 0:
        msk = msk & (torch.div(slot, window, rounding_mode="floor")
                     == int(cur_pos) // window)
    s = torch.where(msk, s, _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p.to(v_cache.dtype).float(),
                       v_cache.float().transpose(1, 2))
    return out.reshape(b, 1, h, dh).to(q.dtype)


def _per_code(x):
    """``x / 127`` correctly rounded on every device. (CUDA divides by a
    Python scalar as a product with its rounded reciprocal, a last-bit
    difference from the CPU's and the reference's quotient; by a tensor
    it divides.)"""
    return x / torch.full((), 127.0, device=x.device)


def quantize_at(x, scale):
    """int8 codes of ``x`` (float32) at ``scale`` (broadcast): round half
    to even, clipped to ±127."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_per_token(x):
    """int8-quantize ``x[(b, s, kh, dh)]`` with a per-(token, head) scale
    ``(b, s, kh)`` float32."""
    xf = x.float()
    scale = torch.clamp(_per_code(torch.amax(torch.abs(xf), dim=-1)),
                        min=1e-8)
    return quantize_at(xf, scale[..., None]), scale


def quantize_per_channel(x):
    """int8-quantize ``x[(b, s, kh, dh)]`` with a per-(head, channel)
    scale ``(b, kh, dh)`` float32 shared over tokens — required so the
    scale factors out of the PV contraction."""
    xf = x.float()
    scale = torch.clamp(_per_code(torch.amax(torch.abs(xf), dim=1)),
                        min=1e-8)
    return quantize_at(xf, scale[:, None]), scale


def int8_contract(a, b):
    """``a @ b`` of int8 codes as int32, exactly: ``a`` ``(..., m, n)``,
    ``b`` ``(..., n, p)``, int8 (or float32 holding integers in
    [-127, 127]). The contraction over ``n`` runs as float32 products of
    at most :data:`INT8_CHUNK` terms, each exact, their results added in
    int32."""
    a, b = a.float(), b.float()
    n = a.shape[-1]
    out = None
    for s0 in range(0, n, INT8_CHUNK):
        part = torch.matmul(a[..., s0:s0 + INT8_CHUNK],
                            b[..., s0:s0 + INT8_CHUNK, :]).to(torch.int32)
        out = part if out is None else out + part
    return out


def decode_attention_int8(q, kq, k_scale, vq, v_scale, *, cur_pos,
                          mode: str = "causal", window: int = 0):
    """One-token attention over an int8-quantized KV cache: K per-token
    scales, V per-channel scales, both contractions int8 × int8 → int32
    (:func:`int8_contract`), so the cache is read at 1 byte an element.

    Args: q ``(b, 1, h, dh)``; kq/vq ``(b, S, kh, dh)`` int8;
          k_scale ``(b, S, kh)``; v_scale ``(b, kh, dh)``; ``cur_pos`` as
          :func:`decode_attention`'s.
    """
    b, _, h, dh = q.shape
    S, kh = kq.shape[1], kq.shape[2]
    g = h // kh
    qr = q.reshape(b, kh, g, dh).float()
    q_scale = torch.clamp(_per_code(torch.amax(torch.abs(qr), dim=-1)),
                          min=1e-8)
    qq = quantize_at(qr, q_scale[..., None])
    # (b, kh, g, dh) x (b, kh, dh, S) -> (b, kh, g, S)
    s32 = int8_contract(qq, kq.permute(0, 2, 3, 1))
    s = (s32.float() * q_scale[..., None]
         * k_scale.transpose(1, 2)[:, :, None, :]) * dh ** -0.5
    slot = torch.arange(S, device=q.device)
    msk = slot <= cur_pos
    if mode == "local" and window > 0:
        msk = msk & (torch.div(slot, window, rounding_mode="floor")
                     == int(cur_pos) // window)
    s = torch.where(msk, s, _NEG)
    p = torch.softmax(s, dim=-1)
    # dynamic per-row scale: flat rows have p ≈ 1/S « 1/127 otherwise
    p_scale = _per_code(torch.clamp(torch.amax(p, dim=-1, keepdim=True),
                                    min=1e-9))
    pq = quantize_at(p, p_scale)
    # (b, kh, g, S) x (b, kh, S, dh) -> (b, kh, g, dh)
    o32 = int8_contract(pq, vq.transpose(1, 2))
    out = (o32.float() * p_scale) * v_scale[:, :, None, :]
    return out.reshape(b, 1, h, dh).to(q.dtype)
