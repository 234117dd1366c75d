"""Mamba2 (SSD, state-space duality) mixer: chunked prefill + O(1) decode.

Port of ``repro/models/ssm.py``. The chunked SSD algorithm (Dao & Gu
2024, "minimal SSD"): the sequence is split into chunks of ``chunk``
steps; within a chunk the recurrence is a small quadratic attention-like
product, and across chunks a loop carries the (h, p, n) state (the
reference's ``lax.scan``). The decode state is O(1) in sequence length:
one (h, p, n) tensor and a ``d_conv - 1`` convolution tail, both float32.

Dtypes follow the reference's. Projections and the prefill convolution
run in the activation dtype; the SSD runs in float32. In decode the fp32
convolution tail is concatenated with the new bf16 column, which JAX
promotes to float32, so decode's convolution (and its weights, cast to
the activation dtype first, as the reference does) runs in float32;
PyTorch's products do not promote mixed dtypes, so the port casts
explicitly.

The intra-chunk decay ``exp(seg)`` overflows to ``inf`` above the
diagonal for long chunks; it is masked with ``where``, never multiplied by
a 0/1 mask, which would turn ``inf · 0`` into NaN.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import rms_norm
from .params import ParamSpec

__all__ = ["mamba_specs", "mamba_apply", "mamba_decode", "mamba_cache_shape",
           "mamba_prefill"]


def _dims(cfg):
    di = cfg.d_inner
    g, n = cfg.ssm_groups, cfg.d_state
    h, p = cfg.ssm_heads, cfg.ssm_headdim
    return di, g, n, h, p


def mamba_specs(cfg, dtype=torch.float32) -> dict:
    di, g, n, h, p = _dims(cfg)
    conv_ch = di + 2 * g * n
    return {
        "in_proj": ParamSpec((cfg.d_model, 2 * di + 2 * g * n + h),
                             ("embed", "mlp"), dtype=dtype),
        "conv_w": ParamSpec((cfg.d_conv, conv_ch), (None, "mlp"),
                            init="small", dtype=dtype),
        "conv_b": ParamSpec((conv_ch,), ("mlp",), init="zeros", dtype=dtype),
        "A_log": ParamSpec((h,), (None,), init="ones", dtype=torch.float32),
        "dt_bias": ParamSpec((h,), (None,), init="zeros",
                             dtype=torch.float32),
        "D": ParamSpec((h,), (None,), init="ones", dtype=torch.float32),
        "norm": ParamSpec((di,), ("mlp",), init="ones", dtype=dtype),
        "out_proj": ParamSpec((di, cfg.d_model), ("mlp", "embed"),
                              dtype=dtype),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv along seq: ``x[(b, l, ch)]``, ``w[(dc, ch)]``."""
    dc = w.shape[0]
    out = x * w[-1][None, None, :]
    for t in range(dc - 1):
        shift = dc - 1 - t
        out = out + F.pad(x, (0, 0, shift, 0))[:, :-shift] \
            * w[t][None, None, :]
    return out + b[None, None, :]


def _pad_seq(x, pad: int):
    """Zeros after the sequence axis (1) of ``x``."""
    return F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad))


def _ssd(xdt, dA, B, C, chunk: int):
    """Chunked SSD → ``(y[(b,l,h,p)], S[(b,h,p,n)])``, ``S`` the state
    after the last step (a zero tail of padding leaves it as it is)."""
    b, l, h, p = xdt.shape
    n = B.shape[-1]
    c = min(chunk, l)
    if l % c:                      # pad tail (zero xdt ⇒ zero contribution)
        pad = c - l % c
        y, S = _ssd(_pad_seq(xdt, pad), _pad_seq(dA, pad), _pad_seq(B, pad),
                    _pad_seq(C, pad), c)
        return y[:, :l], S
    nc = l // c
    xc = xdt.reshape(b, nc, c, h, p)
    Bc = B.reshape(b, nc, c, h, n)
    Cc = C.reshape(b, nc, c, h, n)
    dAc = dA.reshape(b, nc, c, h).permute(0, 3, 1, 2)         # (b,h,nc,c)
    A_cs = torch.cumsum(dAc, dim=-1)

    # 1. intra-chunk (quadratic within a chunk)
    seg = A_cs[..., :, None] - A_cs[..., None, :]             # (b,h,nc,c,c)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=xdt.device))
    L = torch.where(tri, torch.exp(seg), 0.0)
    CB = torch.einsum("bzlhn,bzshn->bhzls", Cc, Bc)
    M = (CB * L).to(xdt.dtype)
    y = torch.einsum("bhzls,bzshp->bzlhp", M, xc)

    # 2. per-chunk end states
    decay_to_end = torch.exp(A_cs[..., -1:] - A_cs)           # (b,h,nc,c)
    states = torch.einsum("bzlhn,bhzl,bzlhp->bzhpn", Bc, decay_to_end, xc)

    # 3. inter-chunk recurrence (the reference's scan over chunks)
    chunk_decay = torch.exp(A_cs[..., -1]).permute(0, 2, 1)   # (b,nc,h)
    S = torch.zeros((b, h, p, n), dtype=torch.float32, device=xdt.device)
    S_in = []
    for z in range(nc):
        S_in.append(S)                     # the state entering chunk z
        S = S * chunk_decay[:, z, :, None, None] + states[:, z]
    S_in = torch.stack(S_in, dim=1)                           # (b,nc,h,p,n)

    # 4. state → output within a chunk
    decay_from_start = torch.exp(A_cs).permute(0, 2, 3, 1)    # (b,nc,c,h)
    y_off = torch.einsum("bzlhn,bzhpn,bzlh->bzlhp", Cc, S_in.float(),
                         decay_from_start)
    return (y + y_off).reshape(b, l, h, p), S


def _ssd_chunked(xdt, dA, B, C, chunk: int):
    """Chunked SSD. xdt: (b,l,h,p) = x·dt; dA: (b,l,h); B/C: (b,l,h,n)
    (groups pre-expanded to heads), all float32. Returns (b,l,h,p)."""
    return _ssd(xdt, dA, B, C, chunk)[0]


def _project(params, x, cfg):
    di, g, n, h, p = _dims(cfg)
    zxbcdt = torch.matmul(x, params["in_proj"].to(x.dtype))
    z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * g * n, h], dim=-1)
    return z, xBC, dt


def _split_xbc(xBC, cfg):
    di, g, n, h, p = _dims(cfg)
    b, l = xBC.shape[:2]
    xs, B, C = torch.split(xBC, [di, g * n, g * n], dim=-1)
    xs = xs.reshape(b, l, h, p)
    B = torch.repeat_interleave(B.reshape(b, l, g, n), h // g, dim=2)
    C = torch.repeat_interleave(C.reshape(b, l, g, n), h // g, dim=2)
    return xs, B, C


def _finish(params, y, z, cfg):
    b, l = y.shape[:2]
    y = y.reshape(b, l, cfg.d_inner).to(z.dtype)
    y = rms_norm(y * F.silu(z), params["norm"])
    return torch.matmul(y, params["out_proj"].to(y.dtype))


def _dt(params, dt):
    """softplus(dt + dt_bias) in float32."""
    return F.softplus(dt.float() + params["dt_bias"])


def _mixer(params, x, cfg):
    """The SSD mixer on ``x[(b, l, d)]`` → ``(out, xBC, S)``: the output,
    the projected conv input (activation dtype) and the final state."""
    z, xBC, dt = _project(params, x, cfg)
    conv = F.silu(_causal_conv(xBC, params["conv_w"].to(x.dtype),
                             params["conv_b"].to(x.dtype)))
    xs, B, C = _split_xbc(conv, cfg)
    dt = _dt(params, dt)
    A = -torch.exp(params["A_log"])                           # (h,)
    y, S = _ssd(xs.float() * dt[..., None], dt * A[None, None, :],
                B.float(), C.float(), cfg.ssm_chunk)
    y = y + params["D"][None, None, :, None] * xs.float()
    return _finish(params, y.to(x.dtype), z, cfg), xBC, S


def mamba_apply(params, x, cfg):
    """Full-sequence SSD mixer: ``x[(b, l, d)]`` → ``(b, l, d)``."""
    return _mixer(params, x, cfg)[0]


def mamba_prefill(params, x, cfg):
    """:func:`mamba_apply` and the decode cache after ``x``: the last
    ``d_conv - 1`` projected columns and the SSD state after the last
    step, both float32. The reference (``blocks._mamba_prefill``)
    recomputes the projection and the per-chunk states for the cache;
    the port keeps them from the one pass, the same operations on the
    same inputs."""
    out, xBC, S = _mixer(params, x, cfg)
    return out, {"conv": xBC[:, -(cfg.d_conv - 1):, :].float(), "ssd": S}


def mamba_cache_shape(cfg, batch: int):
    di, g, n, h, p = _dims(cfg)
    conv_ch = di + 2 * g * n
    return {
        "conv": (batch, cfg.d_conv - 1, conv_ch),
        "ssd": (batch, h, p, n),
    }


def mamba_decode(params, x, cache, cfg):
    """One-token step: ``x[(b, 1, d)]``, cache {conv, ssd} (float32) →
    ``(y, {conv, ssd})``, the new state in new tensors."""
    z, xBC, dt = _project(params, x, cfg)
    # conv over (state ++ new), promoted to float32 as in the reference
    window = torch.cat([cache["conv"], xBC.float()], dim=1)  # (b, dc, ch)
    w = params["conv_w"].to(x.dtype).float()
    conv_out = torch.einsum("btc,tc->bc", window, w) \
        + params["conv_b"].to(x.dtype).float()
    xs, B, C = _split_xbc(F.silu(conv_out)[:, None, :], cfg)  # (b,1,h,·)
    dt = _dt(params, dt)[:, 0]                                # (b,h)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A[None, :])                           # (b,h)
    xdt = xs[:, 0] * dt[..., None]                            # (b,h,p)
    S = cache["ssd"] * dA[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", xdt, B[:, 0])
    y = torch.einsum("bhn,bhpn->bhp", C[:, 0], S)
    y = y + params["D"][None, :, None] * xs[:, 0]
    out = _finish(params, y[:, None].to(x.dtype), z, cfg)
    return out, {"conv": window[:, 1:], "ssd": S}
