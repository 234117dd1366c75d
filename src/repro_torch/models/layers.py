"""Shared layer primitives: RMSNorm, RoPE, SwiGLU MLP, and the port's
``einsum``.

Port of ``repro/models/layers.py``. RMSNorm and RoPE compute in float32
and cast back to the input's dtype; SwiGLU casts each weight to the
activation dtype before its product, as the reference does. Eager PyTorch
makes that cast a copy on every call (XLA may fuse it into the product).
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from .params import ParamSpec

__all__ = [
    "rms_norm", "rope_freqs", "apply_rope", "swiglu", "mlp_specs", "mlp_apply",
    "norm_spec", "einsum", "watch_einsums", "einsum_watchers",
]

_EINSUM_WATCHERS: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_einsum_watchers", default=())


def einsum(equation: str, *operands):
    """``torch.einsum``, seen by the watchers of :func:`watch_einsums`.

    An einsum is composite: below autograd only its ``bmm`` / ``mul``
    remain, and a pair with nothing summed (an outer product) becomes a
    ``mul`` that a product counter cannot tell from elementwise work. The
    cost counter (``launch.flops.CostMode``) watches this function to count
    such pairs as the reference's ``dot_general`` does."""
    out = torch.einsum(equation, *operands)
    for watch in _EINSUM_WATCHERS.get():
        watch(equation, operands, out)
    return out


@contextlib.contextmanager
def watch_einsums(watchers):
    """Within the block, each of ``watchers`` (callables ``(equation,
    operands, out)``) sees every :func:`einsum`; the empty tuple clears
    them."""
    token = _EINSUM_WATCHERS.set(tuple(watchers))
    try:
        yield
    finally:
        _EINSUM_WATCHERS.reset(token)


def einsum_watchers() -> tuple:
    """The active watchers of :func:`einsum`."""
    return _EINSUM_WATCHERS.get()


def norm_spec(d: int, dtype=torch.float32) -> ParamSpec:
    return ParamSpec((d,), ("embed",), init="ones", dtype=dtype)


def rms_norm(x, weight, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * weight.float()).to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None):
    """(head_dim/2,) inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """Rotate ``x[(b, l, h, dh)]`` by ``positions[(b, l)]`` (int)."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, device=x.device)             # (dh/2,)
    ang = positions.float()[..., None] * inv                 # (b, l, dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mlp_specs(d: int, d_ff: int, dtype=torch.float32) -> dict:
    return {
        "w_gate": ParamSpec((d, d_ff), ("embed", "mlp"), dtype=dtype),
        "w_up": ParamSpec((d, d_ff), ("embed", "mlp"), dtype=dtype),
        "w_down": ParamSpec((d_ff, d), ("mlp", "embed"), dtype=dtype),
    }


def swiglu(x, w_gate, w_up, w_down):
    dt = x.dtype
    g = torch.matmul(x, w_gate.to(dt))
    u = torch.matmul(x, w_up.to(dt))
    h = F.silu(g) * u
    return torch.matmul(h, w_down.to(dt))


def mlp_apply(params, x):
    return swiglu(x, params["w_gate"], params["w_up"], params["w_down"])
