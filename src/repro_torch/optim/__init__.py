"""Optimizers (AdamW, Adafactor), LR schedules, global-norm clipping.

Port of ``repro/optim/__init__.py``, written out in PyTorch (no
``torch.optim``). Each optimizer exposes:
  * ``init(params)``          — state tree, on the parameters' device;
  * ``update(grads, state, params)`` → ``(params, state)``;
  * ``state_specs(param_specs)`` — :class:`~..models.params.ParamSpec`
    tree for the state, so ``init_params`` can build it.

The arithmetic is the reference's, in the same order: AdamW's ``b1 **
count`` bias correction with weight decay added to the step, Adafactor's
factored second moment (``vr`` / ``vc`` for leaves of two or more dims)
and its RMS clip over the whole leaf. The learning rate and the bias
corrections stay 0-d device tensors: a step reads nothing back to the
host.

Unlike the reference's functional update, ``update`` works **in place**:
it writes the new parameters and moments into the tensors it was given
and returns those same tensors. A model whose fp32 parameters, gradients
and two moments fill most of the card (phi3-mini-3.8b: 4 × 15.3 GB on an
80 GB H100) has no room for a second copy of any of them, nor for the
half-dozen leaf-sized temporaries the formulas make when written leaf-wide
(a stacked MLP matrix is 3.2 GB). So every elementwise pass runs over
slices of a leaf's leading axis (:func:`_slices`), of about ``_CHUNK``
elements each. ``update`` also consumes ``grads``: Adafactor keeps each
leaf's update direction in its gradient's storage between its two passes,
and :func:`clip_by_global_norm` scales the gradients in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..models.params import ParamSpec, iter_leaves, torch_dtype

__all__ = [
    "Optimizer", "adamw", "adafactor", "cosine_schedule", "global_norm",
    "clip_by_global_norm", "make_optimizer",
]

# Elements per slice of an elementwise pass (64 MB of fp32).
_CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable          # (grads, state, params) -> (params, state)
    state_specs: Callable     # (param_spec_tree) -> state spec tree


def cosine_schedule(peak_lr: float = 3e-4, warmup: int = 100,
                    total: int = 10_000, floor: float = 0.1):
    """``lr(step)``: linear warmup, then cosine decay to ``floor`` of the
    peak. ``step`` is an int or an integer tensor; the result is a float32
    tensor on the step's device."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(1, warmup)
        t = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


def _slices(t: torch.Tensor, keep: int = 1) -> list:
    """Index tuples that cover ``t`` in pieces of about ``_CHUNK``
    elements, cut along its leading axis only. A tensor of ``keep`` dims
    or fewer (or a small one) is one piece: Adafactor's factored moments
    reduce over the last two dims, so they pass ``keep=2``."""
    if t.dim() <= keep or t.numel() <= _CHUNK:
        return [(...,)]
    per_row = t.numel() // t.shape[0]
    rows = max(1, _CHUNK // per_row)
    return [(slice(i, i + rows),) for i in range(0, t.shape[0], rows)]


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    """``sum(x.float() ** 2)`` as a float32 0-d tensor, slice by slice."""
    total = None
    for s in _slices(x):
        part = torch.sum(torch.square(x[s].float()))
        total = part if total is None else total + part
    return total


def global_norm(tree) -> torch.Tensor:
    total = None
    for _, x in iter_leaves(tree):
        sq = _sum_squares(x)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float):
    """Scale every leaf of ``tree`` in place so the global norm is at most
    ``max_norm``; returns ``(tree, norm before clipping)``."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for _, g in iter_leaves(tree):
        for s in _slices(g):
            if g.dtype == torch.float32:
                g[s].mul_(scale)
            else:
                g[s].copy_(g[s].float() * scale)
    return tree, norm


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _zeros_like_tree(params, dtype):
    return _tree_map(lambda p: torch.zeros(p.shape, dtype=dtype,
                                           device=p.device), params)


def _device_of(tree) -> torch.device:
    for _, leaf in iter_leaves(tree):
        return leaf.device
    return torch.device("cpu")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr: Callable, *, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          state_dtype=torch.float32) -> Optimizer:
    state_dtype = torch_dtype(state_dtype)

    def init(params):
        return {"m": _zeros_like_tree(params, state_dtype),
                "v": _zeros_like_tree(params, state_dtype),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=_device_of(params))}

    def update(grads, state, params):
        state["count"] += 1
        cf = state["count"].to(torch.float32)
        lr_t = lr(state["count"])
        bc1 = 1 - b1 ** cf
        bc2 = 1 - b2 ** cf
        for path, p in iter_leaves(params):
            g, m, v = (_get(t, path) for t in (grads, state["m"],
                                                state["v"]))
            for s in _slices(p):
                g32 = g[s].float()
                m32 = b1 * m[s].float() + (1 - b1) * g32
                v32 = b2 * v[s].float() + (1 - b2) * g32 * g32
                step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps) \
                    + weight_decay * p[s].float()
                p[s].copy_(p[s].float() - lr_t * step)
                m[s].copy_(m32)
                v[s].copy_(v32)
        return params, state

    def state_specs(param_specs):
        as_state = lambda s: ParamSpec(s.shape, s.axes, init="zeros",
                                       dtype=state_dtype)
        return {"m": _tree_map(as_state, param_specs),
                "v": _tree_map(as_state, param_specs),
                "count": ParamSpec((), (), init="zeros", dtype=torch.int32)}

    return Optimizer(init, update, state_specs)


# ---------------------------------------------------------------------------
# Adafactor (factored v, no momentum)
# ---------------------------------------------------------------------------

def adafactor(lr: Callable, *, decay=0.8, eps=1e-30, clip_thresh=1.0,
              weight_decay=0.0) -> Optimizer:
    def factored(shape) -> bool:
        return len(shape) >= 2

    def init(params):
        def per(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            if factored(p.shape):
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        return {"v": _tree_map(per, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=_device_of(params))}

    def direction(g, vdict, s, beta):
        """The unclipped update ``u`` of slice ``s``; writes the slice's
        new moments."""
        g32 = g[s].float()
        g2 = g32 * g32 + eps
        if factored(g.shape):
            vr = beta * vdict["vr"][s] + (1 - beta) * g2.mean(-1)
            vc = beta * vdict["vc"][s] + (1 - beta) * g2.mean(-2)
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp(vr.mean(-1, keepdim=True)[..., None],
                                   min=eps))
            u = g32 / torch.sqrt(torch.clamp(denom, min=eps))
            vdict["vr"][s].copy_(vr)
            vdict["vc"][s].copy_(vc)
        else:
            v = beta * vdict["v"][s] + (1 - beta) * g2
            u = g32 / torch.sqrt(torch.clamp(v, min=eps))
            vdict["v"][s].copy_(v)
        return u

    def update(grads, state, params):
        state["count"] += 1
        cf = state["count"].to(torch.float32)
        beta = 1.0 - cf ** (-decay)
        lr_t = lr(state["count"])
        for path, p in iter_leaves(params):
            g, vdict = _get(grads, path), _get(state["v"], path)
            # Pass 1: u per slice, kept in float32 (in the gradient's own
            # storage when that is float32), and sum(u²) over the leaf.
            u_buf = g if g.dtype == torch.float32 else \
                torch.empty(g.shape, dtype=torch.float32, device=g.device)
            sq = None
            for s in _slices(g, keep=2 if factored(g.shape) else 1):
                u = direction(g, vdict, s, beta)
                u_buf[s].copy_(u)
                part = torch.sum(u * u)
                sq = part if sq is None else sq + part
            # Pass 2: the RMS clip over the whole leaf, then the step.
            rms = torch.sqrt(sq / g.numel())
            clip = torch.clamp(rms / clip_thresh, min=1.0)
            for s in _slices(p):
                u = u_buf[s] / clip
                p32 = p[s].float()
                p[s].copy_(p32 - lr_t * (u + weight_decay * p32))
        return params, state

    def state_specs(param_specs):
        def per(s: ParamSpec):
            if factored(s.shape):
                return {"vr": ParamSpec(s.shape[:-1], s.axes[:-1],
                                        init="zeros", dtype=torch.float32),
                        "vc": ParamSpec(s.shape[:-2] + s.shape[-1:],
                                        s.axes[:-2] + s.axes[-1:],
                                        init="zeros", dtype=torch.float32)}
            return {"v": ParamSpec(s.shape, s.axes, init="zeros",
                                   dtype=torch.float32)}
        return {"v": _tree_map(per, param_specs),
                "count": ParamSpec((), (), init="zeros", dtype=torch.int32)}

    return Optimizer(init, update, state_specs)


def make_optimizer(name: str, lr: Callable | None = None, **kw) -> Optimizer:
    lr = lr or cosine_schedule()
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
