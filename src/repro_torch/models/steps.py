"""Step functions: the loss, the train step, and the serving steps.

Port of ``loss_fn``, ``make_train_step``, ``make_prefill_step`` and
``make_decode_step`` of ``repro/models/steps.py``. The reference closes
over a mesh and its sharding rules and returns pure functions for
``jax.jit``; the port runs eagerly on one device, so each factory closes
over the config (and the optimizer) alone, and the train step updates its
state in place. ``rules_for``, ``input_specs``, ``abstract_cache``,
``train_state_specs`` and ``MEM_LEN_DIV`` come with the mesh (ROADMAP
A15 (3)).

Every family trains and serves: dense, MoE, SSM, hybrid, enc-dec and VLM
(a batch of the last two also holds ``frames`` / ``img``, split into
microbatches along with the tokens).

Gradients of the stacked layer parameters: ``forward`` runs layer ``r``
on ``params["blocks"][...][r]`` (and the encoder's layer ``r`` on
``params["encoder"]["blocks"][...][r]``). Taken through autograd on the
stacked tensor, each such ``select`` would hand back a zero tensor of the
whole stack with one layer filled in (3.2 GB per MLP leaf of
phi3-mini-3.8b, per layer). :func:`loss_and_grads` instead gives
``forward`` one leaf per layer, a detached view of the stacked parameter
whose ``.grad`` is the matching slice of one stacked gradient buffer:
autograd's accumulation then adds each layer's gradient in place into
that slice.
"""
from __future__ import annotations

import torch

from . import model as model_lib
from .params import iter_leaves, torch_dtype
from .. import optim as optim_lib

__all__ = [
    "loss_fn", "loss_and_grads", "accumulate_grads", "make_train_step",
    "make_prefill_step", "make_decode_step",
]

_LATER = "ROADMAP A15 (3)"


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def loss_fn(cfg, params, batch, *, z_loss: float = 1e-4,
            moe_coef: float = 0.01, remat: bool = True):
    """Masked next-token cross-entropy + z-loss + MoE aux, as the
    reference's. ``batch``: tensors ``tokens``, ``labels`` and optionally
    ``loss_mask`` on the parameters' device. ``remat`` is ``forward``'s.
    Returns ``(total, {"ce", "z_loss", "moe_aux"})``."""
    logits, aux = model_lib.forward(
        cfg, params, batch["tokens"], frames=batch.get("frames"),
        img=batch.get("img"), remat=remat)
    labels = batch["labels"].long()
    logits = logits.float()
    # Mask vocab padding columns (vocab_padded > vocab).
    vmask = torch.arange(logits.shape[-1], device=logits.device) < cfg.vocab
    logits = torch.where(vmask[None, None, :], logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = ((lse - ll) * mask).sum() / denom
    zl = z_loss * ((lse ** 2) * mask).sum() / denom
    total = ce + zl + moe_coef * aux["moe_aux"]
    return total, {"ce": ce, "z_loss": zl, "moe_aux": aux["moe_aux"]}


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------

def _grad_leaf(p, g):
    leaf = p.detach().requires_grad_(True)
    leaf.grad = g
    return leaf


def _grad_leaves(params, grads):
    """``params`` as autograd leaves whose ``.grad`` are views of
    ``grads``; each stacked leaf under a ``blocks`` key (the decoder's,
    the encoder's) as one leaf per layer."""
    def per_layer(p, g):
        return [_grad_leaf(p[r], g[r]) for r in range(p.shape[0])]

    def mapped(p, g, fn):
        if isinstance(p, dict):
            return {k: mapped(p[k], g[k], per_layer if k == "blocks"
                              else fn) for k in p}
        return fn(p, g)

    return mapped(params, grads, _grad_leaf)


def _zeros_like(params, dtype=None):
    """A gradient buffer: zeros shaped as ``params`` (each leaf's dtype,
    or ``dtype``)."""
    if isinstance(params, dict):
        return {k: _zeros_like(v, dtype) for k, v in params.items()}
    return torch.zeros(params.shape, dtype=dtype or params.dtype,
                       device=params.device)


def loss_and_grads(cfg, params, batch, *, grads=None, remat: bool = True):
    """``jax.value_and_grad(loss_fn, has_aux=True)`` for the port: runs
    the loss and its backward, **adding** the gradient of every leaf into
    ``grads`` (a zero buffer of the parameters' dtypes when ``None``).
    Returns ``((total, metrics), grads)``, detached."""
    if grads is None:
        grads = _zeros_like(params)
    total, metrics = loss_fn(cfg, _grad_leaves(params, grads), batch,
                             remat=remat)
    total.backward()
    return ((total.detach(), {k: v.detach() for k, v in metrics.items()}),
            grads)


def accumulate_grads(cfg, params, batch, grad_accum: int = 1):
    """The gradients of one train step: ``((loss, metrics), grads)``.

    ``grad_accum = k > 1`` splits ``batch`` into k microbatches as the
    reference does (``x.reshape(k, b // k, ...)``); each one's backward
    adds into the gradient buffer, one microbatch's activations alive at
    a time. Where ``cfg.grad_accum_dtype`` differs from a parameter's
    dtype, the sum is kept in a separate accumulator of that dtype, as the
    reference's ``gsum + g.astype(acc)``. The gradients are then divided
    by k, and the loss and metrics are the means over the microbatches.
    With k = 1 the gradients stay in the parameters' dtypes, as the
    reference's do."""
    k = int(grad_accum)
    grads = _zeros_like(params)
    if k == 1:
        return loss_and_grads(cfg, params, batch, grads=grads)
    acc_dtype = torch_dtype(cfg.grad_accum_dtype)
    same = all(p.dtype == acc_dtype for _, p in iter_leaves(params))
    acc = grads if same else _zeros_like(params, acc_dtype)
    loss, metrics = 0.0, {"ce": 0.0, "z_loss": 0.0, "moe_aux": 0.0}
    for i in range(k):
        mb = {key: x.reshape(k, x.shape[0] // k, *x.shape[1:])[i]
              for key, x in batch.items()}
        if not same and i:
            for _, g in iter_leaves(grads):
                g.zero_()
        (l, m), _ = loss_and_grads(cfg, params, mb, grads=grads)
        if not same:
            for (_, g), (_, a) in zip(iter_leaves(grads), iter_leaves(acc)):
                a.add_(g.to(acc_dtype))
        loss = loss + l
        metrics = {key: metrics[key] + m[key] for key in metrics}
    for _, g in iter_leaves(acc):
        g.div_(k)
    return (loss / k, {key: v / k for key, v in metrics.items()}), acc


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def _on_device(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(cfg, optimizer: optim_lib.Optimizer, mesh=None,
                    rules=None, clip_norm: float = 1.0, grad_accum: int = 1,
                    param_shardings=None):
    """``train_step(state, batch) -> (state, metrics)`` on ``state =
    {"params", "opt", "step"}``, updated **in place**.

    The gradients come from :func:`accumulate_grads` (``grad_accum``
    microbatches), are clipped to ``clip_norm`` and handed to
    ``optimizer.update``; then ``state["step"]`` counts one more.
    ``metrics`` holds ``loss``, ``grad_norm``, ``ce``, ``z_loss`` and
    ``moe_aux`` (means over the microbatches) as 0-d device tensors.

    ``batch`` holds numpy arrays or tensors; they are moved to the
    parameters' device. ``mesh``, ``rules`` and ``param_shardings`` are
    the reference's sharding arguments: they come with ``mesh.py``.
    """
    if mesh is not None or rules is not None or param_shardings is not None:
        raise NotImplementedError(
            "make_train_step(mesh=, rules=, param_shardings=): the mesh "
            f"and sharding rules are not ported yet: {_LATER}")
    k = int(grad_accum)

    def train_step(state, batch):
        params = state["params"]
        device = next(iter_leaves(params))[1].device
        (loss, metrics), grads = accumulate_grads(
            cfg, params, _on_device(batch, device), k)
        grads, gnorm = optim_lib.clip_by_global_norm(grads, clip_norm)
        optimizer.update(grads, state["opt"], params)
        state["step"] += 1
        return state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------

def make_prefill_step(cfg):
    def prefill_step(params, batch):
        return model_lib.prefill(
            cfg, params, batch["tokens"], frames=batch.get("frames"),
            img=batch.get("img"))

    return prefill_step


def make_decode_step(cfg):
    def decode_step(params, cache, token, pos):
        return model_lib.decode_step(cfg, params, cache, token, pos)

    return decode_step
