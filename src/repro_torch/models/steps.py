"""Step functions: the loss, the train step, the serving steps, and the
abstract input and state specs.

Port of ``repro/models/steps.py``. The reference closes over a mesh and
its sharding rules and returns pure functions for ``jax.jit``; the port
runs eagerly on one card, so each factory closes over the config, the
optimizer and the ``(mesh, rules)`` it enters around every call
(``sharding.use_mesh_rules``: the model's ``shard`` sites resolve their
specs, and the MoE takes the owner-computes dispatch), and the train step
updates its state in place. ``rules_for``, ``input_specs``,
``abstract_cache`` and ``train_state_specs`` give the reference's
abstract trees (``params.ShapeDtypeStruct``: shape, dtype and partition
spec, no allocation) for every (arch, shape, mesh).

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
from .params import (ShapeDtypeStruct, abstract_params, iter_leaves,
                     logical_to_spec, torch_dtype, tree_shardings)
from .sharding import default_rules, long_context_rules, shard, \
    use_mesh_rules
from .. import optim as optim_lib

__all__ = [
    "loss_fn", "loss_and_grads", "accumulate_grads", "make_train_step",
    "make_prefill_step", "make_decode_step", "input_specs",
    "train_state_specs", "rules_for", "abstract_cache", "MEM_LEN_DIV",
]

# enc-dec / vlm memory length relative to seq (the reference's): train
# splits seq 50/50 between source and target; decode shapes use seq/8
# source frames (speech prompt) and n_img_tokens patches for vlm.
MEM_LEN_DIV = {"train": 2, "prefill": 2, "decode": 8}


def rules_for(shape, cfg=None):
    """Sharding rules per input shape (``configs.SHAPES``), the
    reference's: ``long_500k`` takes :func:`long_context_rules`; serving
    (prefill / decode) replicates the parameters over the data axes
    (``embed`` → ``None``) when a 16-way model split leaves at most 9e9
    bytes of them a device."""
    if shape.name == "long_500k":
        rules = long_context_rules()
    else:
        rules = default_rules()
    if cfg is not None and shape.kind in ("prefill", "decode"):
        per_chip = (cfg.param_count()
                    * torch_dtype(cfg.param_dtype).itemsize / 16)
        if per_chip <= 9e9:
            rules["embed"] = None      # replicate over data/pod for serving
    return rules


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
    parameters' device.

    ``mesh`` (``launch.mesh.Mesh``) and ``rules`` (default
    :func:`sharding.default_rules`) are entered around the step, as the
    reference's ``use_mesh_rules``: the batch and the model's activations
    resolve their specs, and an MoE layer runs the owner-computes
    dispatch. ``param_shardings``, the reference's pin of the gradient
    accumulator to the parameters' layout, must equal
    ``params.tree_shardings`` of the config's specs on ``mesh`` (a
    ``ValueError`` names the first leaf that differs); on one card the
    accumulator is the parameters' layout already.
    """
    rules = rules or default_rules()
    if param_shardings is not None:
        _check_shardings(param_shardings, tree_shardings(
            model_lib.model_specs(cfg), mesh, rules))
    k = int(grad_accum)

    def train_step(state, batch):
        params = state["params"]
        device = next(iter_leaves(params))[1].device
        with use_mesh_rules(mesh, rules):
            batch = {key: shard(x, "batch", *([None] * (x.ndim - 1)))
                     for key, x in _on_device(batch, device).items()}
            (loss, metrics), grads = accumulate_grads(cfg, params, batch, k)
            grads, gnorm = optim_lib.clip_by_global_norm(grads, clip_norm)
            optimizer.update(grads, state["opt"], params)
        state["step"] += 1
        return state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step


def _check_shardings(got, want, path=()):
    """``ValueError`` at the first leaf where the partition-spec trees
    ``got`` and ``want`` differ (in keys or in a spec)."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            keys = sorted(got) if isinstance(got, dict) else got
            raise ValueError(f"param_shardings at {'/'.join(path) or '/'}: "
                             f"{keys} is not the parameters' keys "
                             f"{sorted(want)}")
        for key in sorted(want):
            _check_shardings(got[key], want[key], path + (key,))
    elif tuple(got) != want:
        raise ValueError(f"param_shardings at {'/'.join(path)}: {got} is "
                         f"not the parameters' partition spec {want}")


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------

def make_prefill_step(cfg, mesh=None, rules=None):
    rules = rules or default_rules()

    def prefill_step(params, batch):
        with use_mesh_rules(mesh, rules):
            return model_lib.prefill(
                cfg, params, batch["tokens"], frames=batch.get("frames"),
                img=batch.get("img"))

    return prefill_step


def make_decode_step(cfg, mesh=None, rules=None):
    rules = rules or default_rules()

    def decode_step(params, cache, token, pos):
        with use_mesh_rules(mesh, rules):
            return model_lib.decode_step(cfg, params, cache, token, pos)

    return decode_step


# ---------------------------------------------------------------------------
# Abstract specs (dry-run: zero allocation)
# ---------------------------------------------------------------------------

def _sds(shape, dtype, axes, mesh, rules):
    return ShapeDtypeStruct(
        tuple(shape), dtype,
        None if mesh is None else logical_to_spec(axes, rules, mesh))


def input_specs(cfg, shape, mesh=None, rules=None) -> dict:
    """:class:`params.ShapeDtypeStruct` stand-ins for every model input of
    the cell ``(cfg, shape)``: tokens (and labels for training), the stub
    frontend's ``frames`` / ``img``, or for decode the cache, one token
    and its position."""
    rules = rules or rules_for(shape)
    B, L = shape.global_batch, shape.seq_len
    d_front = cfg.d_frontend or cfg.d_model

    def tok(shp, axes):
        return _sds(shp, torch.int32, axes, mesh, rules)

    def emb(shp, axes):
        return _sds(shp, torch.float32, axes, mesh, rules)

    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            l_tgt = L // 2
            batch = {
                "frames": emb((B, L - l_tgt, d_front), ("batch", "seq", None)),
                "tokens": tok((B, l_tgt), ("batch", "seq")),
            }
            if shape.kind == "train":
                batch["labels"] = tok((B, l_tgt), ("batch", "seq"))
        else:
            batch = {"tokens": tok((B, L), ("batch", "seq"))}
            if cfg.family == "vlm":
                batch["img"] = emb((B, cfg.n_img_tokens, d_front),
                                   ("batch", None, None))
            if shape.kind == "train":
                batch["labels"] = tok((B, L), ("batch", "seq"))
        return batch

    # decode: cache + one token
    return {
        "cache": abstract_cache(cfg, shape, mesh, rules),
        "token": tok((B, 1), ("batch", None)),
        "pos": ShapeDtypeStruct((), torch.int32),
    }


def abstract_cache(cfg, shape, mesh, rules) -> dict:
    """The decode cache of ``(cfg, shape)`` (``model.cache_specs``) as
    :class:`params.ShapeDtypeStruct` leaves."""
    B, L = shape.global_batch, shape.seq_len
    mem_len = (cfg.n_img_tokens if cfg.family == "vlm"
               else L // MEM_LEN_DIV["decode"])
    tree = model_lib.cache_specs(cfg, B, L, mem_len)
    return {g: {name: _sds(shp, dtype, axes, mesh, rules)
                for name, (shp, axes, dtype) in leaves.items()}
            for g, leaves in tree.items()}


def train_state_specs(cfg, optimizer: optim_lib.Optimizer, mesh=None,
                      rules=None):
    """The abstract train state ``{params, opt, step}``."""
    rules = rules or default_rules()
    pspecs = model_lib.model_specs(cfg)
    return {"params": abstract_params(pspecs, mesh, rules),
            "opt": abstract_params(optimizer.state_specs(pspecs), mesh,
                                   rules),
            "step": ShapeDtypeStruct((), torch.int32)}
