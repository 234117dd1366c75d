"""Unified LM: embedding → stacked block pattern → logits.

Port of ``repro/models/model.py`` for all six families (dense, MoE, SSM,
hybrid, enc-dec, VLM). Parameters for each pattern position are stacked
along a leading ``layers`` axis, as in the reference; where the reference
scans over that axis, the port runs a Python loop over views of it (no
copies). Caches are stacked the same way, ``(n_repeats, b, S, kh, dh)``
for attention's K/V and ``(n_repeats, b, …)`` for mamba's ``conv`` and
``ssd`` state, with the reference's keys and dtypes.

Entry points:
  * ``forward``      — full-sequence logits (training / teacher forcing);
  * ``prefill``      — last-token logits + per-block decode caches;
  * ``decode_step``  — one token in, one token out, caches updated in
    place.

``forward(remat=True)`` checkpoints each repeat group as the reference's
scan body is checkpointed (``torch.utils.checkpoint``, non-reentrant), and
each layer inside it only where a group holds more than two layers. The
config's ``remat_policy`` chooses what a checkpoint keeps: ``"nothing"``
recomputes the whole group in the backward; ``"dots"`` (the counterpart
of ``dots_with_no_batch_dims_saveable``) keeps the outputs of ``aten.mm``,
the weight products, which ``torch.matmul`` of ``(b, l, d) @ (d, f)``
lowers to, and recomputes attention's batched products with the rest.

The ``encdec`` and ``vlm`` families attend to a memory (the reference's
stub frontends): ``frames`` ``(b, l_src, d_frontend)`` go through
``encoder.frontend_proj`` and the encoder's stacked ``enc_pattern``
blocks (bidirectional, ``mode="full"``, remat ``nothing`` per repeat
group), ``img`` ``(b, n_img_tokens, d_frontend)`` through ``img_proj``.
The memory is handed to each checkpointed layer group as an argument, so
the encoder (or ``img_proj``) gets its gradient through every
cross-attention layer. ``decode_step`` needs no memory: prefill caches
each cross-attention layer's memory K/V (``ck`` / ``cv``).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from . import blocks as blk
from .layers import einsum_watchers, norm_spec, rms_norm, watch_einsums
from .params import ParamSpec, torch_dtype
from .sharding import active_mesh_rules, shard, use_mesh_rules

__all__ = [
    "model_specs", "forward", "prefill", "decode_step", "cache_specs",
    "frontend_shape",
]


# ---------------------------------------------------------------------------
# Parameter tree
# ---------------------------------------------------------------------------

def _stack_specs(specs, n: int):
    if isinstance(specs, ParamSpec):
        s = specs
        return ParamSpec((n,) + s.shape, ("layers",) + s.axes, init=s.init,
                         dtype=s.dtype,
                         fan_in_dims=tuple(d + 1 for d in s.fan_in_dims)
                         or tuple(range(1, max(2, len(s.shape)))))
    return {k: _stack_specs(v, n) for k, v in specs.items()}


def model_specs(cfg) -> dict:
    dtype = torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    specs: dict = {
        "embed": ParamSpec((cfg.vocab_padded, d), ("vocab", "embed"),
                           init="small", dtype=dtype),
        "out_norm": norm_spec(d, dtype),
        "blocks": {
            f"p{j}": _stack_specs(blk.block_specs(cfg, kind, dtype),
                                  cfg.n_repeats)
            for j, kind in enumerate(cfg.pattern)
        },
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.vocab_padded, d),
                                     ("vocab", "embed"), init="small",
                                     dtype=dtype)
    if cfg.family == "encdec":
        n_enc_rep = cfg.n_enc_layers // len(cfg.enc_pattern)
        specs["encoder"] = {
            "frontend_proj": ParamSpec(
                (cfg.d_frontend or d, d), (None, "embed"), dtype=dtype),
            "blocks": {
                f"p{j}": _stack_specs(blk.block_specs(cfg, kind, dtype),
                                      n_enc_rep)
                for j, kind in enumerate(cfg.enc_pattern)
            },
            "norm": norm_spec(d, dtype),
        }
    if cfg.family == "vlm":
        specs["img_proj"] = ParamSpec((cfg.d_frontend or d, d),
                                      (None, "embed"), dtype=dtype)
    return specs


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _layer(tree, r: int):
    """Layer ``r`` of a stacked tree: views, no copies. A stacked leaf may
    also be a sequence of per-layer tensors (the train step's gradient
    leaves, ``steps.loss_and_grads``)."""
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    return tree[r]


def _positions(tokens):
    b, l = tokens.shape[:2]
    return torch.arange(l, dtype=torch.int32,
                        device=tokens.device)[None].expand(b, l)


def _embed_tokens(cfg, params, tokens):
    h = params["embed"][tokens.long()]
    return shard(h.to(torch_dtype(cfg.act_dtype)),
                 "batch", "seq", "act_embed")


def _unembed(cfg, params, h):
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return shard(torch.matmul(h, w.to(h.dtype).t()),
                 "batch", "seq", "vocab")


# ---------------------------------------------------------------------------
# Activation checkpointing
# ---------------------------------------------------------------------------

def _save_weight_products(ctx, op, *args, **kwargs):
    """``"dots"``: keep what ``aten.mm`` computes, recompute the rest."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(cfg, fn):
    """``fn`` under a non-reentrant checkpoint with the config's policy
    (the reference: ``nothing_saveable`` for ``"nothing"``, else
    ``dots_with_no_batch_dims_saveable``)."""
    if cfg.remat_policy == "nothing":
        context_fn = noop_context_fn
    else:
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _save_weight_products)

    def run(*args):
        # The backward's recompute runs where autograd runs it (on CUDA,
        # the engine's device thread), outside the caller's mesh context:
        # it re-enters the forward's, so both take the same MoE path, and
        # the forward's einsum watchers, so a cost counter sees the
        # recompute's einsums.
        mesh_rules = active_mesh_rules() or (None, None)
        watchers = einsum_watchers()

        def in_context(*a):
            with use_mesh_rules(*mesh_rules), watch_einsums(watchers):
                return fn(*a)

        return checkpoint(in_context, *args, use_reentrant=False,
                          context_fn=context_fn)

    return run


def _run_blocks(cfg, blocks, h, pos, memory, remat: bool):
    """The layer loop of ``forward``; returns ``(h, moe aux)``.

    Remat is per repeat group, as the reference checkpoints its scan
    body; a group of more than two layers also checkpoints each layer, so
    the backward recomputes one layer's residuals at a time. ``memory``
    (``None`` but for ``encdec`` / ``vlm``) is an argument of each
    checkpointed function, as the hidden state is."""
    def one_layer(kind, p, h, memory):
        return blk.block_apply(cfg, kind, p, h, pos=pos, memory=memory,
                               mode="causal")

    if remat and len(cfg.pattern) > 2:
        one_layer = _checkpointed(cfg, one_layer)

    def body(h, aux, group, memory):
        for j, kind in enumerate(cfg.pattern):
            h, metrics = one_layer(kind, group[f"p{j}"], h, memory)
            if "moe_aux" in metrics:       # summed in the reference's order
                aux = aux + metrics["moe_aux"]
        return shard(h, "batch", "seq", "act_embed"), aux

    if remat:
        body = _checkpointed(cfg, body)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for r in range(cfg.n_repeats):
        h, aux = body(h, aux, _layer(blocks, r), memory)
    return h, aux


def _run_encoder(cfg, enc, h, pos, remat: bool):
    """The encoder's stacked ``enc_pattern`` groups, bidirectional
    (``mode="full"``), then its norm. Under ``remat`` each group is
    checkpointed with the reference's ``nothing_saveable``, whatever the
    config's ``remat_policy``."""
    def body(h, group):
        for j, kind in enumerate(cfg.enc_pattern):
            h, _ = blk.block_apply(cfg, kind, group[f"p{j}"], h, pos=pos,
                                   mode="full")
        return h

    if remat:
        body = _checkpointed(dataclasses.replace(cfg, remat_policy="nothing"),
                             body)
    for r in range(cfg.n_enc_layers // len(cfg.enc_pattern)):
        h = body(h, _layer(enc["blocks"], r))
    return rms_norm(h, enc["norm"])


def frontend_shape(cfg, batch: int, seq: int):
    """``(key, shape)`` of the stub frontend's input a batch of ``batch``
    sequences of ``seq`` tokens takes: ``("frames", (batch, seq,
    d_frontend))`` for ``encdec``, ``("img", (batch, n_img_tokens,
    d_frontend))`` for ``vlm``; ``None`` for the other families."""
    d_in = cfg.d_frontend or cfg.d_model
    if cfg.family == "encdec":
        return "frames", (batch, seq, d_in)
    if cfg.family == "vlm":
        return "img", (batch, cfg.n_img_tokens, d_in)
    return None


def _memory_of(cfg, params, frames=None, img=None, remat: bool = True):
    """The stub frontend's embeddings → the backbone's memory
    ``(b, lm, d)`` in the activation dtype: the encoder's output of
    ``frames`` (``encdec``), the projected ``img`` (``vlm``), else
    ``None``."""
    act = torch_dtype(cfg.act_dtype)
    if cfg.family == "encdec":
        enc = params["encoder"]
        h = torch.matmul(frames.to(act), enc["frontend_proj"].to(act))
        h = shard(h, "batch", "seq", "act_embed")
        return _run_encoder(cfg, enc, h, _positions(frames), remat)
    if cfg.family == "vlm":
        return torch.matmul(img.to(act), params["img_proj"].to(act))
    return None


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def forward(cfg, params, tokens, *, frames=None, img=None, remat=True):
    """Training forward: logits ``(b, l, vocab_padded)`` + aux losses.

    ``remat`` checkpoints as the module docstring says; it changes what
    the backward keeps and recomputes, never the values. ``frames``
    (``encdec``) and ``img`` (``vlm``) are the stub frontends' embeddings
    (module docstring)."""
    memory = _memory_of(cfg, params, frames, img, remat)
    h = _embed_tokens(cfg, params, tokens)
    pos = _positions(tokens)
    h, aux = _run_blocks(cfg, params["blocks"], h, pos, memory, remat)
    h = rms_norm(h, params["out_norm"])
    return _unembed(cfg, params, h), {"moe_aux": aux}


def prefill(cfg, params, tokens, *, frames=None, img=None):
    """Prompt processing: returns (last-token logits, cache tree)."""
    memory = _memory_of(cfg, params, frames, img, remat=False)
    h = _embed_tokens(cfg, params, tokens)
    pos = _positions(tokens)
    cache: dict = {}
    for r in range(cfg.n_repeats):
        group = _layer(params["blocks"], r)
        for j, kind in enumerate(cfg.pattern):
            h, c = blk.block_prefill(cfg, kind, group[f"p{j}"], h, pos=pos,
                                     memory=memory)
            stacked = cache.setdefault(f"p{j}", {})
            for name, t in c.items():
                if name not in stacked:    # one stacked buffer per leaf
                    stacked[name] = t.new_empty((cfg.n_repeats,) + t.shape)
                stacked[name][r] = t
    h = rms_norm(h, params["out_norm"])
    return _unembed(cfg, params, h[:, -1:, :]), cache


def decode_step(cfg, params, cache, token, pos: int):
    """One decode step. ``token[(b, 1)]``, ``pos`` = slot of the new
    token. Returns (logits[(b, 1, V)], cache), the cache written in
    place."""
    h = _embed_tokens(cfg, params, token)
    for r in range(cfg.n_repeats):
        group = _layer(params["blocks"], r)
        layer_cache = _layer(cache, r)
        for j, kind in enumerate(cfg.pattern):
            h, _ = blk.block_decode(cfg, kind, group[f"p{j}"], h,
                                    layer_cache[f"p{j}"], pos=pos)
    h = rms_norm(h, params["out_norm"])
    return _unembed(cfg, params, h), cache


def cache_specs(cfg, batch: int, seq: int, mem_len: int) -> dict:
    """(shape, logical axes, dtype) tree matching prefill's cache output —
    stacked along the layers axis."""
    out = {}
    for j, kind in enumerate(cfg.pattern):
        per = blk.block_cache_specs(cfg, kind, batch, seq, mem_len)
        out[f"p{j}"] = {
            name: ((cfg.n_repeats,) + shape, ("layers",) + axes, dtype)
            for name, (shape, axes, dtype) in per.items()
        }
    return out
