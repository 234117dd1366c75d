"""Activation-sharding context: logical constraints inside model code.

Port of ``repro/models/sharding.py``. Model code calls ``shard(x,
"batch", "seq", None)`` at the reference's sites. When a mesh context is
active (set by the step factories in ``models.steps`` and the serving
session) the reference turns that into a ``with_sharding_constraint``
under the active logical → mesh rules; the port runs every shard on one
card, so :func:`shard` resolves the partition spec (a spec longer than
the tensor, or one that names a mesh axis twice, raises, as the
constraint would) and returns ``x`` itself. With no context it is a
no-op, as in the reference.

What a mesh context does change is the MoE dispatch: under one whose
``"experts"`` rule resolves, ``moe.moe_apply(impl="auto")`` takes the
owner-computes path (``moe.moe_apply_owner``).

Rules are swappable per input shape: ``long_context_rules()`` turns off
batch sharding (batch=1) and shards KV-cache sequence dims over
``(data, model)`` instead.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Mapping

from .params import LOGICAL_RULES, logical_to_spec

__all__ = ["use_mesh_rules", "shard", "active_mesh_rules",
           "default_rules", "long_context_rules"]

_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh_rules", default=None)


def default_rules() -> dict[str, Any]:
    return dict(LOGICAL_RULES)


def long_context_rules() -> dict[str, Any]:
    """batch=1 long-context serving: shard sequence, not batch."""
    rules = dict(LOGICAL_RULES)
    rules.update({
        "batch": None,
        "batch_nopod": None,
        # decode activations have seq-len 1 — only the KV caches carry the
        # long dimension, sharded over the whole mesh:
        "seq_shard": ("data", "model"),
        "act_heads": None,              # heads follow seq-sharded KV instead
    })
    return rules


@contextlib.contextmanager
def use_mesh_rules(mesh, rules: Mapping[str, Any] | None = None):
    """Within the block, ``(mesh, rules)`` is the active context (rules
    default to :func:`default_rules`); ``mesh=None`` clears it."""
    token = _CTX.set((mesh, rules or default_rules()) if mesh else None)
    try:
        yield
    finally:
        _CTX.reset(token)


def active_mesh_rules():
    """The active ``(mesh, rules)``, or ``None``."""
    return _CTX.get()


def shard(x, *axes):
    """``x``, after resolving its partition spec under the active context
    (none: nothing is resolved)."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    if len(axes) > x.ndim:
        raise ValueError(f"shard: {len(axes)} logical axes {axes} for a "
                         f"tensor of {x.ndim} dimensions")
    mesh, rules = ctx
    used = [a for e in logical_to_spec(axes, rules, mesh) if e is not None
            for a in (e if isinstance(e, tuple) else (e,))]
    if len(used) != len(set(used)):
        raise ValueError(f"shard: logical axes {axes} name a mesh axis "
                         f"twice: {used}")
    return x
