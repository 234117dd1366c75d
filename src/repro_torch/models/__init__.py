"""LM substrate of the port: the dense family's serving path.

Port of ``repro.models`` (ROADMAP A15, slice 1): ``params`` (specs and a
per-leaf seeded init), ``layers`` (RMSNorm, RoPE, SwiGLU), ``attention``
(the online-softmax recurrence and one-token decode), ``blocks`` (the
``attn+mlp`` block), ``model`` (forward / prefill / decode_step) and
``steps`` (the serving step factories). ``moe``, ``ssm`` and ``sharding``
come with slice 3.
"""
from . import attention, blocks, layers, model, params, steps

__all__ = ["attention", "blocks", "layers", "model", "params", "steps"]
