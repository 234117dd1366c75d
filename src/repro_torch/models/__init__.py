"""LM substrate of the port: the dense family's serving and training.

Port of ``repro.models`` (ROADMAP A15, slices 1 and 2): ``params`` (specs
and a per-leaf seeded init), ``layers`` (RMSNorm, RoPE, SwiGLU),
``attention`` (the online-softmax recurrence and one-token decode),
``blocks`` (the ``attn+mlp`` block), ``model`` (forward with activation
checkpointing / prefill / decode_step) and ``steps`` (the loss, its
gradients, the train step and the serving step factories). ``moe``,
``ssm`` and ``sharding`` come with slice 3.
"""
from . import attention, blocks, layers, model, params, steps

__all__ = ["attention", "blocks", "layers", "model", "params", "steps"]
