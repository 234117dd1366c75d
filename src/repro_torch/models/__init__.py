"""LM substrate of the port: serving of the dense, MoE, SSM and hybrid
families, training of the dense family.

Port of ``repro.models`` (ROADMAP A15, slices 1 and 2, and the serving
part of (3)): ``params`` (specs and a per-leaf seeded init), ``layers``
(RMSNorm, RoPE, SwiGLU), ``attention`` (the online-softmax recurrence and
one-token decode), ``moe`` (the sort-into-buckets expert dispatch),
``ssm`` (the chunked Mamba2 SSD and its O(1) decode), ``blocks`` (the
``attn`` / ``attn_local`` / ``mamba`` mixers with the ``mlp`` / ``moe``
FFNs), ``model`` (forward with activation checkpointing / prefill /
decode_step) and ``steps`` (the loss, its gradients, the train step and
the serving step factories). ``sharding`` comes with the mesh.
"""
from . import attention, blocks, layers, model, moe, params, ssm, steps

__all__ = ["attention", "blocks", "layers", "model", "moe", "params", "ssm",
           "steps"]
