"""LM substrate of the port: serving and training of all six families
(dense, MoE, SSM, hybrid, enc-dec, VLM).

Port of ``repro.models`` (ROADMAP A15, slices 1 and 2, and (3) (a)-(d2)):
``params`` (specs, a per-leaf seeded init, the logical → mesh rules and
abstract trees), ``sharding`` (the mesh-rules context and ``shard``),
``layers`` (RMSNorm, RoPE, SwiGLU), ``attention`` (the online-softmax
recurrence, one-token decode, the int8 KV cache), ``moe`` (the
sort-into-buckets expert dispatch, gather and owner-computes), ``ssm`` (the
chunked Mamba2 SSD and its O(1) decode), ``blocks`` (the ``attn`` /
``attn_local`` / ``xattn`` / ``attn_cross`` / ``mamba`` mixers with the
``mlp`` / ``moe`` FFNs), ``model`` (the encoder and image memory, forward
with activation checkpointing / prefill / decode_step) and ``steps`` (the
loss, its gradients, the train step, the serving step factories and
the abstract input and state specs).
"""
from . import (attention, blocks, layers, model, moe, params, sharding, ssm,
               steps)

__all__ = ["attention", "blocks", "layers", "model", "moe", "params",
           "sharding", "ssm", "steps"]
