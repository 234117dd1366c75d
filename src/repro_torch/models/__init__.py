"""LM substrate of the port: serving and training of all six families
(dense, MoE, SSM, hybrid, enc-dec, VLM).

Port of ``repro.models`` (ROADMAP A15, slices 1 and 2, and (3) (a) and
(b)): ``params`` (specs and a per-leaf seeded init), ``layers`` (RMSNorm,
RoPE, SwiGLU), ``attention`` (the online-softmax recurrence and one-token
decode), ``moe`` (the sort-into-buckets expert dispatch), ``ssm`` (the
chunked Mamba2 SSD and its O(1) decode), ``blocks`` (the ``attn`` /
``attn_local`` / ``xattn`` / ``attn_cross`` / ``mamba`` mixers with the
``mlp`` / ``moe`` FFNs), ``model`` (the encoder and image memory, forward
with activation checkpointing / prefill / decode_step) and ``steps`` (the
loss, its gradients, the train step and the serving step factories).
``sharding`` and the int8 KV cache come with ROADMAP A15 (3) (c) and (d).
"""
from . import attention, blocks, layers, model, moe, params, ssm, steps

__all__ = ["attention", "blocks", "layers", "model", "moe", "params", "ssm",
           "steps"]
