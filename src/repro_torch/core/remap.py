"""Dynamic tensor remapping (paper §III-B, Alg. 2 line 27), in PyTorch.

Port of ``repro/core/remap.py``. Every nonzero is bucketed by the worker
that owns its next-mode output row, the buckets are exchanged, and each
worker compacts what it received into next-mode row order. All shapes
are static (capacity-padded), and the operations are the reference's
one for one — stable sorts, the same tie-breaks — so the integer results
are equal to it exactly. The reference bit-casts coordinates and values
into one float payload; here they travel as separate tensors, each
permuted by the same order.

Only one worker is ported: :func:`exchange` is the identity at D=1 and
raises for D>1 (ROADMAP A9, the multi-GPU all_to_all).
"""
from __future__ import annotations

import numpy as np
import torch

from .flycoo import FlycooTensor

__all__ = [
    "remap_capacities",
    "bucket_by_destination",
    "exchange",
    "compact_sorted",
]


def remap_capacities(ft: FlycooTensor) -> list[int]:
    """Per-transition max (src, dst) exchange sizes, mode n → n+1 (cyclic)."""
    D = ft.params.num_workers
    caps = []
    for n in range(ft.nmodes):
        nxt = (n + 1) % ft.nmodes
        src = ft.owner_of(n).astype(np.int64)
        dst = ft.owner_of(nxt).astype(np.int64)
        counts = np.bincount(src * D + dst, minlength=D * D)
        caps.append(max(1, int(counts.max())))
    return caps


def bucket_by_destination(dest, payloads, num_devices: int,
                          bucket_cap: int):
    """Scatter element rows into per-destination buckets (static shape).

    Args:
      dest: ``(n,)`` int32 destination worker per element; ``>=
        num_devices`` marks padding/invalid elements.
      payloads: tuple of ``(n, ...)`` element data (coordinates, values),
        kept as separate tensors and permuted alike.
      num_devices: D.
      bucket_cap: per-destination capacity B.

    Returns ``(buckets, bucket_mask[(D, B)], dropped)``: ``buckets`` holds
    one ``(D, B, ...)`` tensor per payload, ``dropped`` counts the valid
    elements that exceeded capacity.
    """
    n = dest.shape[0]
    order = torch.sort(dest, stable=True).indices
    dest_s = dest[order]
    # Position of each element inside its destination bucket.
    start = torch.searchsorted(dest_s, dest_s, side="left", out_int32=True)
    pos = torch.arange(n, dtype=dest.dtype, device=dest.device) \
        - start.to(dest.dtype)
    ok = (dest_s < num_devices) & (pos < bucket_cap)
    slot = torch.where(ok, dest_s * bucket_cap + pos,
                       num_devices * bucket_cap).long()
    dump = num_devices * bucket_cap + 1
    buckets = []
    for x in payloads:
        flat = torch.zeros((dump,) + tuple(x.shape[1:]), dtype=x.dtype,
                           device=x.device)
        flat[slot] = x[order]
        buckets.append(flat[:-1].reshape(
            (num_devices, bucket_cap) + tuple(x.shape[1:])))
    maskf = torch.zeros(dump, dtype=torch.bool, device=dest.device)
    maskf[slot] = ok
    dropped = torch.sum((dest_s < num_devices) & ~ok)
    return (tuple(buckets), maskf[:-1].reshape(num_devices, bucket_cap),
            dropped)


def exchange(buckets, bucket_mask, num_devices: int):
    """Exchange the buckets (a tuple of ``(D, B, ...)`` tensors): entry
    ``[d]`` goes to worker ``d``. At one worker every bucket stays where
    it is.
    """
    if num_devices != 1:
        raise NotImplementedError(
            "the multi-GPU all_to_all is not ported yet (ROADMAP A9); "
            "the port runs one worker")
    return buckets, bucket_mask


def compact_sorted(payloads, mask_flat, sort_key, out_cap: int):
    """Compact valid elements, sorted by ``sort_key``, into ``out_cap`` rows.

    ``payloads`` is a tuple of ``(n, ...)`` tensors, permuted alike.
    Invalid entries sort last (key forced to the dtype's max) and are
    truncated; the caller guarantees ``valid_count <= out_cap``. Returns
    ``(payloads', mask[(out_cap,)])``.
    """
    big = torch.iinfo(sort_key.dtype).max
    key = torch.where(mask_flat, sort_key, big)
    order = torch.sort(key, stable=True).indices[:out_cap]
    return tuple(x[order] for x in payloads), mask_flat[order]
