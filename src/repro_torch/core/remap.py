"""Dynamic tensor remapping (paper §III-B, Alg. 2 line 27), in PyTorch.

Port of ``repro/core/remap.py``. Every nonzero is bucketed by the worker
that owns its next-mode output row (:func:`bucket_by_destination`), the
buckets are exchanged (:func:`exchange`, the all_to_all of
``core.workers``), and each worker compacts what it received into
next-mode row order (:func:`compact_sorted`). All shapes are static
(capacity-padded: :func:`remap_capacities`), storage stays ``2·|T|``
(send and receive buckets), and the operations are the reference's one
for one — stable sorts, the same tie-breaks — so the integer results are
equal to it exactly. The reference bit-casts coordinates and values into
one float payload; here they travel as separate tensors, each permuted by
the same order. :func:`remap_local` is the layout oracle.
"""
from __future__ import annotations

import numpy as np
import torch

from .flycoo import FlycooTensor, pack_mode

__all__ = [
    "remap_capacity",
    "remap_capacities",
    "bucket_by_destination",
    "exchange",
    "compact_sorted",
    "remap_local",
]


def remap_capacities(ft: FlycooTensor) -> list[int]:
    """Per-transition max (src, dst) exchange sizes, mode n → n+1 (cyclic)."""
    D = ft.params.num_workers
    if D == 1:                          # one worker sends itself everything
        return [max(1, ft.nnz)] * ft.nmodes
    owners = [ft.owner_of(n).astype(np.int64) for n in range(ft.nmodes)]
    caps = []
    for n in range(ft.nmodes):
        src, dst = owners[n], owners[(n + 1) % ft.nmodes]
        counts = np.bincount(src * D + dst, minlength=D * D)
        caps.append(max(1, int(counts.max())))
    return caps


def remap_capacity(ft: FlycooTensor) -> int:
    """Max nonzeros any (src, dst) pair exchanges over all mode transitions:
    the static bound of a uniform exchange buffer."""
    return max(remap_capacities(ft))


def _take(x, order):
    """``x`` permuted along the axis after ``order``'s leading (worker)
    axes: row ``b`` of the result is ``x[b][order[b]]``."""
    lead = order.shape[:-1]
    b, m = int(np.prod(lead, dtype=np.int64)), order.shape[-1]
    tail = tuple(x.shape[len(lead) + 1:])
    x2 = x.reshape((b, x.shape[len(lead)]) + tail)
    o2 = order.reshape((b, m) + (1,) * len(tail)).expand((b, m) + tail)
    return torch.gather(x2, 1, o2).reshape(lead + (m,) + tail)


def bucket_by_destination(dest, payloads, num_devices: int,
                          bucket_cap: int):
    """Scatter element rows into per-destination buckets (static shape).

    Args:
      dest: ``(..., n)`` int32 destination worker per element; ``>=
        num_devices`` marks padding/invalid elements. Leading axes (the
        workers a process holds) are bucketed each on their own.
      payloads: tuple of ``(..., n, ...)`` element data (coordinates,
        values), kept as separate tensors and permuted alike.
      num_devices: D.
      bucket_cap: per-destination capacity B.

    Returns ``(buckets, bucket_mask[(..., D, B)], dropped[(...)])``:
    ``buckets`` holds one ``(..., D, B, ...)`` tensor per payload,
    ``dropped`` counts the valid elements that exceeded capacity.
    """
    lead, n = dest.shape[:-1], dest.shape[-1]
    b = int(np.prod(lead, dtype=np.int64))
    dest_s, order = torch.sort(dest.reshape(b, n), dim=-1, stable=True)
    # Position of each element inside its destination bucket.
    start = torch.searchsorted(dest_s, dest_s, side="left", out_int32=True)
    pos = torch.arange(n, dtype=dest.dtype, device=dest.device) \
        - start.to(dest.dtype)
    ok = (dest_s < num_devices) & (pos < bucket_cap)
    dump = num_devices * bucket_cap + 1
    # Each leading row scatters into its own dump-sized block; the last
    # slot of a block takes the invalid and overflowing elements.
    base = torch.arange(b, device=dest.device)[:, None] * dump
    slot = (torch.where(ok, dest_s * bucket_cap + pos,
                        num_devices * bucket_cap) + base).reshape(-1)
    order = order.reshape(lead + (n,))

    def scatter(x):
        tail = tuple(x.shape[1:])
        flat = torch.zeros((b * dump,) + tail, dtype=x.dtype, device=x.device)
        flat[slot] = x
        return flat.reshape((b, dump) + tail)[:, :-1].reshape(
            lead + (num_devices, bucket_cap) + tail)

    buckets = tuple(scatter(_take(x, order).reshape((b * n,) + tuple(
        x.shape[len(lead) + 1:]))) for x in payloads)
    dropped = torch.sum((dest_s < num_devices) & ~ok, dim=-1).reshape(lead)
    return buckets, scatter(ok.reshape(-1)), dropped


def exchange(buckets, bucket_mask, workers):
    """all_to_all the buckets through ``workers`` (``core.workers``).

    ``buckets`` is a tuple of ``(L, D, B, ...)`` tensors and
    ``bucket_mask`` ``(L, D, B)``, over the ``L`` workers this process
    holds: entry ``[l, d]`` goes to worker ``d``. Returns the received
    buckets and mask in the same shapes, entry ``[l, s]`` being what
    source ``s`` sent to local worker ``l``.
    """
    return (tuple(workers.all_to_all(b) for b in buckets),
            workers.all_to_all(bucket_mask))


def compact_sorted(payloads, mask_flat, sort_key, out_cap: int):
    """Compact valid elements, sorted by ``sort_key``, into ``out_cap`` rows.

    ``payloads`` is a tuple of ``(..., n, ...)`` tensors, permuted alike;
    ``mask_flat`` and ``sort_key`` are ``(..., n)``, and each leading row
    (a worker) is compacted on its own. Invalid entries sort last (key
    forced to the dtype's max) and are truncated; the caller guarantees
    ``valid_count <= out_cap``. Returns ``(payloads', mask[(..., out_cap)])``.
    """
    big = torch.iinfo(sort_key.dtype).max
    key = torch.where(mask_flat, sort_key, big)
    order = torch.sort(key, dim=-1, stable=True).indices[..., :out_cap]
    return tuple(_take(x, order) for x in payloads), _take(mask_flat, order)


def remap_local(ft: FlycooTensor, to_mode: int):
    """Single-worker reference remap (numpy): the post-remap layout oracle.

    The remap of any layout into ``to_mode`` holds the nonzeros of
    ``pack_mode(ft, to_mode)`` on the same workers, in the same output
    rows, so the oracle *is* ``pack_mode(ft, to_mode)``: it takes no
    source layout, as in the reference.
    """
    return pack_mode(ft, to_mode)
