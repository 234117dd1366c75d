"""Single-device spMTTKRP engines: the port's oracles.

Port of ``repro/core/mttkrp.py``:
  1. :func:`mttkrp_elementwise_ref` — literal per-nonzero loop (paper
     Fig. 1 / Eq. 4), numpy, tests only.
  2. :func:`mttkrp` / :func:`mttkrp_sorted` — gather input factor rows
     (``index_select``), Hadamard-product them, scale by the value and
     ``index_add_`` into the output rows.
  3. :func:`mttkrp_fused` — one device, through the kernels' mode step
     (``kernels.mttkrp.ops.mttkrp_device_step``), in fp32 or with bf16
     gathers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.mttkrp.ref import segment_accumulate_ref

__all__ = [
    "mttkrp_elementwise_ref",
    "hadamard_rows",
    "mttkrp",
    "mttkrp_fused",
    "mttkrp_sorted",
]


def mttkrp_elementwise_ref(indices, values, factors, mode, out_rows=None):
    """Literal Alg. 2 inner loop in numpy (lines 13-25). Tests only."""
    indices = np.asarray(indices)
    values = np.asarray(values)
    nmodes = indices.shape[1]
    rank = factors[0].shape[1]
    out_rows = out_rows if out_rows is not None else factors[mode].shape[0]
    out = np.zeros((out_rows, rank), dtype=np.float64)
    for i in range(len(values)):
        ell = np.ones(rank, dtype=np.float64)
        for w in range(nmodes):
            if w == mode:
                continue
            ell *= np.asarray(factors[w])[indices[i, w]].astype(np.float64)
        out[indices[i, mode]] += float(values[i]) * ell
    return out


def hadamard_rows(indices, values, factors, mode):
    """``value · ⊙_{w≠mode} Y_w[c_w]`` for every nonzero → ``(nnz, R)``."""
    ell = values[:, None].to(factors[0].dtype)
    for w in range(indices.shape[1]):
        if w != mode:
            # int32 indices go to index_select as they are: on an H100 an
            # int64 index sent this (N, 16) row gather down a path ~13x
            # slower at nell-2 scale (PERF.md).
            ix = indices[:, w]
            if ix.dtype not in (torch.int32, torch.int64):
                ix = ix.long()
            ell = ell * factors[w].index_select(0, ix)
    return ell


def mttkrp(indices, values, factors, mode: int, out_rows: int):
    """Vectorized spMTTKRP for one mode (nonzeros in any order)."""
    return segment_accumulate_ref(hadamard_rows(indices, values, factors,
                                                mode),
                                  indices[:, mode], out_rows)


def mttkrp_sorted(indices, values, factors, mode: int, out_rows: int):
    """spMTTKRP for nonzeros pre-sorted by output row (FLYCOO layout).

    ``index_add_`` does not use the order; the function is kept for the
    reference's API.
    """
    return mttkrp(indices, values, factors, mode, out_rows)


def mttkrp_fused(indices, values, factors, mode: int, out_rows: int, *,
                 blk: int = 512, tile_rows: int = 8, backend: str = "auto",
                 gather_dtype: str = "float32"):
    """Single-device spMTTKRP through the kernels' mode step.

    Sorts the nonzeros by output row (stable, the FLYCOO precondition),
    rounds the output up to whole row tiles and runs
    ``ops.mttkrp_device_step`` with ``backend`` (``auto``: the residency
    ladder) on the device that holds the tensors. ``gather_dtype=
    "bfloat16"`` makes the fused family gather bf16 factor rows (fp32
    products and sums). Returns ``(out_rows, R)`` float32.
    """
    from ..kernels.mttkrp import ops as kops  # deferred: ops imports this
    order = torch.argsort(indices[:, mode], stable=True)
    idx = indices[order].to(torch.int32)
    val = values[order]
    valid = torch.ones(val.shape, dtype=torch.bool, device=val.device)
    rows_cap = -(-out_rows // tile_rows) * tile_rows
    out = kops.mttkrp_device_step(
        idx, val, valid, list(factors), mode=mode, rows_cap=rows_cap,
        row_offset=0, blk=blk, tile_rows=tile_rows, backend=backend,
        gather_dtype=gather_dtype)
    return out[:out_rows]
