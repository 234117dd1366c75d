"""Single-device spMTTKRP engines: the port's oracles.

Port of ``repro/core/mttkrp.py``:
  1. :func:`mttkrp_elementwise_ref` — literal per-nonzero loop (paper
     Fig. 1 / Eq. 4), numpy, tests only.
  2. :func:`mttkrp` / :func:`mttkrp_sorted` — gather input factor rows
     (``index_select``), Hadamard-product them, scale by the value and
     ``index_add_`` into the output rows.
"""
from __future__ import annotations

import numpy as np

from ..kernels.mttkrp.ref import segment_accumulate_ref

__all__ = [
    "mttkrp_elementwise_ref",
    "hadamard_rows",
    "mttkrp",
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
            ell = ell * factors[w].index_select(0, indices[:, w].long())
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
