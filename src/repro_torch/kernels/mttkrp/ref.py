"""Plain PyTorch oracles of the blocked MTTKRP scatter (``index_add_``).

Port of ``repro/kernels/mttkrp/ref.py``.
"""
from __future__ import annotations

import torch

__all__ = ["segment_accumulate_ref", "fused_mttkrp_ref"]


def segment_accumulate_ref(contrib, local_row, rows_cap: int):
    """``out[r] = Σ_{i: local_row[i]==r} contrib[i]`` — the scatter stage.

    Args:
      contrib: ``(nnz, R)`` per-nonzero contribution; padding rows must be
        exactly zero.
      local_row: ``(nnz,)`` integer output row per nonzero.
      rows_cap: number of output rows.
    """
    out = torch.zeros((rows_cap,) + tuple(contrib.shape[1:]),
                      dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, local_row.long(), contrib)


def fused_mttkrp_ref(vals, rows_list, local_row, rows_cap: int):
    """Fused Hadamard + scatter oracle: ``out[r] += vals[i] * ⊙_w rows_w[i]``."""
    ell = vals[:, None].to(rows_list[0].dtype)
    for rows in rows_list:
        ell = ell * rows
    return segment_accumulate_ref(ell.float(), local_row, rows_cap)
