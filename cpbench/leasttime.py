"""The least time a sweep of CP-ALS can take on the card, from the tensor
alone, whatever implements it.

Per mode ``n`` the MTTKRP has to read every nonzero once (``N`` 4-byte
indices and a 4-byte value), each input factor once (``I_m * R * 4``
bytes, ``m != n``) and write its output once (``I_n * R * 4``), and it
does ``N * R`` fp32 operations per nonzero (``N - 1`` products and one
sum per column). A sweep is the sum over its modes; the solves and the
remap add nothing here, so the bound is the MTTKRP's.
"""
from __future__ import annotations

# Published peaks of the card (data sheet, SXM part, dense, 700 W).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flops_per_s": 67e12},
}


def sweep_work(shape, nnz: int, rank: int) -> tuple[int, int]:
    """``(bytes, fp32 operations)`` of one sweep's MTTKRPs."""
    nmodes = len(shape)
    rows = sum(shape)
    nbytes = nmodes * (nnz * (nmodes * 4 + 4) + rows * rank * 4)
    flops = nmodes * nnz * rank * nmodes
    return nbytes, flops


def least_seconds(shape, nnz: int, rank: int, kind: str):
    """``(seconds, "bytes" | "operations")`` for one sweep on ``kind``,
    or ``None`` for a card the table does not know."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    nbytes, flops = sweep_work(shape, nnz, rank)
    t_bytes = nbytes / peak["hbm_bytes_per_s"]
    t_ops = flops / peak["fp32_flops_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
