"""Plain CP-ALS reference for the benchmark: one sweep of paper Alg. 1.

Plain PyTorch on the COO tensor the benchmark made, in natural row order
and in float64. It imports nothing of the program: the row order, the
initial factors and every sweep are worked out here again.

* :func:`row_slots` is FLYCOO's row order on one worker: the super-shards
  of a mode, kept in order on the one worker, put natural row ``r`` at
  slot ``r``; the slots past ``I_n`` are padding and hold zeros.
* :func:`initial_factors` draws the factors as the program's public
  recipe does: natural rows of mode ``n`` from
  ``numpy.random.default_rng(seed * 1000 + n).standard_normal``, float32.
* :func:`sweep` is one ALS sweep: per mode the MTTKRP, the solve against
  the Hadamard product of the other modes' grams (ridge ``1e-9``), the
  column normalisation (2-norm on the first sweep, else the column's
  largest magnitude floored at 1), and the fit from the sparse-CP
  identity with the last mode's pre-solve MTTKRP.

``tf32=True`` is the control: float32, and every matrix product takes its
operands rounded to TF32 as the tensor cores read a float32 register
(the low 13 mantissa bits dropped), with float32 sums.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

RIDGE = 1e-9
# Nonzeros per block of the MTTKRP: bounds the gathered rows it holds.
BLOCK = 1 << 23


class Sweep(NamedTuple):
    """One sweep's results, natural row order."""

    mttkrp: list        # per mode, the pre-solve MTTKRP (I_n, R)
    factors: list       # per mode, the normalised factor (I_n, R)
    lam: torch.Tensor   # (R,) the last mode's column norms
    fit: float


def row_slots(dim: int) -> torch.Tensor:
    """Slot of each natural row of a mode on one worker: the identity."""
    return torch.arange(dim)


def initial_factors(shape, rank: int, seed: int) -> list:
    """The natural-order float32 initial factors, host numpy."""
    return [np.random.default_rng(seed * 1000 + n)
            .standard_normal((dim, rank)).astype(np.float32)
            for n, dim in enumerate(shape)]


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``x`` with its low 13 mantissa bits dropped."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return (bits & -8192).view(torch.float32)


def matmul(a, b, tf32: bool):
    return to_tf32(a) @ to_tf32(b) if tf32 else a @ b


def mttkrp(indices, values, factors, mode: int, dtype) -> torch.Tensor:
    """``M[i, :] = Σ_{x: x_mode = i} v_x ⊙_{w≠mode} A_w[x_w, :]``."""
    rows, rank = factors[mode].shape
    out = torch.zeros((rows, rank), dtype=dtype, device=values.device)
    for lo in range(0, values.shape[0], BLOCK):
        idx = indices[lo:lo + BLOCK].long()
        prod = values[lo:lo + BLOCK, None].to(dtype)
        for w, f in enumerate(factors):
            if w != mode:
                prod = prod * f[idx[:, w]]
        out.index_add_(0, idx[:, mode], prod)
        del idx, prod
    return out


def _normalize(A, sweep0: bool):
    if sweep0:
        norms = torch.linalg.norm(A, dim=0)
    else:
        norms = torch.clamp(A.abs().max(dim=0).values, min=1.0)
    norms = torch.where(norms == 0, torch.ones_like(norms), norms)
    return A / norms, norms


def sweep(indices, values, factors, *, sweep0: bool, tf32: bool = False,
          follow=None) -> Sweep:
    """One ALS sweep from ``factors`` (natural order, any float type).

    float64 throughout, or float32 with TF32 products for ``tf32``.
    ``follow`` (per mode a factor, natural order) steps along another
    run's sweep: each mode's MTTKRP and solve are worked out from that
    run's factors of the modes before it, and ``follow[n]`` then stands
    for mode ``n``, so no error carries from one mode to the next. The
    fit is then that of ``follow``'s factors with this sweep's λ and last
    MTTKRP."""
    dtype = torch.float32 if tf32 else torch.float64
    factors = [f.to(dtype) for f in factors]
    grams = [matmul(f.T, f, tf32) for f in factors]
    rank = factors[0].shape[1]
    eye = torch.eye(rank, dtype=dtype, device=values.device)
    outs, mine, A, lam = [], [], None, None
    for n in range(len(factors)):
        M = mttkrp(indices, values, factors, n, dtype)
        V = torch.ones((rank, rank), dtype=dtype, device=values.device)
        for w, g in enumerate(grams):
            if w != n:
                V = V * g
        A = torch.linalg.solve(V + RIDGE * eye, M.T).T
        A, lam = _normalize(A, sweep0)
        mine.append(A)
        if follow is not None:
            A = follow[n].to(dtype)
        factors[n] = A
        grams[n] = matmul(A.T, A, tf32)
        outs.append(M)
    x_norm_sq = torch.sum(values.to(torch.float64) ** 2).to(dtype)
    inner = torch.sum(matmul(outs[-1].T, A, tf32).diagonal() * lam)
    G = torch.ones((rank, rank), dtype=dtype, device=values.device)
    for g in grams:
        G = G * g
    model_sq = lam @ matmul(G, lam[:, None], tf32)[:, 0]
    resid_sq = torch.clamp(x_norm_sq - 2.0 * inner + model_sq, min=0.0)
    fit = 1.0 - torch.sqrt(resid_sq) / torch.sqrt(x_norm_sq)
    return Sweep(outs, mine, lam, float(fit))


def lexsort_rows(indices: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts ``(nnz, N)`` coordinates
    lexicographically (mode 0 first), by stable sorts from the last mode
    to the first."""
    order = torch.arange(indices.shape[0], device=indices.device)
    for n in reversed(range(indices.shape[1])):
        key = indices[order, n].long()
        order = order[torch.sort(key, stable=True).indices]
    return order
