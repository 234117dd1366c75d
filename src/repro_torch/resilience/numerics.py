"""Numerical guards for the CP-ALS normal-equations solve.

Port of ``repro/resilience/numerics.py``. ``A_n <- M_n V^+`` with ``V``
the Hadamard product of the other modes' grams is the one numerically
fragile step of CP-ALS. :func:`guarded_solve` is the escalation ladder:

  0. **clean** — ``solve(V + ridge·I, Mᵀ)ᵀ``, exactly the unguarded solve;
  1. **ridge** — non-finite input/solution or a degenerate gram diagonal:
     re-solve with an escalated, scale-aware ridge
     (``escalated_scale · max|diag V|``);
  2. **lstsq** — still non-finite: minimum-norm least squares via the
     pseudo-inverse, with non-finite inputs zeroed first.

The JAX version branches with ``lax.cond``; here the branch is host-side
Python, which reads one flag from the device per decision. A solve runs
through ``torch.linalg.solve_ex``: an exactly singular system reports
failure instead of raising, and counts as non-finite, where JAX's LU
returns inf/NaN.
"""
from __future__ import annotations

import torch

__all__ = ["GUARD_LEVELS", "guarded_solve"]

# Index == the level guarded_solve returns.
GUARD_LEVELS = ("clean", "ridge", "lstsq")


def _solve(A, M):
    """``(solve(A, Mᵀ)ᵀ, finite)``; ``finite`` (a 0-d bool tensor) is
    False on a singular ``A``."""
    X, info = torch.linalg.solve_ex(A, M.T)
    return X.T, (info == 0) & torch.isfinite(X).all()


def guarded_solve(V, M, *, ridge: float = 1e-9,
                  escalated_scale: float = 1e-6,
                  diag_rtol: float = 1e-12):
    """Solve ``X Vᵀ = M`` (V symmetric) with escalating regularization.

    Returns ``(X, level)`` — ``X`` shaped like ``M``, ``level`` an int
    indexing :data:`GUARD_LEVELS`.
    """
    R = V.shape[0]
    eye = torch.eye(R, dtype=M.dtype, device=M.device)
    finite_in = torch.isfinite(V).all() & torch.isfinite(M).all()
    Vc = torch.where(torch.isfinite(V), V, 0.0)
    Mc = torch.where(torch.isfinite(M), M, 0.0)
    d = torch.diagonal(Vc)
    scale = torch.clamp(torch.max(torch.abs(d)), min=1.0)
    # V is a Hadamard product of PSD grams: a ~zero diagonal entry means
    # a collapsed factor column — the cheap, conservative ill-condition
    # signal (no SVD on the hot path).
    illcond = torch.min(d) <= diag_rtol * scale

    X0, ok0 = _solve(Vc + ridge * eye, Mc)
    if bool(finite_in & ~illcond & ok0):   # the one host read when healthy
        return X0, 0
    X1, ok1 = _solve(Vc + escalated_scale * scale * eye, Mc)
    if bool(ok1):
        return X1, 1
    X2 = (torch.linalg.pinv(Vc, rtol=1e-10) @ Mc.T).T
    return torch.where(torch.isfinite(X2), X2, 0.0), 2
