"""CP-ALS (paper Alg. 1) on top of the port's spMTTKRP engines.

Port of ``repro/core/cpals.py``. Two drivers, one algorithm:

* :func:`cp_als` — single-device reference (``index_add_`` MTTKRP), the
  correctness oracle.
* :func:`cp_als_distributed` — the Dynasor path on one GPU: FLYCOO
  layout, per mode the owner-computes MTTKRP (the in-kernel-gather CUDA
  kernels with ``backend="pallas_fused_gather"`` or ``"..._tiled"``, the
  out-of-core stream kernel with ``"pallas_fused_gather_stream"``),
  guarded solve, column normalization and the remap into the next mode's
  order. :func:`als_sweep` is one sweep, the math of the reference's
  ``make_als_sweep`` at one worker.

Both run on CUDA unless the caller passes ``device="cpu"``.

Fit = 1 - ||X - X̂||_F / ||X||_F from the sparse-CP identity (SPLATT):
||X̂||² = 1λᵀ(⊛_w Gramᵂ)λ1 and <X, X̂> = Σ_r λ_r Σ_i M_last[i,r]·A_last[i,r],
with ``M_last`` the last mode's pre-solve MTTKRP output.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.mttkrp import ops as kops
from ..resilience import numerics as _numerics
from ..runtime.device import resolve_device
from . import distributed as dist
from .flycoo import FlycooTensor
from .mttkrp import mttkrp

__all__ = ["CPResult", "SweepResult", "als_sweep", "cp_als",
           "cp_als_distributed", "device_state", "fit_from_parts"]


@dataclasses.dataclass
class CPResult:
    """Decomposition [[λ; A_0 … A_{N-1}]] + convergence trace."""

    factors: list[np.ndarray]   # natural row space, (I_n, R) each
    lam: np.ndarray             # (R,) column weights
    fits: list[float]           # fit after each ALS sweep
    iters: int
    # Host seconds of each sweep, ending when its fit reached the host.
    sweep_seconds: list[float] = dataclasses.field(default_factory=list)

    @property
    def fit(self) -> float:
        return self.fits[-1] if self.fits else float("nan")


class SweepResult(NamedTuple):
    """What one :func:`als_sweep` returns."""

    stream: tuple               # (idx, val, mask) back in mode-0 order
    factors: list               # (i_pad_n, R) factors, permuted row space
    lam: torch.Tensor           # (R,)
    fit: torch.Tensor           # 0-d
    mttkrp: list                # per-mode pre-solve MTTKRP (rows_cap_n, R)


def _normalize_columns(A, sweep0: bool):
    """Column-normalize; first sweep uses 2-norm, later sweeps max-norm
    (standard CP-ALS practice — keeps λ from oscillating)."""
    if sweep0:
        norms = torch.linalg.norm(A, dim=0)
    else:
        norms = torch.clamp(torch.max(torch.abs(A), dim=0).values, min=1.0)
    norms = torch.where(norms == 0, 1.0, norms)
    return A / norms, norms


def _solve_v_guarded(grams, mode: int, M, ridge: float = 1e-9):
    """A_n ← M_n · V⁺ with V = ⊛_{w≠n} G_w — guarded; returns (A, level)."""
    R = M.shape[1]
    V = torch.ones((R, R), dtype=M.dtype, device=M.device)
    for w, G in enumerate(grams):
        if w != mode:
            V = V * G
    return _numerics.guarded_solve(V, M, ridge=ridge)


def _solve_v(grams, mode: int, M, ridge: float = 1e-9):
    """A_n ← M_n · V⁺ with V = ⊛_{w≠n} G_w (Hadamard of grams)."""
    X, _level = _solve_v_guarded(grams, mode, M, ridge=ridge)
    return X


def fit_from_parts(x_norm_sq, lam, grams, M_last, A_last):
    """Sparse-CP fit from the identity above (no reconstruction)."""
    R = lam.shape[0]
    G = torch.ones((R, R), dtype=M_last.dtype, device=M_last.device)
    for g in grams:
        G = G * g
    model_norm_sq = torch.einsum("r,rs,s->", lam, G, lam)
    inner = torch.einsum("ir,ir,r->", M_last, A_last, lam)
    resid_sq = torch.clamp(x_norm_sq - 2.0 * inner + model_norm_sq, min=0.0)
    return 1.0 - torch.sqrt(resid_sq) / torch.sqrt(x_norm_sq)


# ---------------------------------------------------------------------------
# Single-device reference driver
# ---------------------------------------------------------------------------

def _sweep(indices, values, factors, lam, shape, sweep0: bool):
    factors = list(factors)
    grams = [f.T @ f for f in factors]
    M = None
    for n in range(len(shape)):
        M = mttkrp(indices, values, factors, n, shape[n])
        A = _solve_v(grams, n, M)
        A, norms = _normalize_columns(A, sweep0)
        factors[n] = A
        grams[n] = A.T @ A
        lam = norms
    x_norm_sq = torch.sum(values.to(torch.float32) ** 2)
    fit = fit_from_parts(x_norm_sq, lam, grams, M, factors[-1])
    return factors, lam, fit


def cp_als(tensor, rank: int, *, device=None, iters: int = 10, seed: int = 0,
           tol: float = 1e-5) -> CPResult:
    """Single-device CP-ALS (paper Alg. 1) — the correctness oracle.

    Factors start from ``numpy.random.default_rng(seed)`` as in the
    reference, so both packages start from the same numbers.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    factors = [torch.as_tensor(rng.standard_normal((d, rank)),
                               dtype=torch.float32).to(dev)
               for d in tensor.shape]
    lam = torch.ones(rank, dtype=torch.float32, device=dev)
    idx = torch.as_tensor(tensor.indices, dtype=torch.int32).to(dev)
    val = torch.as_tensor(tensor.values, dtype=torch.float32).to(dev)
    fits: list[float] = []
    seconds: list[float] = []
    for it in range(iters):
        t0 = time.perf_counter()
        factors, lam, fit = _sweep(idx, val, factors, lam,
                                   tuple(tensor.shape), it == 0)
        fits.append(float(fit))   # waits for the sweep
        seconds.append(time.perf_counter() - t0)
        if it > 0 and abs(fits[-1] - fits[-2]) < tol:
            break
    return CPResult([f.cpu().numpy() for f in factors], lam.cpu().numpy(),
                    fits, len(fits), seconds)


# ---------------------------------------------------------------------------
# Dynasor driver, one device
# ---------------------------------------------------------------------------

def als_sweep(stream, factors, lam, x_norm_sq, rt: dist.DynasorRuntime, *,
              sweep0: bool, backend: str = "segsum") -> SweepResult:
    """One ALS sweep over all modes, with dynamic remapping between modes.

    ``stream`` is the ``(idx, val, mask)`` layout in mode-0 order and
    ``factors`` the ``(i_pad_n, R)`` matrices in permuted row space, all
    on one device; ``x_norm_sq`` is a 0-d float32 tensor there. Per mode:
    MTTKRP → guarded solve → column normalization (2-norm on the first
    sweep, max-norm floored at 1 after) → remap into the next mode's
    order, as the reference's ``make_als_sweep`` does at one worker.
    The mode steps gather in ``rt.gather_dtype``.
    """
    idx, val, mask = stream
    factors = list(factors)
    grams = [f.T @ f for f in factors]   # padding rows are 0 → exact
    outs = []
    for n in range(rt.nmodes):
        local_M = dist.device_mttkrp(idx, val, mask, factors, n, rt, backend)
        A = _solve_v(grams, n, local_M)
        if sweep0:
            norms = torch.sqrt(torch.sum(A ** 2, dim=0))
        else:
            norms = torch.clamp(torch.max(torch.abs(A), dim=0).values,
                                min=1.0)
        norms = torch.where(norms == 0, 1.0, norms)
        A = A / norms
        lam = norms
        factors[n] = A
        grams[n] = A.T @ A
        outs.append(local_M)
        idx, val, mask, _ = dist.device_remap(idx, val, mask,
                                              (n + 1) % rt.nmodes, rt)
    fit = fit_from_parts(x_norm_sq, lam, grams, outs[-1], factors[-1])
    return SweepResult((idx, val, mask), factors, lam, fit, outs)


def device_state(ft: FlycooTensor, rt: dist.DynasorRuntime, packed, *,
                 seed: int, device):
    """Move ``prepare_runtime``'s mode-0 layout and ``init_factors`` to
    ``device``: returns ``(stream, factors, lam, x_norm_sq)``."""
    idx, val, mask = packed
    stream = (torch.from_numpy(idx[0]).to(device),
              torch.from_numpy(val[0]).to(device),
              torch.from_numpy(mask[0]).to(device))
    factors = [torch.from_numpy(f).to(device)
               for f in dist.init_factors(ft, rt, seed=seed)]
    lam = torch.ones(rt.rank, dtype=torch.float32, device=device)
    x_norm_sq = torch.tensor(
        np.float32(np.sum(ft.tensor.values.astype(np.float64) ** 2)),
        device=device)
    return stream, factors, lam, x_norm_sq


def cp_als_distributed(ft: FlycooTensor, rank: int, *, device=None,
                       iters: int = 10, seed: int = 0, tol: float = 1e-5,
                       backend: str = "segsum", tile_rows: int = 8,
                       gather_dtype: str = "float32",
                       ordering: str | None = None,
                       blk: int | None = None) -> CPResult:
    """Dynasor CP-ALS on one device: FLYCOO layout + :func:`als_sweep`.

    The reference's signature with ``mesh`` replaced by ``device``, and
    ``blk`` (the nonzero block; ``None``: ``prepare_runtime``'s
    ``min(g, 512)``) passed on to :func:`prepare_runtime`, since the
    stream kernel's windows grow with it. ``ft`` must be built for one
    worker (``build_flycoo(t, 1)``); more workers raise
    ``NotImplementedError`` (ROADMAP A9). ``backend`` is ``segsum``,
    ``ref``, ``auto`` (per mode the first rung of the residency ladder
    that fits, ``ops.select_backend``), ``pallas_fused_gather`` (B1),
    ``pallas_fused_gather_tiled`` (B2), ``pallas_fused`` (B3),
    ``pallas_fused_tiled`` (B4), ``pallas`` (B5),
    ``pallas_fused_gather_stream`` (B6), or the bf16 names
    ``pallas_fused_bf16`` (B3) and ``pallas_fused_gather_bf16`` (B1).
    ``gather_dtype="bfloat16"`` runs every fused-family mode step (B1–B4,
    B6) on bf16 factor operands with fp32 products and sums; ``ordering``
    (``reorder.ORDERINGS``; ``None`` inherits ``ft.ordering``) ranks each
    mode step's output-tile runs by factor-tile locality.
    """
    dev = resolve_device(device)
    kops.check_backend(backend, extra=("segsum",))
    if ft.params.num_workers != 1:
        raise NotImplementedError(
            f"num_workers={ft.params.num_workers}: the multi-GPU path is not "
            "ported yet (ROADMAP A9); build FLYCOO with num_workers=1")
    rt, packed = dist.prepare_runtime(ft, rank, blk=blk, tile_rows=tile_rows,
                                      gather_dtype=gather_dtype,
                                      ordering=ordering)
    stream, factors, lam, x_norm_sq = device_state(ft, rt, packed,
                                                   seed=seed, device=dev)
    fits: list[float] = []
    seconds: list[float] = []
    for it in range(iters):
        t0 = time.perf_counter()
        stream, factors, lam, fit, _ = als_sweep(
            stream, factors, lam, x_norm_sq, rt, sweep0=it == 0,
            backend=backend)
        fits.append(float(fit))   # waits for the whole sweep
        seconds.append(time.perf_counter() - t0)
        if it > 0 and abs(fits[-1] - fits[-2]) < tol:
            break
    nat = [dist.unpermute_factor(ft, rt, n, f.cpu().numpy())
           for n, f in enumerate(factors)]
    return CPResult(nat, lam.cpu().numpy(), fits, len(fits), seconds)
