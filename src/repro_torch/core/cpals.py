"""CP-ALS (paper Alg. 1) on top of the port's spMTTKRP engines.

Port of ``repro/core/cpals.py``. Two drivers, one algorithm:

* :func:`cp_als` — single-device reference (``index_add_`` MTTKRP), the
  correctness oracle.
* :func:`cp_als_distributed` — the Dynasor path on D workers
  (``core.workers``; on one GPU, D workers in one process): FLYCOO
  layout, per mode each worker's owner-computes MTTKRP (the
  in-kernel-gather CUDA kernels with ``backend="pallas_fused_gather"`` or
  ``"..._tiled"``, the out-of-core stream kernel with
  ``"pallas_fused_gather_stream"``, ...), its guarded solve on its owned
  rows, column normalization from psummed (or pmaxed) column norms, an
  all_gather of the factor, and the remap into the next mode's owners.
  :func:`als_sweep` is one sweep, the math of the reference's
  ``make_als_sweep``.

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
from .workers import LocalWorkers

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
    return _fit(x_norm_sq, lam, grams,
                torch.einsum("ir,ir,r->", M_last, A_last, lam))


def _fit(x_norm_sq, lam, grams, inner):
    """The fit from ``<X, X̂>`` (``inner``) and the grams."""
    R = lam.shape[0]
    G = torch.ones((R, R), dtype=grams[0].dtype, device=grams[0].device)
    for g in grams:
        G = G * g
    model_norm_sq = torch.einsum("r,rs,s->", lam, G, lam)
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
# Dynasor driver, D workers
# ---------------------------------------------------------------------------

def als_sweep(stream, factors, lam, x_norm_sq, rt: dist.DynasorRuntime, *,
              workers, sweep0: bool,
              backend: str = "segsum") -> SweepResult:
    """One ALS sweep over all modes, with dynamic remapping between modes.

    ``stream`` is the ``(idx (L, cap, N), val (L, cap), mask (L, cap))``
    mode-0 layouts of the ``L`` workers this process holds (``workers``,
    ``core.workers``) and ``factors`` the replicated ``(i_pad_n, R)``
    matrices in permuted row space; ``x_norm_sq`` is a 0-d float32 tensor.
    Per mode, as the reference's ``make_als_sweep``: each worker's MTTKRP
    and guarded solve on its owned rows → column norms (2-norm from the
    psum of squared sums on the first sweep, else the pmax of absolute
    maxima floored at 1) → all_gather of the normalized factor → the
    remap into the next mode's owners. The fit's inner term is a psum
    over workers. The mode steps gather in ``rt.gather_dtype``.
    ``SweepResult.mttkrp`` holds each mode's ``(L, rows_cap, R)`` local
    pre-solve outputs.
    """
    idx, val, mask = stream
    factors = list(factors)
    grams = [f.T @ f for f in factors]   # padding rows are 0 → exact
    outs = []
    for n in range(rt.nmodes):
        local_M = dist.local_mttkrp(idx, val, mask, factors, n, rt, backend,
                                     workers)
        A = dist.stack_workers([_solve_v(grams, n, m) for m in local_M])
        # Column norms need the full matrix: reduce the local ones.
        if sweep0:
            norms = torch.sqrt(workers.psum(dist.stack_workers(
                [torch.sum(a ** 2, dim=0) for a in A])))
        else:
            norms = torch.clamp(workers.pmax(dist.stack_workers(
                [torch.max(torch.abs(a), dim=0).values for a in A])),
                min=1.0)
        norms = torch.where(norms == 0, 1.0, norms)
        A = A / norms
        lam = norms
        factors[n] = workers.all_gather(A)
        grams[n] = factors[n].T @ factors[n]
        outs.append(local_M)
        idx, val, mask, _ = dist.device_remap(
            idx, val, mask, (n + 1) % rt.nmodes, rt, workers)
    # <X, X̂> = Σ_r λ_r Σ_i M[i,r]·Â[i,r] over owned rows, psummed.
    inner = workers.psum(dist.stack_workers([
        torch.einsum("ir,ir,r->", m, a, lam) for m, a in zip(outs[-1], A)]))
    fit = _fit(x_norm_sq, lam, grams, inner)
    return SweepResult((idx, val, mask), factors, lam, fit, outs)


def device_state(ft: FlycooTensor, rt: dist.DynasorRuntime, packed, *,
                 seed: int, workers):
    """Move ``prepare_runtime``'s mode-0 layout and ``init_factors`` to the
    workers' device: returns ``(stream, factors, lam, x_norm_sq)``, the
    stream with the leading axis of the workers this process holds
    (``workers``, ``core.workers``)."""
    if workers.num_workers != rt.num_workers:
        raise ValueError(f"{workers.num_workers} workers for a runtime of "
                         f"{rt.num_workers}")
    dev = workers.device
    sel = list(workers.ranks)
    stream = tuple(torch.from_numpy(np.ascontiguousarray(a[sel])).to(dev)
                   for a in packed)
    factors = [torch.from_numpy(f).to(dev)
               for f in dist.init_factors(ft, rt, seed=seed)]
    lam = torch.ones(rt.rank, dtype=torch.float32, device=dev)
    x_norm_sq = torch.tensor(
        np.float32(np.sum(ft.tensor.values.astype(np.float64) ** 2)),
        device=dev)
    return stream, factors, lam, x_norm_sq


def cp_als_distributed(ft: FlycooTensor, rank: int, *, device=None,
                       workers=None, iters: int = 10, seed: int = 0,
                       tol: float = 1e-5, backend: str = "segsum",
                       tile_rows: int = 8, gather_dtype: str = "float32",
                       ordering: str | None = None,
                       blk: int | None = None) -> CPResult:
    """Dynasor CP-ALS on ``ft.params.num_workers`` workers: FLYCOO layout +
    :func:`als_sweep`.

    The reference's signature with ``mesh`` replaced by ``workers``
    (``core.workers``): ``None`` means :class:`~.workers.LocalWorkers`
    for all of ``ft``'s workers in this process, on ``device`` (``None``:
    CUDA; ``"cpu"`` runs the plain versions); a
    :class:`~.workers.GroupWorkers` (this process as one rank) runs on its
    own device and must have ``ft.params.num_workers`` ranks. ``blk`` (the
    nonzero block; ``None``: ``prepare_runtime``'s ``min(g, 512)``) goes
    to :func:`prepare_runtime`, since the stream kernel's windows grow
    with it. ``backend`` is ``segsum``,
    ``ref``, ``auto`` (per mode the first rung of the residency ladder
    that fits, ``ops.select_backend``), ``pallas_fused_gather`` (B1),
    ``pallas_fused_gather_tiled`` (B2), ``pallas_fused`` (B3),
    ``pallas_fused_tiled`` (B4), ``pallas`` (B5),
    ``pallas_fused_gather_stream`` (B6), or the bf16 names
    ``pallas_fused_bf16`` (B3) and ``pallas_fused_gather_bf16`` (B1).
    ``gather_dtype="bfloat16"`` runs every fused-family mode step (B1–B4,
    B6) on bf16 factor operands with fp32 products and sums; ``ordering``
    (``reorder.ORDERINGS``; ``None`` inherits ``ft.ordering``) ranks each
    mode step's output-tile runs by factor-tile locality. The factors
    returned are replicated, in natural row order.
    """
    kops.check_backend(backend, extra=("segsum",))
    if workers is None:
        workers = LocalWorkers(ft.params.num_workers, device)
    elif device is not None and resolve_device(device) != workers.device:
        raise ValueError(f"device {device!r} is not the workers' device "
                         f"{workers.device}")
    if workers.num_workers != ft.params.num_workers:
        raise ValueError(f"{workers.num_workers} workers for a FLYCOO "
                         f"tensor built for {ft.params.num_workers}")
    rt, packed = dist.prepare_runtime(ft, rank, blk=blk, tile_rows=tile_rows,
                                      gather_dtype=gather_dtype,
                                      ordering=ordering)
    stream, factors, lam, x_norm_sq = device_state(ft, rt, packed, seed=seed,
                                                   workers=workers)
    del packed
    fits: list[float] = []
    seconds: list[float] = []
    for it in range(iters):
        t0 = time.perf_counter()
        stream, factors, lam, fit, _ = als_sweep(
            stream, factors, lam, x_norm_sq, rt, workers=workers,
            sweep0=it == 0, backend=backend)
        fits.append(float(fit))   # waits for the whole sweep
        seconds.append(time.perf_counter() - t0)
        if it > 0 and abs(fits[-1] - fits[-2]) < tol:
            break
    nat = [dist.unpermute_factor(ft, rt, n, f.cpu().numpy())
           for n, f in enumerate(factors)]
    return CPResult(nat, lam.cpu().numpy(), fits, len(fits), seconds)
