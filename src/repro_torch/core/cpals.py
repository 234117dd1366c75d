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

Both run on CUDA unless the caller passes ``device="cpu"``. Both take a
``tracer`` (``repro_torch.obs``) and ``checkpoint_dir``: resumable sweeps
through atomic checkpoints (``resilience.checkpoint``). An enabled
tracer, a ``checkpoint_dir`` or a ``resilience`` policy switches
:func:`cp_als_distributed` to the stepped driver, whose phases (each
mode's MTTKRP, solve and remap) are host-level calls with spans, retries
and counters; without them it runs :func:`als_sweep`.

Fit = 1 - ||X - X̂||_F / ||X||_F from the sparse-CP identity (SPLATT):
||X̂||² = 1λᵀ(⊛_w Gramᵂ)λ1 and <X, X̂> = Σ_r λ_r Σ_i M_last[i,r]·A_last[i,r],
with ``M_last`` the last mode's pre-solve MTTKRP output.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.mttkrp import ops as kops
from ..obs import counters as _obs
from ..obs import tracer as _tracer
from ..resilience import checkpoint as _ckpt
from ..resilience import numerics as _numerics
from ..resilience import policy as _rpolicy
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
           tol: float = 1e-5, tracer=None,
           checkpoint_dir: str | None = None,
           checkpoint_every: int = 1) -> CPResult:
    """Single-device CP-ALS (paper Alg. 1) — the correctness oracle.

    Factors start from ``numpy.random.default_rng(seed)`` as in the
    reference, so both packages start from the same numbers.

    ``tracer`` (default: the process tracer, normally the no-op) records
    one ``sweep`` span per sweep. ``checkpoint_dir`` turns on resumable
    sweeps: every ``checkpoint_every``-th completed sweep is persisted
    atomically (factors, λ, fit trace, sweep index; backend fingerprint
    ``"torch"``, so a checkpoint of the reference's ``cp_als`` is
    refused), and a rerun pointed at the same directory restores the
    newest complete checkpoint and continues from it.
    """
    tracer = _tracer.get_tracer() if tracer is None else tracer
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
    start_it = 0
    mgr = _ckpt.make_manager(checkpoint_dir)
    if mgr is not None:
        state, _ = _ckpt.restore_state(
            mgr, _ckpt.make_state(factors, lam, fits, sweep=0, rank=rank,
                                  backend="torch"), device=dev)
        if state is not None:
            factors, lam = list(state["factors"]), state["lam"]
            fits = [float(x) for x in state["fits"]]
            start_it = int(state["sweep"]) + 1
    for it in range(start_it, iters):
        t0 = time.perf_counter()
        with tracer.span("sweep", sweep=it, driver="single"):
            factors, lam, fit = _sweep(idx, val, factors, lam,
                                       tuple(tensor.shape), it == 0)
            fit = float(fit)   # waits for the sweep
        seconds.append(time.perf_counter() - t0)
        _obs.add("cpals.sweep_s", seconds[-1], driver="single")
        _obs.add("cpals.sweeps", driver="single")
        fits.append(fit)
        if mgr is not None and (it + 1) % checkpoint_every == 0:
            _ckpt.save_state(mgr, _ckpt.make_state(
                factors, lam, fits, sweep=it, rank=rank, backend="torch"))
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


def _sync(dev: torch.device) -> None:
    """Wait for ``dev``'s queued work, so a phase's span and retry cover
    it (a no-op on the CPU, where ops run eagerly)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ckpt_state(rt, backend, factors, lam, fits, sweep, stream):
    """One distributed-sweep checkpoint, the stream included."""
    return _ckpt.make_state(factors, lam, fits, sweep=sweep, rank=rt.rank,
                            ordering=rt.ordering, backend=backend,
                            stream=stream)


def _cp_als_distributed_stepped(ft, rt, stream, factors, lam, x_norm_sq, *,
                                workers, iters: int, tol: float,
                                backend: str, tracer, mgr=None,
                                checkpoint_every: int = 1) -> CPResult:
    """Stepped Dynasor CP-ALS: each phase a host-level call.

    The counterpart of the reference's ``_cp_als_distributed_traced``,
    with the same phases, spans and counters. Per mode:

    * ``mttkrp``: each local worker's owner-computes MTTKRP, then the
      full pre-solve ``M`` as ``workers.all_gather`` of the local outputs
      (under ``pol.run("ops.kernel", ...)`` when a policy is active; the
      kernel dispatch inside walks the degradation ladder);
    * ``solve``: :func:`_solve_v_guarded` and :func:`_normalize_columns`
      on the full matrix, as the reference's stepped driver does (row for
      row the owned-rows solve of :func:`als_sweep`); the guard level is
      decided once, and a level above 0 adds to
      ``resilience.solve.guards``;
    * ``remap``: :func:`dist.device_remap` into the next mode's owners
      (under ``pol.run("distributed.remap", ...)``).

    Each phase ends with ``torch.cuda.synchronize`` on CUDA, so its span
    and ``cpals.phase_s`` cover its device work and a fault that retries
    it finds nothing in flight. ``M`` is always built by the all_gather,
    so no layout pin is needed before the solve (the reference pins one:
    there ``M`` arrives sharded mid-run and whole on resume).
    Checkpoints (``mgr``) hold the factors, λ, fits, the sweep index and
    the remapped stream with its worker axis, so a resumed run continues
    from the exact post-sweep state. With workers spread over processes
    the streams are gathered to every rank, rank 0 saves, and every rank
    waits at a barrier until the save has landed; a restore takes rank
    0's newest step and each rank's own slice of the stream.
    """
    dev = workers.device
    idx, val, mask = stream
    fits: list[float] = []
    seconds: list[float] = []
    start_it = 0
    if mgr is not None:
        state, _ = _ckpt.restore_state(
            mgr, _ckpt_state(rt, backend, factors, lam, fits, 0,
                             (idx, val, mask)), device=dev, workers=workers)
        if state is not None:
            factors, lam = state["factors"], state["lam"]
            fits = [float(x) for x in state["fits"]]
            idx, val, mask = (state["stream_idx"], state["stream_val"],
                              state["stream_mask"])
            start_it = int(state["sweep"]) + 1
    pol = _rpolicy.get_policy()
    factors = list(factors)
    grams = [f.T @ f for f in factors]
    for it in range(start_it, iters):
        t_sweep = time.perf_counter()
        with tracer.span("sweep", sweep=it, driver="distributed"):
            M = A = None
            for n in range(rt.nmodes):
                with tracer.span("mode", mode=n):
                    t0 = time.perf_counter()
                    with tracer.span("mttkrp", backend=backend):
                        def _mttkrp(n=n, idx=idx, val=val, mask=mask,
                                    factors=tuple(factors)):
                            out = workers.all_gather(dist.local_mttkrp(
                                idx, val, mask, list(factors), n, rt,
                                backend, workers))
                            _sync(dev)
                            return out
                        M = (_mttkrp() if pol is None
                             else pol.run("ops.kernel", _mttkrp))
                    _obs.add("cpals.phase_s", time.perf_counter() - t0,
                             phase="mttkrp", mode=n)
                    t0 = time.perf_counter()
                    with tracer.span("solve"):
                        A, level = _solve_v_guarded(grams, n, M)
                        A, norms = _normalize_columns(A, it == 0)
                        _sync(dev)
                        if level:
                            _obs.add("resilience.solve.guards",
                                     level=_numerics.GUARD_LEVELS[level],
                                     mode=n)
                    _obs.add("cpals.phase_s", time.perf_counter() - t0,
                             phase="solve", mode=n)
                    factors[n] = A
                    grams[n] = A.T @ A
                    lam = norms
                    t0 = time.perf_counter()
                    with tracer.span("remap", transition=n):
                        def _remap(n=n, idx=idx, val=val, mask=mask):
                            out = dist.device_remap(
                                idx, val, mask, (n + 1) % rt.nmodes, rt,
                                workers)[:3]
                            _sync(dev)
                            return out
                        idx, val, mask = (
                            _remap() if pol is None
                            else pol.run("distributed.remap", _remap))
                    _obs.add("cpals.phase_s", time.perf_counter() - t0,
                             phase="remap", mode=n)
            fit = float(fit_from_parts(x_norm_sq, lam, grams, M, A))
        seconds.append(time.perf_counter() - t_sweep)
        _obs.add("cpals.sweep_s", seconds[-1], driver="distributed")
        _obs.add("cpals.sweeps", driver="distributed")
        fits.append(fit)
        if mgr is not None and (it + 1) % checkpoint_every == 0:
            full = _ckpt.gather_stream((idx, val, mask), workers)
            if workers.ranks[0] == 0:
                _ckpt.save_state(mgr, _ckpt_state(rt, backend, factors, lam,
                                                  fits, it, full))
            workers.barrier()
        if it > 0 and abs(fits[-1] - fits[-2]) < tol:
            break
    nat = [dist.unpermute_factor(ft, rt, n, f.cpu().numpy())
           for n, f in enumerate(factors)]
    return CPResult(nat, lam.cpu().numpy(), fits, len(fits), seconds)


def cp_als_distributed(ft: FlycooTensor, rank: int, *, device=None,
                       workers=None, iters: int = 10, seed: int = 0,
                       tol: float = 1e-5, backend: str = "segsum",
                       tile_rows: int = 8, gather_dtype: str = "float32",
                       ordering: str | None = None,
                       blk: int | None = None, tracer=None,
                       checkpoint_dir: str | None = None,
                       checkpoint_every: int = 1, checkpoint_keep: int = 3,
                       resilience: _rpolicy.RetryPolicy | None = None,
                       table=None) -> CPResult:
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

    ``table`` (a ``repro_torch.tune`` calibration table or cost model)
    goes to :func:`prepare_runtime`: each mode then gets a tuned
    ``(backend, blk, tile_rows)`` plan, which ``backend="auto"`` follows
    in both drivers (every mode step reads its configuration from
    ``rt.plan_for``); an explicit ``backend`` keeps the plan's block and
    tile only. ``None`` keeps the static configuration, bit for bit.

    ``tracer`` defaults to the process tracer (``repro_torch.obs``),
    normally the no-op. An *enabled* tracer, a ``checkpoint_dir`` or a
    ``resilience`` policy (a ``resilience.RetryPolicy``) switch to the
    stepped driver (:func:`_cp_als_distributed_stepped`): nested
    ``sweep → mode → mttkrp|solve|remap`` spans; under the policy every
    mode step, remap and chunk launch gets bounded retry and a counted
    walk down the degradation ladder. ``checkpoint_dir`` persists every
    ``checkpoint_every``-th sweep atomically (the newest
    ``checkpoint_keep`` kept), stream included, and a rerun resumes from
    the newest one. With workers spread over processes (a
    :class:`~.workers.GroupWorkers` of more than one rank) every rank
    passes the same ``checkpoint_dir``: rank 0 writes what a
    :class:`~.workers.LocalWorkers` run at the same D writes, and each
    rank resumes its own slice of the stream.
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
    tracer = _tracer.get_tracer() if tracer is None else tracer
    rt, packed = dist.prepare_runtime(ft, rank, blk=blk, tile_rows=tile_rows,
                                      gather_dtype=gather_dtype,
                                      ordering=ordering, table=table)
    stream, factors, lam, x_norm_sq = device_state(ft, rt, packed, seed=seed,
                                                   workers=workers)
    del packed
    mgr = _ckpt.make_manager(checkpoint_dir, keep=checkpoint_keep,
                             owner=workers.ranks[0] == 0)
    if tracer.enabled or resilience is not None or mgr is not None:
        with (contextlib.nullcontext() if resilience is None
              else _rpolicy.use_policy(resilience)):
            return _cp_als_distributed_stepped(
                ft, rt, stream, factors, lam, x_norm_sq, workers=workers,
                iters=iters, tol=tol, backend=backend, tracer=tracer,
                mgr=mgr, checkpoint_every=checkpoint_every)
    fits: list[float] = []
    seconds: list[float] = []
    for it in range(iters):
        t0 = time.perf_counter()
        stream, factors, lam, fit, _ = als_sweep(
            stream, factors, lam, x_norm_sq, rt, workers=workers,
            sweep0=it == 0, backend=backend)
        fits.append(float(fit))   # waits for the whole sweep
        seconds.append(time.perf_counter() - t0)
        _obs.add("cpals.sweep_s", seconds[-1], driver="distributed")
        _obs.add("cpals.sweeps", driver="distributed")
        if it > 0 and abs(fits[-1] - fits[-2]) < tol:
            break
    nat = [dist.unpermute_factor(ft, rt, n, f.cpu().numpy())
           for n, f in enumerate(factors)]
    return CPResult(nat, lam.cpu().numpy(), fits, len(fits), seconds)
