"""Cost model: interpolate a calibration table to unseen configurations.

Port of ``repro/tune/model.py``. The table holds measurements on a
discrete grid; the dispatch needs an answer for *any* ``(nmodes, rank,
blk, tile_rows)``. The model, plain numpy and answering exactly as the
reference's does for the same entries:

  * groups entries by ``(nmodes, blk, tile_rows, density)``;
  * within a group, interpolates backend time piecewise-linearly in
    ``log2(rank)``, clamped at the ends;
  * off-grid ``(nmodes, blk, tile_rows)`` resolve to the nearest measured
    group: exact ``nmodes`` preferred, then the smallest log-ratio
    distance on ``(blk, tile_rows)``;
  * ``density=None`` aggregates over the measured densities (median), so
    an in-grid query reproduces the measured argmin exactly.

Every query can return ``None`` (the table can't answer); callers then
keep the static residency ladder, bit-identical to the untuned dispatch.

**Hopper translation.** A candidate is feasible when the port's
``oocore.planner.backend_fits`` accepts it on shared memory per CTA and
L2 (the reference checks VMEM). The reference also keeps its kernels off
a rank below ``MIN_MXU_RANK`` (8) that the table never measured: that
guards its static ``ref`` rung, which spares a tiny rank the MXU's
128-wide padding. The port's ladder has no such rung (it pads the rank to
16, ``kernel.RANK_MULTIPLE``, and every rank below 16 runs the work of
16), so the port keeps no rank guard: a rank below the table's lowest
knot answers with that knot's times (the clamp), at every rank.

:func:`plan_modes` turns a table into per-mode tuned
``(backend, blk, tile_rows)`` plans for ``DynasorRuntime``.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from ..core.distributed import ModePlan
from ..kernels.mttkrp.ops import AUTO_BACKENDS, select_backend
from ..oocore import planner as _planner

__all__ = ["CostModel", "compare_dispatch", "plan_modes"]


def _feasible(backends, nmodes: int, rank: int, blk: int, tile_rows: int,
              *, factor_rows=None):
    """Filter ``backends`` by the hard constraint ``select_backend``'s
    table path applies: the residency planner's fit
    (``oocore.planner.backend_fits``, shared memory per CTA and L2; the
    gather and stream rungs need ``factor_rows`` to certify, and ``None``
    rules them out)."""
    return [b for b in backends
            if _planner.backend_fits(b, nmodes=nmodes, rank=rank, blk=blk,
                                     tile_rows=tile_rows,
                                     factor_rows=factor_rows)]


class CostModel:
    """Interpolating view over a :class:`~.table.CalibrationTable`."""

    def __init__(self, table):
        entries = getattr(table, "entries", table)
        # (nmodes, blk, tile_rows) -> density -> backend -> {rank: seconds}
        groups: dict = {}
        backends: set[str] = set()
        for e in entries:
            key = (e.nmodes, e.blk, e.tile_rows)
            by_density = groups.setdefault(key, {})
            by_backend = by_density.setdefault(float(e.density), {})
            for b, t in e.timings_s.items():
                by_backend.setdefault(b, {})[e.rank] = float(t)
                backends.add(b)
        # Freeze each {rank: t} map into sorted knot arrays for np.interp.
        self._groups = {
            key: {
                d: {
                    b: (np.array(sorted(rt)),
                        np.array([rt[r] for r in sorted(rt)]))
                    for b, rt in bb.items()
                }
                for d, bb in by_density.items()
            }
            for key, by_density in groups.items()
        }
        self.backends = tuple(sorted(backends))

    # -- group / density resolution ---------------------------------------

    def _nearest_group(self, nmodes: int, blk: int, tile_rows: int):
        if not self._groups:
            return None
        exact = (nmodes, blk, tile_rows)
        if exact in self._groups:
            return self._groups[exact]

        def dist(key):
            n, b, t = key
            shape_d = (abs(math.log2(b / blk))
                       + abs(math.log2(t / tile_rows)))
            return (abs(n - nmodes), shape_d, key)

        return self._groups[min(self._groups, key=dist)]

    @staticmethod
    def _nearest_density(by_density: dict, density: float):
        return by_density[min(
            by_density,
            key=lambda d: (abs(math.log(max(d, 1e-9) / max(density, 1e-9))),
                           d),
        )]

    # -- queries -----------------------------------------------------------

    def predict(self, backend: str, *, nmodes: int, rank: int, blk: int,
                tile_rows: int, density: float | None = None) -> float | None:
        """Interpolated seconds for one backend, or ``None`` if unanswerable."""
        group = self._nearest_group(nmodes, blk, tile_rows)
        if group is None:
            return None
        if density is None:
            curves = [bb[backend] for bb in group.values() if backend in bb]
        else:
            bb = self._nearest_density(group, density)
            curves = [bb[backend]] if backend in bb else []
        if not curves:
            return None
        lr = math.log2(max(rank, 1))
        vals = [float(np.interp(lr, np.log2(ranks), times))
                for ranks, times in curves]
        return float(np.median(vals))

    def covers(self, *, nmodes: int, rank: int, blk: int,
               tile_rows: int) -> bool:
        """Is ``rank`` within the measured knot span of the resolved group?

        Outside it a prediction is a clamped extrapolation. The port's
        dispatch does not consult this (see the module docstring); the
        reference's uses it below ``MIN_MXU_RANK``.
        """
        group = self._nearest_group(nmodes, blk, tile_rows)
        if group is None:
            return False
        knots = [r for bb in group.values()
                 for ranks, _ in bb.values() for r in ranks]
        return bool(knots) and min(knots) <= rank <= max(knots)

    def best_backend(self, *, nmodes: int, rank: int, blk: int,
                     tile_rows: int, allowed: Sequence[str] | None = None,
                     density: float | None = None) -> str | None:
        """Argmin backend over ``allowed`` (ties break by name), or ``None``."""
        candidates = self.backends if allowed is None else tuple(allowed)
        scored = []
        for b in sorted(set(candidates)):
            t = self.predict(b, nmodes=nmodes, rank=rank, blk=blk,
                             tile_rows=tile_rows, density=density)
            if t is not None:
                scored.append((t, b))
        if not scored:
            return None
        return min(scored)[1]

    def shape_candidates(self, nmodes: int) -> list[tuple[int, int]]:
        """Measured ``(blk, tile_rows)`` pairs, preferring exact ``nmodes``."""
        exact = sorted({(b, t) for (n, b, t) in self._groups if n == nmodes})
        if exact:
            return exact
        return sorted({(b, t) for (_, b, t) in self._groups})


def compare_dispatch(table, key) -> dict:
    """Static vs. calibrated vs. oracle decision at one dispatch key.

    The one definition of the consistency standard that ``python -m
    repro_torch.tune check`` applies. ``oracle`` is the measured argmin
    over the backends ``auto`` may pick (``AUTO_BACKENDS``: never bf16 or
    ``segsum``); when the table timed none of them, the static rung *is*
    the standard. ``factor_rows`` is the measured case's, so the
    dispatch can certify the gather and stream rungs.
    """
    from .table import aggregate_timings, key_factor_rows, measured_best

    nmodes, rank, blk, tile_rows = key
    agg = aggregate_timings(table, key)
    factor_rows = key_factor_rows(table, key)
    kw = dict(nmodes=nmodes, rank=rank, blk=blk, tile_rows=tile_rows,
              factor_rows=factor_rows)
    static = select_backend("auto", **kw)
    calibrated = select_backend("auto", table=table, **kw)
    oracle = measured_best(agg, allowed=AUTO_BACKENDS)
    if oracle is None:
        oracle = static
    return dict(agg=agg, static=static, calibrated=calibrated,
                oracle=oracle, factor_rows=factor_rows)


def plan_modes(table, ft, rank: int, *,
               allowed: Sequence[str] | None = None,
               num_workers: int | None = None,
               ordering: str = "none") -> tuple[ModePlan, ...] | None:
    """Tuned per-mode ``(backend, blk, tile_rows)`` plans for a tensor.

    For every output mode the model scores each measured ``(blk,
    tile_rows)`` shape x backend at that mode's own nonzero density
    (per-worker nonzeros per ``blk x row-tile`` block) and keeps the
    global argmin among the candidates the residency planner accepts
    (with this mode's per-input-mode factor rows). Returns ``None`` when
    the table cannot answer for some mode, so callers keep the static
    configuration.

    With ``allowed=None`` the pool is every measured backend of
    ``AUTO_BACKENDS`` plus ``segsum``: an automatic planner must not
    change numerics on timing evidence. ``ordering``
    (``reorder.ORDERINGS``) is carried verbatim into every plan.
    ``rank_slabs`` and ``window_tiles`` are the port's geometry
    (``oocore.planner.rung_slabs`` and ``stream_window_tiles``: slabs of
    ``RANK_SLAB`` or ``STREAM_RANK_SLAB`` columns, windows of
    ``FACTOR_ROW_TILE``-row tiles), as ``plan_residency`` derives them.
    """
    model = table if isinstance(table, CostModel) else CostModel(table)
    D = num_workers if num_workers is not None else ft.params.num_workers
    nnz_per_worker = max(1.0, ft.nnz / max(D, 1))
    plans = []
    for n in range(ft.nmodes):
        rows_per_worker = max(1, ft.modes[n].rows_cap)
        # Replicated input-factor rows this mode's gather kernel reads, per
        # input mode, so the planner sizes exact stream windows.
        factor_rows = tuple(D * ft.modes[w].rows_cap
                            for w in range(ft.nmodes) if w != n)
        best = None
        for blk, tile_rows in model.shape_candidates(ft.nmodes):
            num_tiles = max(1, -(-rows_per_worker // tile_rows))
            density = nnz_per_worker / (num_tiles * blk)
            cand_allowed = (
                [b for b in model.backends
                 if b == "segsum" or b in AUTO_BACKENDS]
                if allowed is None else allowed)
            cand_allowed = _feasible(cand_allowed, ft.nmodes, rank, blk,
                                     tile_rows, factor_rows=factor_rows)
            choice = model.best_backend(
                nmodes=ft.nmodes, rank=rank, blk=blk, tile_rows=tile_rows,
                allowed=cand_allowed, density=density)
            if choice is None:
                continue
            t = model.predict(choice, nmodes=ft.nmodes, rank=rank, blk=blk,
                              tile_rows=tile_rows, density=density)
            cand = (t, blk, tile_rows, choice)
            if best is None or cand < best:
                best = cand
        if best is None:
            return None
        _, blk, tile_rows, backend = best
        window = (tuple(_planner.stream_window_tiles(blk, r)
                        for r in factor_rows)
                  if backend == _planner.STREAM_BACKEND else ())
        plans.append(ModePlan(backend=backend, blk=blk, tile_rows=tile_rows,
                              rank_slabs=_planner.rung_slabs(backend, rank),
                              window_tiles=window, ordering=ordering))
    return tuple(plans)
