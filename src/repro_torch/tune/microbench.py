"""Microbenchmark harness: time every MTTKRP backend on a config grid.

Port of ``repro/tune/microbench.py``. Each grid point is a synthetic
per-worker mode step, a sorted, power-law-skewed nonzero stream of the
requested density plus random factor matrices, timed through every
backend:

  * the ``ops.BACKENDS`` family through ``ops.mttkrp_device_step``: on
    CUDA tensors the port's hand-written kernels (B1-B6, the bf16 names
    on B3 and B1 with bf16 factor operands), ``ref`` the plain
    ``index_add_`` path; on CPU tensors every kernel's plain version;
  * ``segsum``, the gather plus ``index_add_`` that
    ``core.distributed.device_mttkrp`` maps it to (``ref``'s mode step).

Timing is ``obs.prof.harness.measure_steady`` (CUDA-fenced, median with
outlier rejection). A backend that fails to build or launch raises out of
:func:`calibrate`: it is never dropped from the table, and a CUDA tensor
never runs a plain version in its place. Every backend fits the residency
planner's budgets at every key of both of the port's grids at the card's
case size (its kernels would otherwise refuse their shared memory), so
every measured argmin is a choice the dispatch may follow.

**Case sizes.** :func:`make_case` defaults to the reference's sizes
(``_SIDE_DIM = 64`` rows per input factor, ``_NUM_TILES = 4`` output row
tiles: at most 2,048 nonzeros), which equal the reference's arrays and
are what a CPU calibration runs. On a card such a case times a launch's
fixed cost, so a CUDA calibration sizes each case to ``CARD_CASE_NNZ``
nonzeros (:func:`case_num_tiles`) over ``CARD_SIDE_DIM``-row input
factors: the largest side at which every backend fits both of the
residency planner's budgets at every key of the quick grid (B6's
data-blind window at blk=512 is the binding one), so every measured
argmin is a choice the dispatch may follow. Each case's static stream
carries trailing all-padding blocks (``ops.n_pad_for`` gives every
output tile ``blk`` slots; ``build_block_layout`` clips the unused ones
onto the last tile, whose CTA walks them): :func:`case_layout` counts
them, and a CUDA calibration records them per point in
``meta["obs"]["cases"]``.

The ``measure`` hook is injectable (``measure(backend, point) ->
seconds``) so tests calibrate with deterministic stub timings.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from ..core.tensors import _powerlaw_columns
from ..kernels.mttkrp import ops as kops
from ..obs import counters as _obs
from ..obs import tracer as _tracer_mod
from ..oocore.planner import stream_window_tiles
from .table import CalibrationEntry, CalibrationTable, _device_type, \
    host_meta

__all__ = [
    "BACKENDS",
    "CARD_CASE_NNZ",
    "CARD_SIDE_DIM",
    "GridPoint",
    "default_grid",
    "make_case",
    "case_factor_rows",
    "case_layout",
    "case_num_tiles",
    "case_stream_window_tiles",
    "stub_measure",
    "calibrate",
]

# Everything the microbench times: the ops-runnable backends + the
# distributed layer's segsum path.
BACKENDS = kops.BACKENDS + ("segsum",)

# Dimension of the non-output modes in a synthetic case (gather breadth).
_SIDE_DIM = 64
# Output row tiles per case: rows_cap = _NUM_TILES * tile_rows.
_NUM_TILES = 4
# A CUDA calibration's cases: nonzeros per case and input-factor rows.
CARD_CASE_NNZ = 1 << 21
CARD_SIDE_DIM = 256


@dataclasses.dataclass(frozen=True)
class GridPoint:
    """One microbenchmark configuration."""

    nmodes: int
    rank: int
    blk: int
    tile_rows: int
    density: float          # mean nonzeros per (blk x row-tile) block


def default_grid(quick: bool = True) -> list[GridPoint]:
    """The port's calibration grid.

    ``quick`` covers the keys the port's paths query: nmodes {3, 4} x R
    {16, 256} x blk {64, 512} (the stream path's and the default block) x
    tile_rows 8 x density {0.5, 2.0}. ``quick=False`` widens the rank,
    block, tile and density axes. Neither grid goes past R=256 or
    nmodes=4: beyond them B1 and B3 (R=512) or B6 (nmodes 5, blk >= 128)
    do not fit a CTA's shared memory at the card's case size, and a key
    where a backend cannot launch is no calibration point (R=256 already
    runs B2 and B4 in two slabs). The reference's grids (blk 32, R
    16/128) are passed explicitly where a test compares with it.
    """
    if quick:
        nmodes, ranks = (3, 4), (16, 256)
        blks, tiles, densities = (64, 512), (8,), (0.5, 2.0)
    else:
        nmodes, ranks = (3, 4), (16, 32, 64, 128, 256)
        blks, tiles, densities = (64, 128, 512), (8, 16), (0.25, 1.0, 4.0)
    return [
        GridPoint(nmodes=n, rank=r, blk=b, tile_rows=t, density=d)
        for n in nmodes for r in ranks for b in blks for t in tiles
        for d in densities
    ]


def case_num_tiles(point: GridPoint, case_nnz: int | None) -> int:
    """Output row tiles of a case: the reference's ``_NUM_TILES``, or, for
    ``case_nnz`` nonzeros at the point's density, enough tiles to hold
    them (never fewer than ``_NUM_TILES``)."""
    if case_nnz is None:
        return _NUM_TILES
    return max(_NUM_TILES, -(-int(case_nnz) // max(1, int(point.density
                                                          * point.blk))))


def make_case(point: GridPoint, *, seed: int = 0, side_dim: int = _SIDE_DIM,
              num_tiles: int = _NUM_TILES, device=None):
    """Synthetic sorted stream + factors for one grid point, on ``device``
    (``None``: CUDA).

    Returns ``(idx, val, valid, factors, rows_cap)`` with output mode 0,
    as the reference's: ``density`` sets the nonzero count per output-row
    tile relative to ``blk``, and rows are power-law skewed. At the
    default ``side_dim`` and ``num_tiles`` the arrays equal the
    reference's.
    """
    from ..runtime.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    rows_cap = num_tiles * point.tile_rows
    nnz = max(8, int(point.density * num_tiles * point.blk))
    # Truncated-Pareto skew, same draw as the tensor generators.
    rows = np.sort(_powerlaw_columns(rng, (rows_cap,), nnz, 1.3)[:, 0])
    cols = [rows] + [rng.integers(0, side_dim, size=nnz)
                     for _ in range(point.nmodes - 1)]
    idx = torch.from_numpy(np.stack(cols, axis=1).astype(np.int32)).to(dev)
    val = torch.from_numpy(rng.standard_normal(nnz).astype(np.float32)) \
        .to(dev)
    valid = torch.ones((nnz,), dtype=torch.bool, device=dev)
    dims = (rows_cap,) + (side_dim,) * (point.nmodes - 1)
    factors = [torch.from_numpy(rng.standard_normal((d, point.rank))
                                .astype(np.float32)).to(dev)
               for d in dims]
    return idx, val, valid, factors, rows_cap


def case_factor_rows(point: GridPoint, side_dim: int = _SIDE_DIM) -> int:
    """Total input-factor rows of :func:`make_case`'s case: the non-output
    modes all have ``side_dim`` rows. Recorded in every entry so the
    dispatch can check the gather and stream rungs' fit."""
    return (point.nmodes - 1) * side_dim


def case_stream_window_tiles(point: GridPoint,
                             side_dim: int = _SIDE_DIM) -> int:
    """Per-input-mode stream-window width of the case: the planner's
    data-blind bound for ``side_dim``-row factors at this block size, in
    the port's ``FACTOR_ROW_TILE``-row tiles (the reference counts
    128-row ones)."""
    return stream_window_tiles(point.blk, side_dim)


def case_layout(point: GridPoint, case) -> dict:
    """The case's static block layout, counted: nonzeros, live output
    tiles (holding a nonzero) of all tiles, blocks of the static stream
    (``ops.n_pad_for``), its trailing all-padding blocks (the ones past
    the last tile's run, which that tile's CTA walks), and the nonzeros
    of the busiest tile (one CTA walks its run)."""
    idx, _, valid, _, rows_cap = case
    num_tiles = rows_cap // point.tile_rows
    tiles = torch.div(idx[:, 0][valid].long(), point.tile_rows,
                      rounding_mode="floor")
    counts = torch.bincount(tiles, minlength=num_tiles)
    used = int((-(-counts // point.blk)).sum())
    blocks = kops.n_pad_for(idx.shape[0], rows_cap, point.blk,
                            point.tile_rows) // point.blk
    return dict(nnz=int(valid.sum()), live_tiles=int((counts > 0).sum()),
                num_tiles=num_tiles, blocks=blocks,
                trailing_blocks=blocks - used,
                busiest_tile_nnz=int(counts.max()))


def stub_measure(backend: str, point: GridPoint) -> float:
    """Deterministic pseudo-timings from the traffic model (no kernels run).

    The reference's function, copied exactly, so a stub table equals the
    reference's entry for entry: for schema/CLI smoke runs
    (``python -m repro_torch.tune calibrate --stub``) and the tests.
    """
    k = (point.nmodes - 1) * point.rank * (1.0 + 0.1 * point.density)
    return {
        "ref": 8e-4 * point.rank,
        "segsum": 6e-4 * point.rank,
        "pallas": 0.05 + 2e-4 * k + 1e-5 * point.blk,
        "pallas_fused": 0.09 + 7e-5 * k + 2e-5 * point.tile_rows,
        "pallas_fused_tiled": 0.095 + 7e-5 * k + 2e-5 * point.tile_rows,
        "pallas_fused_bf16": 0.04 + 4e-5 * k + 2e-5 * point.tile_rows,
        "pallas_fused_gather": 0.07 + 5e-5 * k + 2e-5 * point.tile_rows,
        "pallas_fused_gather_tiled":
            0.075 + 5e-5 * k + 2e-5 * point.tile_rows,
        "pallas_fused_gather_bf16":
            0.03 + 3e-5 * k + 2e-5 * point.tile_rows,
        "pallas_fused_gather_stream":
            0.08 + 6e-5 * k + 2e-5 * point.tile_rows + 1e-5 * point.blk,
    }[backend]


class _RealMeasure:
    """Default ``measure(backend, point)``: run the mode step on ``dev``.

    Keeps the current point's case (built on first use) and its
    :func:`case_layout` in ``layouts``."""

    def __init__(self, *, seed: int, warmup: int, iters: int, dev,
                 side_dim: int, case_nnz: int | None):
        self.seed, self.warmup, self.iters, self.dev = seed, warmup, iters, dev
        self.side_dim, self.case_nnz = side_dim, case_nnz
        self.layouts: dict = {}
        self._point = self._case = None

    def case(self, point: GridPoint):
        if point != self._point:
            self._case = None       # free the previous case first
            self._case = make_case(
                point, seed=self.seed, side_dim=self.side_dim,
                num_tiles=case_num_tiles(point, self.case_nnz),
                device=self.dev)
            self._point = point
            self.layouts[point] = case_layout(point, self._case)
        return self._case

    def __call__(self, backend: str, point: GridPoint) -> float:
        from ..obs.prof import harness as _harness

        idx, val, valid, factors, rows_cap = self.case(point)
        fn = lambda: kops.mttkrp_device_step(  # noqa: E731
            idx, val, valid, factors, mode=0, rows_cap=rows_cap,
            row_offset=0, blk=point.blk, tile_rows=point.tile_rows,
            backend="ref" if backend == "segsum" else backend)
        return _harness.measure_steady(fn, warmup=self.warmup,
                                       repeats=self.iters).median_s


def calibrate(
    grid: Iterable[GridPoint] | None = None,
    *,
    quick: bool = True,
    backends: Sequence[str] = BACKENDS,
    measure: Callable | None = None,
    seed: int = 0,
    warmup: int = 1,
    iters: int = 2,
    meta_extra: dict | None = None,
    verbose: bool = False,
    device=None,
) -> CalibrationTable:
    """Measure ``backends`` over ``grid`` and return a CalibrationTable.

    ``measure(backend, point) -> seconds`` defaults to running each mode
    step on ``device`` (``None``: CUDA; ``"cpu"`` times the plain
    versions); tests pass a deterministic stub. The cases are the
    reference's sizes on the CPU, ``CARD_CASE_NNZ`` nonzeros over
    ``CARD_SIDE_DIM``-row input factors on CUDA. Spans
    ``calibrate`` > ``point`` > ``measure``; counters ``tune.measure_s``
    (per backend) and ``tune.points``.
    """
    points = list(grid) if grid is not None else default_grid(quick=quick)
    if measure is None:
        from ..runtime.device import resolve_device

        dev = resolve_device(device)
        on_card = dev.type == "cuda"
    else:
        dev, on_card = None, _device_type(device) == "cuda"
    side_dim = CARD_SIDE_DIM if on_card else _SIDE_DIM
    case_nnz = CARD_CASE_NNZ if on_card else None
    real = None
    if measure is None:
        measure = real = _RealMeasure(seed=seed, warmup=warmup, iters=iters,
                                      dev=dev, side_dim=side_dim,
                                      case_nnz=case_nnz)
    tracer = _tracer_mod.get_tracer()
    entries = []
    measured_s: dict[str, float] = {}
    with tracer.span("calibrate", points=len(points),
                     backends=len(backends)):
        for point in points:
            timings = {}
            with tracer.span("point", nmodes=point.nmodes, rank=point.rank,
                             blk=point.blk, tile_rows=point.tile_rows,
                             density=point.density):
                for b in backends:
                    with tracer.span("measure", backend=b):
                        timings[b] = float(measure(b, point))
                    _obs.add("tune.measure_s", timings[b], backend=b)
                    measured_s[b] = measured_s.get(b, 0.0) + timings[b]
                _obs.add("tune.points")
            entries.append(CalibrationEntry(
                nmodes=point.nmodes, rank=point.rank, blk=point.blk,
                tile_rows=point.tile_rows, density=point.density,
                timings_s=timings,
                factor_rows=case_factor_rows(point, side_dim),
                stream_window_tiles=case_stream_window_tiles(point,
                                                             side_dim),
            ))
            if verbose:
                lay = real.layouts.get(point) if real is not None else None
                print(f"  {point}: best={entries[-1].best} "
                      + " ".join(f"{b}={t * 1e3:.4f}ms"
                                 for b, t in timings.items())
                      + ("" if lay is None else
                         f" | nnz={lay['nnz']} live_tiles="
                         f"{lay['live_tiles']}/{lay['num_tiles']} "
                         f"trailing_padding_blocks={lay['trailing_blocks']}"
                         f"/{lay['blocks']} busiest_tile_nnz="
                         f"{lay['busiest_tile_nnz']}"),
                      flush=True)
    # The table carries its own observability summary: the wall time the
    # calibration spent per backend, the spans recorded and, when it ran
    # the mode steps, each case's layout.
    obs_meta = {
        "points": len(points),
        "measure_s": {b: round(s, 6) for b, s in sorted(measured_s.items())},
        "spans": len(tracer.records) if tracer.enabled else 0,
        "side_dim": side_dim,
        "case_nnz": case_nnz,
    }
    if real is not None:
        obs_meta["cases"] = [
            dict(nmodes=p.nmodes, rank=p.rank, blk=p.blk,
                 tile_rows=p.tile_rows, density=p.density, **lay)
            for p, lay in real.layouts.items()]
    meta = host_meta(dict(meta_extra or {}, quick=quick, seed=seed,
                          obs=obs_meta),
                     device=dev if dev is not None else device)
    return CalibrationTable(entries=entries, meta=meta)
