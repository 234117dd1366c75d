"""Factor-residency ladder, stream-window and chunk planning.

Port of ``repro/oocore/planner.py``:

* the residency ladder behind ``auto`` — :func:`plan_residency`,
  :func:`backend_fits`, :class:`ResidencyPlan`, :class:`FactorResidency` —
  re-derived for Hopper: two budgets, the per-CTA shared memory of each
  kernel (``smem_budget``) and the L2 that holds the factors the gather
  kernels read (``l2_budget``), in place of the TPU's one VMEM budget;
* the stream parts: the window bound, the chunk boundaries and per-chunk
  windows, the chunk byte budget, the per-block distinct-tile analysis and
  the traffic predictor. Given the same inputs and geometry
  (``frow_tile``, ``rank_slab``, the rank multiple) every count equals the
  reference's. The analysis runs on the device that holds the stream.

Every byte count that holds factor elements takes ``gather_itemsize``
(4 for float32, 2 for bf16 gathers; default 4), as the reference's does,
and the ``*_bf16`` backend names fold into ``gather_itemsize=2``.

:func:`stream_fits_smem` is the Hopper counterpart of the reference's
``backend_fits(STREAM_BACKEND, ...)`` and the stream rung's predicate.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..kernels.mttkrp import kernel as _kernel
from ..kernels.mttkrp import ops as _ops
from ..obs import counters as _obs

__all__ = [
    "FACTOR_ROW_TILE",
    "L2_BUDGET_BYTES",
    "LADDER",
    "SMEM_BUDGET_BYTES",
    "STREAM_BACKEND",
    "FactorResidency",
    "ResidencyPlan",
    "StreamTraffic",
    "backend_fits",
    "block_tile_analysis",
    "chunk_boundaries",
    "chunk_window_tiles",
    "factor_row_tiles",
    "plan_chunks",
    "plan_residency",
    "predict_stream_traffic",
    "rung_slabs",
    "stream_chunk_bytes",
    "stream_fits_smem",
    "stream_window_tiles",
    "stream_windows",
]

FACTOR_ROW_TILE = _kernel.FACTOR_ROW_TILE
STREAM_BACKEND = _kernel.STREAM_BACKEND_NAME


def factor_row_tiles(rows: int, frow_tile: int = FACTOR_ROW_TILE) -> int:
    """Number of ``frow_tile``-row tiles covering a ``rows``-row factor."""
    return max(1, -(-rows // frow_tile))


def stream_window_tiles(blk: int, rows: int,
                        frow_tile: int = FACTOR_ROW_TILE) -> int:
    """Data-blind bound on a block's window: ``blk`` nonzeros touch at most
    ``blk`` tiles, and a factor has no more than ``ceil(rows/frow_tile)``."""
    return min(blk, factor_row_tiles(rows, frow_tile))


def stream_fits_smem(*, nmodes: int, rank: int, blk: int, tile_rows: int,
                     factor_rows: Sequence[int],
                     window_tiles: Sequence[int] | None = None,
                     frow_tile: int = FACTOR_ROW_TILE,
                     rank_slab: int = _kernel.STREAM_RANK_SLAB,
                     rank_multiple: int = _kernel.RANK_MULTIPLE,
                     smem_budget: int = _kernel.SMEM_LIMIT_BYTES,
                     gather_itemsize: int = 4) -> bool:
    """Does the stream kernel's smallest CTA (one ring stage, one mapper
    warp) fit ``smem_budget`` bytes of shared memory? The kernel adds
    stages and mapper warps as the budget allows (``kernel.stream_ring``).
    Windows default to the data-blind bound per input mode;
    ``window_tiles`` (e.g. :attr:`StreamTraffic.window_tiles`) gives
    measured ones; ``gather_itemsize`` sizes their tiles. Monotone in the
    budget."""
    k = nmodes - 1
    if len(factor_rows) != k:
        raise ValueError(f"{len(factor_rows)} factor row counts for {k} "
                         "input modes")
    windows = (tuple(window_tiles) if window_tiles is not None
               else tuple(stream_window_tiles(blk, r, frow_tile)
                          for r in factor_rows))
    return _kernel.gather_stream_smem_bytes(
        k, _kernel.padded_rank(rank, rank_multiple), blk, tile_rows,
        windows, frow_tile=frow_tile, rank_slab=rank_slab,
        gather_itemsize=gather_itemsize) <= smem_budget


# ---------------------------------------------------------------------------
# The residency ladder (what ``auto`` resolves to)
# ---------------------------------------------------------------------------

# The ladder's default budgets (kernel.py holds them, like the reference's
# VMEM budget, so that ops and this module, which import each other,
# read one definition).
SMEM_BUDGET_BYTES = _kernel.SMEM_LIMIT_BYTES
L2_BUDGET_BYTES = _kernel.L2_BUDGET_BYTES

# The rungs in order; the first that fits wins.
LADDER = ("pallas_fused_gather", "pallas_fused_gather_tiled", STREAM_BACKEND,
          "pallas_fused", "pallas_fused_tiled", "pallas")
# Rungs that need the factor sizes.
_FACTOR_RUNGS = LADDER[:3]


@dataclasses.dataclass(frozen=True)
class FactorResidency:
    """Where one input-factor matrix lives under a :class:`ResidencyPlan`.

    ``policy`` is ``whole`` (the padded rank read out of L2, B1),
    ``slab`` (one column slab at a time, B2) or ``stream`` (in device
    memory, ``window_tiles`` tiles of ``FACTOR_ROW_TILE`` rows copied to
    shared memory per block, B6). ``resident_bytes`` is the L2 the factor
    takes (``whole``, ``slab``) or its shared-memory window (``stream``).
    """

    rows: int
    policy: str
    window_tiles: int
    rank_cols: int
    resident_bytes: int

    @property
    def row_tiles(self) -> int:
        """Row tiles of this factor (the stream kernel copies whole ones)."""
        return factor_row_tiles(self.rows)

    def tile_spans(self) -> list[tuple[int, int]]:
        """Disjoint ``[start, stop)`` row ranges, one per row tile; they
        partition ``[0, rows)``."""
        return [(t * FACTOR_ROW_TILE, min(self.rows, (t + 1) * FACTOR_ROW_TILE))
                for t in range(self.row_tiles)]


@dataclasses.dataclass(frozen=True)
class ResidencyPlan:
    """One mode step's residency decision under the two budgets."""

    backend: str
    nmodes: int
    rank: int
    blk: int
    tile_rows: int
    smem_budget: int
    l2_budget: int
    gather_itemsize: int                # bytes per gathered factor element
    smem_bytes: int                     # per-CTA shared memory of the choice
    l2_bytes: int                       # factor bytes it reads out of L2
    rank_slabs: int                     # column slabs the choice runs
    window_tiles: tuple[int, ...]       # per input mode; () unless streaming
    factors: tuple[FactorResidency, ...]  # () when factor sizes are unknown

    @property
    def streams(self) -> bool:
        return self.backend == STREAM_BACKEND

    @property
    def fits(self) -> bool:
        """Did the choice fit both budgets? ``pallas`` (B5), the last
        rung, runs whatever they are."""
        return self.backend == "pallas" or (
            self.smem_bytes <= self.smem_budget
            and self.l2_bytes <= self.l2_budget)


def _normalize_factor_rows(factor_rows, num_in_modes: int):
    """``factor_rows`` as ``(per-mode tuple | None, total | None)``.

    ``None`` (factor sizes unknown), an int total (``Σ I_w``; the stream
    window is then planned as if every input factor had all the rows), or
    one count per input mode.
    """
    if factor_rows is None:
        return None, None
    if isinstance(factor_rows, (list, tuple)):
        per_mode = tuple(int(r) for r in factor_rows)
        if len(per_mode) != num_in_modes:
            raise ValueError(f"{len(per_mode)} factor row counts for "
                             f"{num_in_modes} input modes")
        return per_mode, sum(per_mode)
    return None, int(factor_rows)


def _rung_cost(backend: str, *, k: int, rpad: int, tile_rows: int, blk: int,
               per_mode, total, gi: int, window_tiles=None
               ) -> tuple[int, int, tuple]:
    """``(smem_bytes, l2_bytes, windows)`` of one rung at ``gi`` bytes per
    factor element; the gather and stream rungs need ``total`` (not
    ``None``). ``window_tiles`` replaces the stream rung's data-blind
    windows. Factor elements sit in L2 for the gather rungs, in B6's
    windows and in B3/B4's ring of pre-gathered rows (its smallest CTA,
    one stage, is what a rung asks about); B1, B2 and B5's shared memory
    holds none."""
    slab = min(rpad, _kernel.RANK_SLAB)
    if backend == "pallas_fused_gather":
        return (_kernel.gather_smem_bytes(k, rpad, tile_rows),
                total * rpad * gi, ())
    if backend == "pallas_fused_gather_tiled":
        return (_kernel.gather_smem_bytes(k, rpad, tile_rows,
                                          rank_slab=slab),
                total * slab * gi, ())
    if backend == STREAM_BACKEND:
        rows = per_mode if per_mode is not None else (total,) * k
        windows = (tuple(int(w) for w in window_tiles)
                   if window_tiles is not None
                   else tuple(stream_window_tiles(blk, r) for r in rows))
        return (_kernel.gather_stream_smem_bytes(k, rpad, blk, tile_rows,
                                                 windows, gather_itemsize=gi),
                0, windows)
    if backend == "pallas_fused":
        return (_kernel.fused_smem_bytes(k, rpad, tile_rows,
                                         gather_itemsize=gi), 0, ())
    if backend == "pallas_fused_tiled":
        return (_kernel.fused_smem_bytes(k, rpad, tile_rows, rank_slab=slab,
                                         gather_itemsize=gi), 0, ())
    if backend == "pallas":
        return _kernel.segment_smem_bytes(rpad, tile_rows), 0, ()
    raise ValueError(f"{backend!r} is not a rung of the residency ladder")


def backend_fits(backend: str, *, nmodes: int, rank: int, blk: int,
                 tile_rows: int, factor_rows=None,
                 smem_budget: int = SMEM_BUDGET_BYTES,
                 l2_budget: int = L2_BUDGET_BYTES,
                 gather_itemsize: int = 4, window_tiles=None) -> bool:
    """Does ``backend`` fit the budgets? The ladder's one predicate.

    The gather rungs (B1, B2) fit when their factors (the padded rank,
    or one ``RANK_SLAB`` slab, of every input factor) fit ``l2_budget``
    and a CTA fits ``smem_budget``; the stream rung (B6) when its
    data-blind window fits ``smem_budget``
    (:func:`stream_fits_smem`); the fused rungs (B3, B4) when a CTA with
    the smallest ring of pre-gathered rows fits ``smem_budget``
    (``kernel.fused_smem_bytes``). These need no L2: each slot's rows are
    read once.
    The gather and stream rungs need ``factor_rows`` and do not fit
    without it. ``pallas`` (B5), ``ref`` and ``segsum`` always fit. Every
    test is ``bytes <= budget``, so it is monotone in both budgets.
    ``window_tiles`` (measured widths, e.g.
    :attr:`StreamTraffic.window_tiles`) replaces the stream rung's
    data-blind windows. ``gather_itemsize`` is the bytes of a gathered factor element; the
    ``*_bf16`` names fold into ``gather_itemsize=2``, as in the
    reference.
    """
    if backend.endswith("_bf16"):
        backend, gather_itemsize = backend[:-len("_bf16")], 2
    if backend in ("ref", "segsum", "pallas"):
        return True
    k, rpad = nmodes - 1, _kernel.padded_rank(rank)
    per_mode, total = _normalize_factor_rows(factor_rows, k)
    if backend in _FACTOR_RUNGS and total is None:
        return False
    if backend == STREAM_BACKEND:
        rows = per_mode if per_mode is not None else (total,) * k
        return stream_fits_smem(nmodes=nmodes, rank=rank, blk=blk,
                                tile_rows=tile_rows, factor_rows=rows,
                                window_tiles=window_tiles,
                                smem_budget=smem_budget,
                                gather_itemsize=gather_itemsize)
    smem, l2, _ = _rung_cost(backend, k=k, rpad=rpad, tile_rows=tile_rows,
                             blk=blk, per_mode=per_mode, total=total,
                             gi=gather_itemsize)
    return smem <= smem_budget and l2 <= l2_budget


def rung_slabs(backend: str, rank: int) -> int:
    """Column slabs ``backend`` runs at ``rank``: the padded rank over
    ``RANK_SLAB`` (B2, B4; the mode step pads the rank to whole slabs, so
    R=200 runs two), ``STREAM_RANK_SLAB`` (B6) or B5's own slab; 1 for
    the kernels that take the whole padded rank at once and for the
    plain paths."""
    rpad = _kernel.padded_rank(rank)
    if backend in ("pallas_fused_gather_tiled", "pallas_fused_tiled"):
        return -(-rpad // min(rpad, _kernel.RANK_SLAB))
    if backend == STREAM_BACKEND:
        return rpad // min(rpad, _kernel.STREAM_RANK_SLAB)
    if backend == "pallas":
        return rpad // _kernel.segment_slab(rpad)
    return 1


def _factor_states(per_mode, total, k: int, backend: str, rpad: int,
                   windows, gi: int) -> tuple[FactorResidency, ...]:
    if total is None:
        return ()
    rows_list = per_mode if per_mode is not None else (total,) * k
    slab = min(rpad, _kernel.RANK_SLAB)
    states = []
    for i, rows in enumerate(rows_list):
        if backend == STREAM_BACKEND:
            w, cols = windows[i], min(rpad, _kernel.STREAM_RANK_SLAB)
            # A window covering every tile is whole residency in effect.
            pol = "whole" if w >= factor_row_tiles(rows) else "stream"
            resident = w * FACTOR_ROW_TILE * cols * gi
        else:
            pol = "slab" if backend == "pallas_fused_gather_tiled" else \
                "whole"
            cols = slab if pol == "slab" else rpad
            w, resident = factor_row_tiles(rows), rows * cols * gi
        states.append(FactorResidency(rows=rows, policy=pol, window_tiles=w,
                                      rank_cols=cols,
                                      resident_bytes=resident))
    return tuple(states)


def plan_residency(*, nmodes: int, rank: int, blk: int = 512,
                   tile_rows: int = 8, factor_rows=None,
                   smem_budget: int = SMEM_BUDGET_BYTES,
                   l2_budget: int = L2_BUDGET_BYTES,
                   gather_itemsize: int = 4,
                   window_tiles=None) -> ResidencyPlan:
    """The residency ladder for one mode step: the first rung of
    :data:`LADDER` that fits (:func:`backend_fits`) wins.

      1. ``pallas_fused_gather`` (B1): every input factor at the padded
         rank fits ``l2_budget``, a CTA fits ``smem_budget``;
      2. ``pallas_fused_gather_tiled`` (B2): the same with one
         ``RANK_SLAB``-wide slab;
      3. ``pallas_fused_gather_stream`` (B6): the data-blind window
         ``min(blk, ceil(rows / FACTOR_ROW_TILE))`` per mode fits
         ``smem_budget``; no data is read (the mode step then tightens
         the windows to the data, which only shrinks them);
      4. ``pallas_fused`` (B3): a CTA at the padded rank, with a ring of
         one stage of K pre-gathered rows, fits ``smem_budget``;
      5. ``pallas_fused_tiled`` (B4): the same one slab wide;
      6. ``pallas`` (B5): always — it splits the columns itself.

    Rungs 1–3 need ``factor_rows`` (per input mode, or the total) and are
    skipped without it. ``window_tiles`` (one width per input mode)
    overrides rung 3's data-blind windows, as in the reference. ``gather_itemsize`` (2: bf16 gathers) sizes the
    factors in L2, B6's windows and B3/B4's ring, as the reference's
    sizes its VMEM. Since every
    test is ``bytes <= budget``, a larger budget never moves the choice
    down the ladder, at either itemsize. The reference's first rung, ``rank < MIN_MXU_RANK``
    → ``ref``, is left out: it avoids padding a small rank to the TPU's
    128-wide MXU, while the port pads to 16 and ``ref`` is plain PyTorch,
    not a kernel.

    Each call counts ``planner.plans`` and the chosen plan's bytes,
    ``planner.smem.plan_bytes`` and ``planner.l2.plan_bytes`` (labelled
    with the backend): the Hopper ladder's two budgets in place of the
    reference's one ``planner.vmem.plan_bytes``.
    """
    k, rpad = nmodes - 1, _kernel.padded_rank(rank)
    per_mode, total = _normalize_factor_rows(factor_rows, k)
    fit_kw = dict(nmodes=nmodes, rank=rank, blk=blk, tile_rows=tile_rows,
                  factor_rows=factor_rows, smem_budget=smem_budget,
                  l2_budget=l2_budget, gather_itemsize=gather_itemsize,
                  window_tiles=window_tiles)
    for backend in LADDER:
        if not backend_fits(backend, **fit_kw):
            continue
        smem, l2, windows = _rung_cost(
            backend, k=k, rpad=rpad, tile_rows=tile_rows, blk=blk,
            per_mode=per_mode, total=total, gi=gather_itemsize,
            window_tiles=window_tiles)
        _obs.add("planner.plans")
        _obs.add("planner.smem.plan_bytes", int(smem), backend=backend)
        _obs.add("planner.l2.plan_bytes", int(l2), backend=backend)
        return ResidencyPlan(
            backend=backend, nmodes=nmodes, rank=rank, blk=blk,
            tile_rows=tile_rows, smem_budget=smem_budget,
            l2_budget=l2_budget, gather_itemsize=gather_itemsize,
            smem_bytes=smem, l2_bytes=l2,
            rank_slabs=rung_slabs(backend, rank), window_tiles=windows,
            factors=_factor_states(per_mode, total, k, backend, rpad,
                                   windows, gather_itemsize)
            if backend in _FACTOR_RUNGS else ())
    raise AssertionError("the last rung always fits")


# ---------------------------------------------------------------------------
# Chunk planning (shared by the executor and the traffic predictor)
# ---------------------------------------------------------------------------

def chunk_boundaries(tile_of_block, max_blocks: int) -> list[tuple[int, int]]:
    """Split the blocks into ``[start, stop)`` chunks of at most
    ``max_blocks``, each ending at the last output-tile edge it holds;
    a tile's run longer than ``max_blocks`` is split mid-tile.

    The reference walks back from each chunk's end one block at a time;
    this finds the same edge among the positions where the tile changes.
    """
    if max_blocks < 1:
        raise ValueError(f"max_blocks={max_blocks} must be >= 1")
    tiles = np.asarray(torch.as_tensor(tile_of_block).cpu())
    num_blocks = len(tiles)
    edges = np.flatnonzero(tiles[1:] != tiles[:-1]) + 1
    bounds = []
    start = 0
    while start < num_blocks:
        stop = min(start + max_blocks, num_blocks)
        if stop < num_blocks:
            i = np.searchsorted(edges, stop, side="right") - 1
            if i >= 0 and edges[i] > start:
                stop = int(edges[i])
        bounds.append((start, stop))
        start = stop
    return bounds


def chunk_window_tiles(distinct_counts, chunks, windows):
    """Per-chunk window widths: each chunk's own per-block distinct-tile
    maximum per mode, within ``[1, windows[i]]``. One ``K``-tuple per
    chunk."""
    dc = np.asarray(torch.as_tensor(distinct_counts).cpu())
    k = dc.shape[1]
    if len(windows) != k:
        raise ValueError(f"{len(windows)} windows for {k} input modes")
    return [tuple(int(min(windows[i], max(1, int(dc[start:stop, i].max()))))
                  for i in range(k))
            for start, stop in chunks]


def stream_chunk_bytes(blk: int, k: int, windows) -> int:
    """Aligned-operand bytes one block adds to a chunk: value, local row
    and ``K`` indices per slot, and one schedule entry per window slot."""
    return blk * (4 + 4 + 4 * k) + 4 * sum(windows)


def stream_windows(distinct_counts, factor_rows: Sequence[int], blk: int,
                   frow_tile: int = FACTOR_ROW_TILE) -> tuple[int, ...]:
    """Global window per input mode: the data-blind bound tightened to the
    largest per-block distinct-tile count."""
    top = torch.as_tensor(distinct_counts).amax(0).tolist()
    return tuple(int(min(stream_window_tiles(blk, int(r), frow_tile),
                         max(1, int(m))))
                 for r, m in zip(factor_rows, top))


def plan_chunks(tile_of_block, distinct_counts, windows, *, blk: int,
                max_chunk_bytes: int | None):
    """``(chunks, chunk_windows)``: the executor's chunking of the block
    stream under ``max_chunk_bytes`` (``None``: one chunk), and each
    chunk's tightened window widths."""
    num_blocks = len(tile_of_block)
    if max_chunk_bytes is None:
        max_blocks = num_blocks
    else:
        max_blocks = max(1, max_chunk_bytes // stream_chunk_bytes(
            blk, len(windows), windows))
    chunks = chunk_boundaries(tile_of_block, max_blocks)
    return chunks, chunk_window_tiles(distinct_counts, chunks, windows)


# ---------------------------------------------------------------------------
# Data-dependent stream-traffic prediction
# ---------------------------------------------------------------------------

def block_tile_analysis(per_block_tiles: torch.Tensor):
    """Per-block sorted-distinct analysis of ``(num_blocks, blk, K)`` tile
    ids. Returns ``(sorted_tiles, first, rank_of, distinct_counts)``: the
    per-block sorted tiles, the first-occurrence mask, each slot's
    distinct rank and the ``(num_blocks, K)`` distinct-tile counts. The
    one analysis behind the schedules, the windows, the counted
    ``StreamStats`` and :func:`predict_stream_traffic`."""
    st = torch.sort(per_block_tiles, dim=1).values
    first = torch.cat([torch.ones_like(st[:, :1], dtype=torch.bool),
                       st[:, 1:] != st[:, :-1]], dim=1)
    rank_of = torch.cumsum(first, dim=1, dtype=torch.int32) - 1
    distinct_counts = first.sum(dim=1)
    return st, first, rank_of, distinct_counts


@dataclasses.dataclass(frozen=True)
class StreamTraffic:
    """Predicted tile-fetch traffic of one streamed mode step, counted
    from the data; equal to the executor's ``StreamStats``."""

    ordering: str                   # stream the prediction was made on
    num_blocks: int
    nnz: int
    window_tiles: tuple[int, ...]   # global tightened widths, per input mode
    scheduled_tiles: int            # Σ_chunks blocks_c * Σ chunk windows
    distinct_tiles: int             # Σ per-block distinct, all modes
    tile_bytes: int                 # one frow_tile x slab tile
    rank_slabs: int
    chunks: int = 1

    @property
    def scheduled_tile_bytes(self) -> int:
        return self.scheduled_tiles * self.tile_bytes * self.rank_slabs

    @property
    def distinct_tile_bytes(self) -> int:
        return self.distinct_tiles * self.tile_bytes * self.rank_slabs

    @property
    def scheduled_over_distinct(self) -> float:
        """The tile re-fetch factor an ordering attacks (>= 1.0)."""
        return self.scheduled_tiles / max(self.distinct_tiles, 1)


def stream_slabs(rank: int, rank_slab: int, rank_multiple: int
                 ) -> tuple[int, int, int]:
    """``(padded rank, slab width, slab count)`` of the stream kernel."""
    rpad = _kernel.padded_rank(rank, rank_multiple)
    slab = min(rpad, rank_slab)
    if rpad % slab:
        raise ValueError(f"padded rank {rpad} is not a multiple of the "
                         f"slab {slab}")
    return rpad, slab, rpad // slab


def predict_stream_traffic(idx, valid, *, mode: int, rows_cap: int,
                           blk: int, tile_rows: int, rank: int,
                           factor_rows: Sequence[int],
                           row_offset: int = 0,
                           ordering: str = "as-given",
                           max_chunk_bytes: int | None = None,
                           frow_tile: int = FACTOR_ROW_TILE,
                           rank_slab: int = _kernel.STREAM_RANK_SLAB,
                           rank_multiple: int = _kernel.RANK_MULTIPLE,
                           gather_itemsize: int = 4) -> StreamTraffic:
    """Predict the stream kernel's tile traffic for a nonzero stream.

    The executor's own arithmetic on the stream it would run — block
    layout, aligned index streams, :func:`block_tile_analysis`, windows,
    chunks — without a kernel. Input contract as the executor's:
    ``idx (cap, N)`` valid-first with output-tile runs contiguous and
    ascending. ``factor_rows`` are the input modes' factor row counts;
    ``gather_itemsize`` (2 for bf16 gathers) sizes a tile's bytes.
    """
    idx = torch.as_tensor(idx)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=idx.device)
    in_modes = [w for w in range(idx.shape[1]) if w != mode]
    k = len(in_modes)
    if len(factor_rows) != k:
        raise ValueError(f"{len(factor_rows)} factor row counts for {k} "
                         "input modes")
    local_row = torch.where(valid, idx[:, mode].long() - row_offset, 0)
    n_pad = _ops.n_pad_for(idx.shape[0], rows_cap, blk, tile_rows)
    slot, tile_of_block = _ops.build_block_layout(
        local_row, valid, rows_cap=rows_cap, blk=blk, tile_rows=tile_rows)
    idx_in = torch.where(valid[:, None], idx[:, in_modes].long(), 0)
    aligned = _ops._align_to_blocks(idx_in, slot, n_pad)   # padding -> 0
    per_block = torch.div(aligned, frow_tile,
                          rounding_mode="floor").reshape(-1, blk, k)
    _, _, _, dcounts = block_tile_analysis(per_block)
    windows = stream_windows(dcounts, factor_rows, blk, frow_tile)
    chunks, cwindows = plan_chunks(tile_of_block, dcounts, windows, blk=blk,
                                   max_chunk_bytes=max_chunk_bytes)
    scheduled = sum((stop - start) * sum(cw)
                    for (start, stop), cw in zip(chunks, cwindows))
    _, slab, slabs = stream_slabs(rank, rank_slab, rank_multiple)
    return StreamTraffic(
        ordering=ordering,
        num_blocks=per_block.shape[0],
        nnz=int(valid.sum()),
        window_tiles=windows,
        scheduled_tiles=int(scheduled),
        distinct_tiles=int(dcounts.sum()),
        tile_bytes=frow_tile * slab * gather_itemsize,
        rank_slabs=slabs,
        chunks=len(chunks),
    )
