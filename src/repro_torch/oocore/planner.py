"""Stream-window and chunk planning for the out-of-core path.

Port of the stream parts of ``repro/oocore/planner.py``: the window
bound, the chunk boundaries and per-chunk windows, the chunk byte
budget, the per-block distinct-tile analysis and the traffic predictor.
Given the same inputs and geometry (``frow_tile``, ``rank_slab``, the
rank multiple) every count equals the reference's. The analysis runs
on the device that holds the stream.

:func:`stream_fits_smem` is the Hopper counterpart of the reference's
``backend_fits(STREAM_BACKEND, ...)``: whether the stream kernel's
window fits one CTA's shared memory. The residency ladder
(``plan_residency``) comes with ``auto`` (ROADMAP A6).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..kernels.mttkrp import kernel as _kernel
from ..kernels.mttkrp import ops as _ops

__all__ = [
    "FACTOR_ROW_TILE",
    "STREAM_BACKEND",
    "StreamTraffic",
    "block_tile_analysis",
    "chunk_boundaries",
    "chunk_window_tiles",
    "factor_row_tiles",
    "plan_chunks",
    "predict_stream_traffic",
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
                     smem_budget: int = _kernel.SMEM_LIMIT_BYTES) -> bool:
    """Does the stream kernel's CTA fit ``smem_budget`` bytes of shared
    memory? Windows default to the data-blind bound per input mode;
    ``window_tiles`` (e.g. :attr:`StreamTraffic.window_tiles`) gives
    measured ones. Monotone in the budget."""
    k = nmodes - 1
    if len(factor_rows) != k:
        raise ValueError(f"{len(factor_rows)} factor row counts for {k} "
                         "input modes")
    windows = (tuple(window_tiles) if window_tiles is not None
               else tuple(stream_window_tiles(blk, r, frow_tile)
                          for r in factor_rows))
    return _kernel.gather_stream_smem_bytes(
        k, _kernel.padded_rank(rank, rank_multiple), blk, tile_rows,
        windows, frow_tile=frow_tile, rank_slab=rank_slab) <= smem_budget


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
                           rank_multiple: int = _kernel.RANK_MULTIPLE
                           ) -> StreamTraffic:
    """Predict the stream kernel's tile traffic for a nonzero stream.

    The executor's own arithmetic on the stream it would run — block
    layout, aligned index streams, :func:`block_tile_analysis`, windows,
    chunks — without a kernel. Input contract as the executor's:
    ``idx (cap, N)`` valid-first with output-tile runs contiguous and
    ascending. ``factor_rows`` are the input modes' factor row counts.
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
        tile_bytes=frow_tile * slab * 4,
        rank_slabs=slabs,
        chunks=len(chunks),
    )
