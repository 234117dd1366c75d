"""In-kernel-gather fused spMTTKRP: CUDA kernels and their plain versions.

Port of ``repro/kernels/mttkrp/kernel.py``'s ``fused_mttkrp_nmode_gather``
(B1), ``fused_mttkrp_nmode_gather_tiled`` (B2) and
``fused_mttkrp_nmode_gather_stream`` (B6). The wrappers keep the JAX
signatures. On a CUDA tensor they launch the hand-written kernels in
``csrc/gather_mttkrp.cu`` (B1, B2) and ``csrc/gather_stream_mttkrp.cu``
(B6), built for ``sm_90a`` at first use, or raise; on a CPU tensor they
run the plain PyTorch version beside them (``*_plain``), which the tests
hold against the JAX package. Nothing falls back from one to the other.
Each wrapper counts its kernel launches in its ``launches`` attribute.

Geometry is re-derived for Hopper, not copied from the TPU:

* ``RANK_MULTIPLE = 16`` — the rank is padded so a factor row is a whole
  number of 64-byte segments and 16 or 32 threads split its columns (the
  TPU padded to the 128-wide MXU).
* ``RANK_SLAB = 128`` — the tiled kernel's default column slab.
* ``ROW_SLOTS = 128`` — one CTA holds ``groups ≈ ROW_SLOTS // tile_rows``
  private partial tiles (a power of two in 1..16). It depends on
  ``tile_rows`` only, so the untiled, the tiled and the stream kernel add
  in the same order and agree bitwise.
* ``FACTOR_ROW_TILE = 8`` and ``STREAM_RANK_SLAB = 16`` — the stream
  kernel's window unit is an 8-row x 16-column factor tile, 512 B: four
  128-byte lines, copied with sixteen 16-byte ``cp.async``. The TPU's
  128 x 128 tile (64 KiB) suits a DMA engine and 64 MiB of VMEM; a CTA
  here has 227 KB of shared memory. With these, a block of ``blk <= 128``
  nonzeros and K <= 3 input modes fits the data-blind window bound
  ``min(blk, ceil(rows / 8))`` per mode (3 x 128 tiles = 192 KiB plus
  8 KiB of partial tiles and the staged block) for any index data, so the
  stream rung never needs an ordering to run; an ordering shrinks the
  window and the bytes copied. A taller tile copies more rows that no
  nonzero of the block reads; a shorter one lengthens the schedules the
  kernel scans for every nonzero.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...runtime.device import require_sm90
from . import build as _build

__all__ = [
    "FACTOR_ROW_TILE",
    "RANK_MULTIPLE",
    "RANK_SLAB",
    "ROW_SLOTS",
    "SMEM_LIMIT_BYTES",
    "STREAM_BACKEND_NAME",
    "STREAM_RANK_SLAB",
    "StreamCarry",
    "gather_stream_smem_bytes",
    "padded_rank",
    "fused_mttkrp_nmode_gather",
    "fused_mttkrp_nmode_gather_plain",
    "fused_mttkrp_nmode_gather_stream",
    "fused_mttkrp_nmode_gather_stream_chunk",
    "fused_mttkrp_nmode_gather_stream_plain",
    "fused_mttkrp_nmode_gather_tiled",
    "fused_mttkrp_nmode_gather_tiled_plain",
]

RANK_MULTIPLE = 16
RANK_SLAB = 128
ROW_SLOTS = 128
MAX_IN_MODES = 4
# Dynamic shared memory one CTA may use on an H100 (227 KB).
SMEM_LIMIT_BYTES = 232_448
FACTOR_ROW_TILE = 8
STREAM_RANK_SLAB = 16
STREAM_BACKEND_NAME = "pallas_fused_gather_stream"
# Stream slots a CTA stages in shared memory at a time (kChunk in the .cu).
STAGE_SLOTS = 2048
# Elements of one (chunk, R) temporary in the plain version (~256 MB).
_PLAIN_CHUNK_ELEMS = 1 << 26


def padded_rank(rank: int, multiple: int = RANK_MULTIPLE) -> int:
    """``rank`` rounded up to ``multiple``."""
    return rank + (-rank) % multiple


def _rank_of(factors) -> int:
    """Column count of the first factor matrix (0 if there is none)."""
    factors = tuple(factors)
    return factors[0].shape[1] if factors else 0


def _groups(tile_rows: int) -> int:
    """Partial tiles per CTA: the power of two nearest below
    ``ROW_SLOTS // tile_rows``, within 1..16 (so a CTA has at most
    16 x 32 = 512 threads)."""
    g = max(1, min(ROW_SLOTS // tile_rows, 16))
    return 1 << (g.bit_length() - 1)


def _check_args(vals, idx_stream, factors, local_row_in_tile, tile_of_block,
                *, rows_cap: int, blk: int, tile_rows: int, slab: int,
                out_init):
    """Shapes, dtypes and devices both versions require.

    Returns ``(factors, R)`` with ``factors`` as a tuple.
    """
    factors = tuple(factors)
    if not 1 <= len(factors) <= MAX_IN_MODES:
        raise ValueError(f"need 1..{MAX_IN_MODES} input-factor matrices "
                         f"(tensor order 2..5), got {len(factors)}")
    if vals.dtype != torch.float32 or vals.dim() != 1:
        raise ValueError(f"vals must be (n_pad,) float32, got "
                         f"{tuple(vals.shape)} {vals.dtype}")
    n_pad = vals.shape[0]
    if idx_stream.shape != (n_pad, len(factors)) \
            or idx_stream.dtype != torch.int32:
        raise ValueError(f"idx_stream must be ({n_pad}, {len(factors)}) "
                         f"int32, got {tuple(idx_stream.shape)} "
                         f"{idx_stream.dtype}")
    if local_row_in_tile.shape != (n_pad,) \
            or local_row_in_tile.dtype != torch.int32:
        raise ValueError("local_row_in_tile must be (n_pad,) int32")
    if n_pad % blk:
        raise ValueError(f"stream length {n_pad} is not a multiple of "
                         f"blk={blk}")
    if tile_of_block.shape != (n_pad // blk,) \
            or tile_of_block.dtype != torch.int32:
        raise ValueError(f"tile_of_block must be ({n_pad // blk},) int32")
    if rows_cap % tile_rows:
        raise ValueError(f"rows_cap={rows_cap} is not a multiple of "
                         f"tile_rows={tile_rows}")
    rank = factors[0].shape[1]
    for f in factors:
        if f.dim() != 2 or f.shape[1] != rank or f.dtype != torch.float32:
            raise ValueError("factors must be (rows, R) float32 with one R")
    if rank % slab or slab % RANK_MULTIPLE:
        raise ValueError(
            f"rank {rank} must be a multiple of the slab {slab}, itself a "
            f"multiple of {RANK_MULTIPLE} (pad with ops.pad_rank)")
    if out_init is not None and (out_init.shape != (rows_cap, rank)
                                 or out_init.dtype != torch.float32):
        raise ValueError(f"out_init must be ({rows_cap}, {rank}) float32")
    tensors = (vals, idx_stream, local_row_in_tile, tile_of_block) \
        + factors + ((out_init,) if out_init is not None else ())
    if any(t.device != vals.device for t in tensors):
        raise ValueError("all operands must be on one device")
    return factors, rank


def _plain(vals, idx_stream, factors, local_row_in_tile, tile_of_block, *,
           rows_cap: int, blk: int, tile_rows: int, out_init):
    rank = factors[0].shape[1]
    rows = (torch.repeat_interleave(tile_of_block.long(), blk) * tile_rows
            + local_row_in_tile.long())
    out = (torch.zeros(rows_cap, rank, dtype=torch.float32,
                       device=vals.device)
           if out_init is None else out_init.clone())
    step = max(blk, _PLAIN_CHUNK_ELEMS // rank)
    for lo in range(0, vals.shape[0], step):
        contrib = vals[lo:lo + step, None]
        for w, f in enumerate(factors):
            contrib = contrib * f.index_select(
                0, idx_stream[lo:lo + step, w].long())
        out.index_add_(0, rows[lo:lo + step], contrib)
    return out


def _launch(vals, idx_stream, factors, local_row_in_tile, tile_of_block, *,
            rows_cap: int, blk: int, tile_rows: int, slab: int, out_init):
    dev = vals.device
    require_sm90(dev)
    rank = factors[0].shape[1]
    groups = _groups(tile_rows)
    lanes = 32 if slab % 32 == 0 else 16
    smem = (groups * tile_rows * slab + STAGE_SLOTS * (2 + len(factors))) * 4
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"a {tile_rows} x {slab} output tile with {groups} partials needs "
            f"{smem} B of shared memory (> {SMEM_LIMIT_BYTES}); use the tiled "
            "kernel with a narrower rank_slab")
    tensors = (vals, idx_stream, local_row_in_tile, tile_of_block) + factors
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all operands must be contiguous")
    num_tiles = rows_cap // tile_rows
    blk_start = torch.searchsorted(
        tile_of_block,
        torch.arange(num_tiles + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    out = (torch.zeros(rows_cap, rank, dtype=torch.float32, device=dev)
           if out_init is None else out_init.contiguous().clone())
    ptrs = [f.data_ptr() for f in factors] + [0] * (MAX_IN_MODES
                                                     - len(factors))
    nrows = [f.shape[0] for f in factors] + [0] * (MAX_IN_MODES
                                                   - len(factors))
    lib = _build.load("gather_mttkrp")
    err = lib.gather_mttkrp_launch(
        vals.data_ptr(), idx_stream.data_ptr(), local_row_in_tile.data_ptr(),
        blk_start.data_ptr(), *ptrs, *nrows, out.data_ptr(), len(factors),
        num_tiles, rank // slab, blk, tile_rows, rank, slab, groups, lanes,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            "gather_mttkrp launch failed: "
            f"{lib.gather_mttkrp_error_string(err).decode()} ({err})")
    return out


def _dispatch(vals, idx_stream, factors, local_row_in_tile, tile_of_block,
              *, rows_cap, blk, tile_rows, slab, out_init):
    """CPU tensor: plain version; CUDA tensor: the kernel.

    Returns ``(out, launched)``.
    """
    kw = dict(rows_cap=rows_cap, blk=blk, tile_rows=tile_rows,
              out_init=out_init)
    if vals.device.type == "cpu":
        return _plain(vals, idx_stream, factors, local_row_in_tile,
                      tile_of_block, **kw), False
    if vals.device.type != "cuda":
        raise ValueError(f"unsupported device {vals.device}")
    return _launch(vals, idx_stream, factors, local_row_in_tile,
                   tile_of_block, slab=slab, **kw), True


def fused_mttkrp_nmode_gather(vals, idx_stream, factors, local_row_in_tile,
                              tile_of_block, *, rows_cap: int, blk: int = 512,
                              tile_rows: int = 8, out_init=None):
    """Factor-resident in-kernel gather (B1): one column slab = the rank.

    Args:
      vals: ``(n_pad,)`` float32 block-aligned values; padding slots 0.
      idx_stream: ``(n_pad, K)`` int32 factor row per slot and input mode
        (K = N−1, in the order of ``factors``); padding points at row 0.
      factors: K ``(I_w, R)`` float32 input-factor matrices, R a multiple
        of :data:`RANK_MULTIPLE` (``ops.pad_rank``).
      local_row_in_tile: ``(n_pad,)`` int32 row within the block's tile.
      tile_of_block: ``(n_pad // blk,)`` int32 output tile per block,
        non-decreasing.
      rows_cap: output rows, a multiple of ``tile_rows``.
      out_init: optional ``(rows_cap, R)`` float32 the sum starts from
        (``None``: zeros). It is not modified.

    Returns ``(rows_cap, R)`` float32.
    """
    factors, rank = _check_args(
        vals, idx_stream, factors, local_row_in_tile, tile_of_block,
        rows_cap=rows_cap, blk=blk, tile_rows=tile_rows, slab=_rank_of(factors),
        out_init=out_init)
    out, launched = _dispatch(
        vals, idx_stream, factors, local_row_in_tile, tile_of_block,
        rows_cap=rows_cap, blk=blk, tile_rows=tile_rows, slab=rank,
        out_init=out_init)
    if launched:
        fused_mttkrp_nmode_gather.launches += 1
    return out


fused_mttkrp_nmode_gather.launches = 0


def fused_mttkrp_nmode_gather_tiled(vals, idx_stream, factors,
                                    local_row_in_tile, tile_of_block, *,
                                    rows_cap: int, blk: int = 512,
                                    tile_rows: int = 8,
                                    rank_slab: int = RANK_SLAB,
                                    out_init=None):
    """Rank-slabbed in-kernel gather (B2): a grid axis over column slabs.

    Same contract as :func:`fused_mttkrp_nmode_gather`, with R a multiple
    of ``rank_slab``. Each slab is a separate set of CTAs that reads only
    its ``rank_slab`` columns of every factor and holds a ``tile_rows x
    rank_slab`` output tile; the stream is re-read once per slab. Bitwise
    equal to the untiled kernel on the same inputs.
    """
    factors, _ = _check_args(
        vals, idx_stream, factors, local_row_in_tile, tile_of_block,
        rows_cap=rows_cap, blk=blk, tile_rows=tile_rows, slab=rank_slab,
        out_init=out_init)
    out, launched = _dispatch(
        vals, idx_stream, factors, local_row_in_tile, tile_of_block,
        rows_cap=rows_cap, blk=blk, tile_rows=tile_rows, slab=rank_slab,
        out_init=out_init)
    if launched:
        fused_mttkrp_nmode_gather_tiled.launches += 1
    return out


fused_mttkrp_nmode_gather_tiled.launches = 0


def fused_mttkrp_nmode_gather_plain(vals, idx_stream, factors,
                                    local_row_in_tile, tile_of_block, *,
                                    rows_cap: int, blk: int = 512,
                                    tile_rows: int = 8, out_init=None):
    """Plain PyTorch version of B1 (``index_select`` + ``index_add_``).

    Runs on any device; the sum order differs from the kernel's, so the
    two agree to fp32 rounding, not bitwise.
    """
    factors, rank = _check_args(
        vals, idx_stream, factors, local_row_in_tile, tile_of_block,
        rows_cap=rows_cap, blk=blk, tile_rows=tile_rows,
        slab=_rank_of(factors), out_init=out_init)
    return _plain(vals, idx_stream, factors, local_row_in_tile,
                  tile_of_block, rows_cap=rows_cap, blk=blk,
                  tile_rows=tile_rows, out_init=out_init)


def fused_mttkrp_nmode_gather_tiled_plain(vals, idx_stream, factors,
                                          local_row_in_tile, tile_of_block,
                                          *, rows_cap: int, blk: int = 512,
                                          tile_rows: int = 8,
                                          rank_slab: int = RANK_SLAB,
                                          out_init=None):
    """Plain PyTorch version of B2: the columns are independent, so it is
    B1's plain version after B2's argument checks."""
    factors, _ = _check_args(
        vals, idx_stream, factors, local_row_in_tile, tile_of_block,
        rows_cap=rows_cap, blk=blk, tile_rows=tile_rows, slab=rank_slab,
        out_init=out_init)
    return _plain(vals, idx_stream, factors, local_row_in_tile,
                  tile_of_block, rows_cap=rows_cap, blk=blk,
                  tile_rows=tile_rows, out_init=out_init)


# ---------------------------------------------------------------------------
# B6: the out-of-core stream kernel
# ---------------------------------------------------------------------------

def gather_stream_smem_bytes(num_in_modes: int, rank_padded: int, blk: int,
                             tile_rows: int, window_tiles,
                             frow_tile: int = FACTOR_ROW_TILE,
                             rank_slab: int = STREAM_RANK_SLAB) -> int:
    """Shared memory of one CTA of the stream kernel (B6).

    The Hopper counterpart of the reference's ``gather_stream_vmem_bytes``:
    the ``groups`` partial output tiles, the factor-tile window (per
    input mode ``window_tiles`` tiles of ``frow_tile`` rows, one slab
    wide), the window's schedule row, and the staged block (value, local
    row and one window row per input mode for each of ``blk`` slots).
    ``window_tiles`` is an int for every mode or a per-mode sequence.
    The layout is the kernel's (``csrc/gather_stream_mttkrp.cu``).
    """
    if isinstance(window_tiles, int):
        window_tiles = (window_tiles,) * num_in_modes
    if len(window_tiles) != num_in_modes:
        raise ValueError(f"{len(window_tiles)} window widths for "
                         f"{num_in_modes} input modes")
    slab = min(rank_padded, rank_slab)
    wsum = sum(int(w) for w in window_tiles)
    return 4 * (_groups(tile_rows) * tile_rows * slab
                + wsum * frow_tile * slab
                + wsum
                + blk * (2 + num_in_modes))


class StreamCarry(NamedTuple):
    """Pending sums of the output tile a stream-kernel call left open.

    A chunk of the block stream may end inside an output tile's run. The
    kernel then keeps that tile's ``groups`` private partial tiles here
    instead of reducing them, and the next call, whose run starts with
    the same tile, continues from them. The result is bitwise that of
    one call over both chunks. The plain version adds everything to
    ``out`` at once, so its carry holds zeros and it reads none.
    """

    tile: int                  # the open output tile
    slots: int                 # slots of its run consumed so far
    partials: torch.Tensor     # (num_slabs, groups, tile_rows, slab) f32


def _check_stream_args(vals, idx_stream, factors, local_row_in_tile,
                       tile_of_block, tile_schedules, *, rows_cap: int,
                       blk: int, tile_rows: int, frow_tile: int,
                       rank_slab: int, out_init):
    """B1's checks plus the schedules and the row padding.

    Returns ``(factors, schedules, R)`` as tuples.
    """
    factors, rank = _check_args(
        vals, idx_stream, factors, local_row_in_tile, tile_of_block,
        rows_cap=rows_cap, blk=blk, tile_rows=tile_rows, slab=rank_slab,
        out_init=out_init)
    scheds = tuple(tile_schedules)
    num_blocks = vals.shape[0] // blk
    if len(scheds) != len(factors):
        raise ValueError(f"{len(scheds)} tile schedules for "
                         f"{len(factors)} input-factor matrices")
    for w, (f, s) in enumerate(zip(factors, scheds)):
        if f.shape[0] % frow_tile:
            raise ValueError(
                f"factor {w} has {f.shape[0]} rows, not a multiple of "
                f"frow_tile={frow_tile} (pad with ops._pad_factor_rows)")
        if s.dim() != 2 or s.shape[0] != num_blocks or s.shape[1] < 1 \
                or s.dtype != torch.int32 or s.device != vals.device:
            raise ValueError(
                f"tile_schedules[{w}] must be ({num_blocks}, W) int32 with "
                f"W >= 1 on {vals.device}, got {tuple(s.shape)} {s.dtype}")
    return factors, scheds, rank


def _carry_meta(tile_of_block, carry, split_tail: bool, blk: int):
    """``(tile, slots)`` of the carry a call hands on, or ``None``."""
    if carry is not None and carry.tile != int(tile_of_block[0]):
        raise ValueError(f"the carry holds tile {carry.tile} but the call "
                         f"starts with tile {int(tile_of_block[0])}")
    if not split_tail:
        return None
    tail = int(tile_of_block[-1])
    slots = int((tile_of_block == tail).sum()) * blk
    if carry is not None and carry.tile == tail:
        slots += carry.slots
    return tail, slots


def _plain_stream(vals, idx_stream, factors, local_row_in_tile,
                  tile_of_block, scheds, *, rows_cap: int, blk: int,
                  tile_rows: int, frow_tile: int, out_init):
    """B1's plain sum, with a slot whose factor tile is missing from its
    block's schedule row (in any input mode) adding nothing."""
    rank = factors[0].shape[1]
    dev = vals.device
    rows = (torch.repeat_interleave(tile_of_block.long(), blk) * tile_rows
            + local_row_in_tile.long())
    out = (torch.zeros(rows_cap, rank, dtype=torch.float32, device=dev)
           if out_init is None else out_init.clone())
    width = max(s.shape[1] for s in scheds)
    step = max(blk, _PLAIN_CHUNK_ELEMS // max(rank, width))
    for lo in range(0, vals.shape[0], step):
        sl = slice(lo, lo + step)
        block = torch.div(torch.arange(lo, lo + vals[sl].shape[0],
                                       device=dev), blk,
                          rounding_mode="floor")
        contrib = vals[sl, None]
        keep = torch.ones_like(vals[sl], dtype=torch.bool)
        for w, (f, s) in enumerate(zip(factors, scheds)):
            ix = idx_stream[sl, w].long()
            inside = (ix >= 0) & (ix < f.shape[0])
            ix = torch.where(inside, ix, 0)
            tile = torch.div(ix, frow_tile, rounding_mode="floor")
            hit = (s[block].long() == tile[:, None]).any(1)
            keep &= inside & hit
            contrib = contrib * f.index_select(0, ix)
        contrib = torch.where(keep[:, None], contrib, 0.0)
        out.index_add_(0, rows[sl], contrib)
    return out


def _launch_stream(vals, idx_stream, factors, local_row_in_tile,
                   tile_of_block, scheds, *, rows_cap: int, blk: int,
                   tile_rows: int, frow_tile: int, slab: int, out_init,
                   carry, tail):
    dev = vals.device
    require_sm90(dev)
    k, rank = len(factors), factors[0].shape[1]
    groups = _groups(tile_rows)
    lanes = 32 if slab % 32 == 0 else 16
    windows = tuple(s.shape[1] for s in scheds)
    smem = gather_stream_smem_bytes(k, rank, blk, tile_rows, windows,
                                    frow_tile=frow_tile, rank_slab=slab)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"the stream kernel's window of {windows} tiles of {frow_tile} "
            f"x {slab} floats per input mode, with blk={blk} and "
            f"tile_rows={tile_rows}, needs {smem} B of shared memory "
            f"(> {SMEM_LIMIT_BYTES} B); use a smaller blk or frow_tile, a "
            "locality ordering, or smaller chunks")
    tensors = (vals, idx_stream, local_row_in_tile, tile_of_block) \
        + factors + scheds
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all operands must be contiguous")
    if any(f.data_ptr() % 16 for f in factors):
        raise ValueError("factor matrices must be 16-byte aligned")
    num_tiles, num_slabs = rows_cap // tile_rows, rank // slab
    part_shape = (num_slabs, groups, tile_rows, slab)
    if carry is not None and (tuple(carry.partials.shape) != part_shape
                              or carry.partials.device != dev
                              or not carry.partials.is_contiguous()):
        raise ValueError(f"carry partials must be {part_shape} float32 on "
                         f"{dev}")
    blk_start = torch.searchsorted(
        tile_of_block,
        torch.arange(num_tiles + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    out = (torch.zeros(rows_cap, rank, dtype=torch.float32, device=dev)
           if out_init is None else out_init.contiguous().clone())
    carry_out = (torch.empty(part_shape, dtype=torch.float32, device=dev)
                 if tail is not None else None)
    pad = [0] * (MAX_IN_MODES - k)
    lib = _build.load("gather_stream_mttkrp")
    err = lib.gather_stream_mttkrp_launch(
        vals.data_ptr(), idx_stream.data_ptr(), local_row_in_tile.data_ptr(),
        blk_start.data_ptr(), *[f.data_ptr() for f in factors], *pad,
        *[f.shape[0] for f in factors], *pad,
        *[s.data_ptr() for s in scheds], *pad, *windows, *pad,
        out.data_ptr(),
        carry.partials.data_ptr() if carry is not None else 0,
        carry_out.data_ptr() if carry_out is not None else 0,
        k, num_tiles, num_slabs, blk, tile_rows, rank, slab, groups, lanes,
        frow_tile,
        carry.tile if carry is not None else -1,
        carry.slots % groups if carry is not None else 0,
        tail[0] if tail is not None else -1,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            "gather_stream_mttkrp launch failed: "
            f"{lib.gather_stream_mttkrp_error_string(err).decode()} ({err})")
    return out, carry_out


def fused_mttkrp_nmode_gather_stream_chunk(
        vals, idx_stream, factors, local_row_in_tile, tile_of_block,
        tile_schedules, *, rows_cap: int, blk: int = 128, tile_rows: int = 8,
        frow_tile: int = FACTOR_ROW_TILE, rank_slab: int = STREAM_RANK_SLAB,
        out_init=None, carry: StreamCarry | None = None,
        split_tail: bool = False):
    """One call of the stream kernel over one chunk of the block stream.

    :func:`fused_mttkrp_nmode_gather_stream` with the state the chunked
    executor threads between calls: ``carry`` (from the previous call)
    holds the pending sums of this call's first tile, and
    ``split_tail=True`` says the last tile's run goes on in the next
    call, so its sums are handed on instead of added to ``out``.

    Returns ``(out, carry)``: ``carry`` is a :class:`StreamCarry` when
    ``split_tail``, else ``None``.
    """
    factors, scheds, _ = _check_stream_args(
        vals, idx_stream, factors, local_row_in_tile, tile_of_block,
        tile_schedules, rows_cap=rows_cap, blk=blk, tile_rows=tile_rows,
        frow_tile=frow_tile, rank_slab=rank_slab, out_init=out_init)
    tail = _carry_meta(tile_of_block, carry, split_tail, blk)
    kw = dict(rows_cap=rows_cap, blk=blk, tile_rows=tile_rows,
              frow_tile=frow_tile, out_init=out_init)
    if vals.device.type == "cpu":
        out = _plain_stream(vals, idx_stream, factors, local_row_in_tile,
                            tile_of_block, scheds, **kw)
        partials = None
        if tail is not None:
            partials = torch.zeros(
                (factors[0].shape[1] // rank_slab, _groups(tile_rows),
                 tile_rows, rank_slab), dtype=torch.float32)
    elif vals.device.type == "cuda":
        out, partials = _launch_stream(
            vals, idx_stream, factors, local_row_in_tile, tile_of_block,
            scheds, slab=rank_slab, carry=carry, tail=tail, **kw)
        fused_mttkrp_nmode_gather_stream.launches += 1
    else:
        raise ValueError(f"unsupported device {vals.device}")
    if tail is None:
        return out, None
    return out, StreamCarry(tail[0], tail[1], partials)


def fused_mttkrp_nmode_gather_stream(vals, idx_stream, factors,
                                     local_row_in_tile, tile_of_block,
                                     tile_schedules, *, rows_cap: int,
                                     blk: int = 128, tile_rows: int = 8,
                                     frow_tile: int = FACTOR_ROW_TILE,
                                     rank_slab: int = STREAM_RANK_SLAB,
                                     out_init=None):
    """Out-of-core in-kernel gather (B6): factors stay in device memory.

    Same contract as :func:`fused_mttkrp_nmode_gather`, plus:

    * each factor has a multiple of ``frow_tile`` rows
      (``ops._pad_factor_rows``) and R is a multiple of ``rank_slab``
      (a grid axis over column slabs, as in B2);
    * ``tile_schedules[w]`` is ``(num_blocks, W_w)`` int32: row ``b``
      lists the ``frow_tile``-row tiles of factor ``w`` that block ``b``
      may read (``ops.tile_schedule``). Per block the kernel copies those
      tiles, one slab wide, into a shared-memory window; each slot takes
      the first window slot whose tile holds its row. A slot whose tile
      is missing adds nothing.

    The rows read from the window are the rows B1 reads from the whole
    factor, and the kernel adds in B1's order, so the result is bitwise
    B1's on the same stream. Raises when the window does not fit shared
    memory (:func:`gather_stream_smem_bytes`). Returns ``(rows_cap, R)``
    float32.
    """
    out, _ = fused_mttkrp_nmode_gather_stream_chunk(
        vals, idx_stream, factors, local_row_in_tile, tile_of_block,
        tile_schedules, rows_cap=rows_cap, blk=blk, tile_rows=tile_rows,
        frow_tile=frow_tile, rank_slab=rank_slab, out_init=out_init)
    return out


fused_mttkrp_nmode_gather_stream.launches = 0


def fused_mttkrp_nmode_gather_stream_plain(vals, idx_stream, factors,
                                           local_row_in_tile, tile_of_block,
                                           tile_schedules, *, rows_cap: int,
                                           blk: int = 128,
                                           tile_rows: int = 8,
                                           frow_tile: int = FACTOR_ROW_TILE,
                                           rank_slab: int = STREAM_RANK_SLAB,
                                           out_init=None):
    """Plain PyTorch version of B6 (runs on any device): B1's plain sum
    with the schedule test; agrees with the kernel to fp32 rounding."""
    factors, scheds, _ = _check_stream_args(
        vals, idx_stream, factors, local_row_in_tile, tile_of_block,
        tile_schedules, rows_cap=rows_cap, blk=blk, tile_rows=tile_rows,
        frow_tile=frow_tile, rank_slab=rank_slab, out_init=out_init)
    return _plain_stream(vals, idx_stream, factors, local_row_in_tile,
                         tile_of_block, scheds, rows_cap=rows_cap, blk=blk,
                         tile_rows=tile_rows, frow_tile=frow_tile,
                         out_init=out_init)
