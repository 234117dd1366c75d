"""In-kernel-gather fused spMTTKRP: CUDA kernels and their plain versions.

Port of ``repro/kernels/mttkrp/kernel.py``'s ``fused_mttkrp_nmode_gather``
(B1) and ``fused_mttkrp_nmode_gather_tiled`` (B2). Both wrappers keep the
JAX signature. On a CUDA tensor they launch the hand-written kernel in
``csrc/gather_mttkrp.cu`` (built for ``sm_90a`` at first use) or raise; on
a CPU tensor they run the plain PyTorch version beside them
(``*_plain``), which the tests hold against the JAX package. Nothing falls
back from one to the other. Each wrapper counts its kernel launches in
its ``launches`` attribute.

Geometry is re-derived for Hopper, not copied from the TPU:

* ``RANK_MULTIPLE = 16`` — the rank is padded so a factor row is a whole
  number of 64-byte segments and 16 or 32 threads split its columns (the
  TPU padded to the 128-wide MXU).
* ``RANK_SLAB = 128`` — the tiled kernel's default column slab.
* ``ROW_SLOTS = 128`` — one CTA holds ``groups ≈ ROW_SLOTS // tile_rows``
  private partial tiles (a power of two in 1..16). It depends on
  ``tile_rows`` only, so the untiled and the tiled kernel add in the same
  order and agree bitwise.
"""
from __future__ import annotations

import torch

from ...runtime.device import require_sm90
from . import build as _build

__all__ = [
    "RANK_MULTIPLE",
    "RANK_SLAB",
    "ROW_SLOTS",
    "SMEM_LIMIT_BYTES",
    "padded_rank",
    "fused_mttkrp_nmode_gather",
    "fused_mttkrp_nmode_gather_plain",
    "fused_mttkrp_nmode_gather_tiled",
    "fused_mttkrp_nmode_gather_tiled_plain",
]

RANK_MULTIPLE = 16
RANK_SLAB = 128
ROW_SLOTS = 128
MAX_IN_MODES = 4
# Dynamic shared memory one CTA may use on an H100 (227 KB).
SMEM_LIMIT_BYTES = 232_448
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
    lib = _build.load()
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
