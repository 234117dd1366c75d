"""Block layout construction and per-mode MTTKRP dispatch, in PyTorch.

Port of ``repro/kernels/mttkrp/ops.py`` for this slice:

* :func:`build_block_layout` turns the row-sorted nonzero stream into the
  block-aligned layout the kernels require (no block straddles an output
  row tile); with the same geometry it returns exactly the JAX slots and
  ``tile_of_block``.
* :func:`mttkrp_device_step` runs one mode step through the backends of
  :data:`BACKENDS`: ``ref`` (materialized ``index_add_``) and the
  in-kernel-gather kernels ``pallas_fused_gather`` (B1) and
  ``pallas_fused_gather_tiled`` (B2) — the backend names are the JAX
  package's, the kernels are CUDA. ``auto``, the other JAX backends and
  bf16 gathers raise ``NotImplementedError`` (ROADMAP A6).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.mttkrp import hadamard_rows
from . import kernel as _kernel
from . import ref as _ref

__all__ = [
    "BACKENDS",
    "GATHER_BACKENDS",
    "build_block_layout",
    "gather_operands",
    "mttkrp_device_step",
    "n_pad_for",
    "pad_rank",
    "padded_rank",
    "tiled_rank_slab",
]

# Backends this module runs. ``segsum`` is accepted one level up, in
# core.distributed.device_mttkrp, and runs here as ``ref``.
BACKENDS = ("ref", "pallas_fused_gather", "pallas_fused_gather_tiled")
GATHER_BACKENDS = ("pallas_fused_gather", "pallas_fused_gather_tiled")

# JAX backend names the port does not run yet, with the ROADMAP item.
NOT_PORTED = {
    "auto": "A6",
    "pallas": "A6",
    "pallas_fused": "A6",
    "pallas_fused_tiled": "A6",
    "pallas_fused_bf16": "A6",
    "pallas_fused_gather_bf16": "A6",
    "pallas_fused_gather_stream": "A8",
}

padded_rank = _kernel.padded_rank


def check_backend(backend: str, extra: tuple = ()) -> None:
    """Raise for a backend this port cannot run (``extra``: more it can)."""
    if backend in BACKENDS or backend in extra:
        return
    if backend in NOT_PORTED:
        raise NotImplementedError(
            f"MTTKRP backend {backend!r} is not ported yet (ROADMAP "
            f"{NOT_PORTED[backend]}); the port runs {BACKENDS + extra}")
    raise ValueError(f"unknown MTTKRP backend {backend!r}: expected one of "
                     f"{BACKENDS + extra}")


def pad_rank(x, multiple: int = _kernel.RANK_MULTIPLE):
    """Zero-pad the trailing (rank) dim to a multiple of ``multiple``."""
    pad = (-x.shape[-1]) % multiple
    return x if pad == 0 else F.pad(x, (0, pad))


def tiled_rank_slab(rank: int) -> int:
    """Column slab of the tiled kernel for ``rank``: the padded rank up to
    ``RANK_SLAB`` (a single slab), else ``RANK_SLAB``."""
    return min(padded_rank(rank), _kernel.RANK_SLAB)


def n_pad_for(cap: int, rows_cap: int, blk: int, tile_rows: int) -> int:
    """Static aligned-stream length: every tile wastes < blk slots."""
    num_tiles = rows_cap // tile_rows
    return ((cap + blk - 1) // blk) * blk + num_tiles * blk


def build_block_layout(local_row, valid, *, rows_cap: int, blk: int,
                       tile_rows: int):
    """Block-aligned slots for a sorted nonzero stream.

    Args:
      local_row: ``(cap,)`` int32 output row per element, ascending among
        valid elements; invalid elements trail.
      valid: ``(cap,)`` bool.
      rows_cap: output rows (multiple of ``tile_rows``).

    Returns:
      ``(slot, tile_of_block)`` int32 — ``slot[(cap,)]`` destination of
      each element in the aligned stream (``n_pad_for(...)`` is the dump
      slot of invalid elements), ``tile_of_block[(n_pad//blk,)]`` the
      non-decreasing output tile of each block. Trailing all-padding
      blocks are clipped onto the last tile.
    """
    cap = local_row.shape[0]
    dev = local_row.device
    num_tiles = rows_cap // tile_rows
    n_pad = n_pad_for(cap, rows_cap, blk, tile_rows)

    tile_of_elem = torch.where(
        valid, torch.div(local_row, tile_rows, rounding_mode="floor"),
        num_tiles).to(torch.int32)
    counts = torch.bincount(tile_of_elem.long(),
                            minlength=num_tiles + 1)[:num_tiles]
    padded = (counts + blk - 1) // blk * blk
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cumsum(padded, 0)]).to(torch.int32)
    # Elements sorted by (valid desc, row asc) => per-tile runs are
    # contiguous; rank = distance from the run's first position.
    first_of_tile = torch.searchsorted(tile_of_elem, tile_of_elem,
                                       side="left", out_int32=True)
    rank_in_tile = torch.arange(cap, dtype=torch.int32,
                                device=dev) - first_of_tile
    slot = torch.where(valid, offsets[tile_of_elem.long()] + rank_in_tile,
                       n_pad).to(torch.int32)
    block_start = torch.arange(n_pad // blk, dtype=torch.int32,
                               device=dev) * blk
    tile_of_block = torch.clamp(
        torch.searchsorted(offsets, block_start, right=True,
                           out_int32=True) - 1,
        0, num_tiles - 1).to(torch.int32)
    return slot, tile_of_block


def _align_to_blocks(x, slot, n_pad: int):
    """Scatter ``(cap, ...)`` stream rows into their block-aligned slots.

    Slot ``n_pad`` is the dump row of invalid elements; it is allocated
    and then sliced off, so invalid entries vanish whatever their payload.
    """
    out = torch.zeros((n_pad + 1,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out[slot.long()] = x
    return out[:-1]


def gather_operands(idx, val, valid, factors, *, mode: int, rows_cap: int,
                    row_offset: int, blk: int, tile_rows: int, slab: int):
    """Block-aligned operands of the in-kernel-gather kernels for one mode.

    Returns ``(vals, idx_stream, factors, local_row_in_tile,
    tile_of_block)`` in the kernels' argument order: only the scalar and
    int32 index streams are block-aligned; the K input-factor matrices
    go whole, zero-padded to a multiple of ``slab`` columns. Padding and
    invalid slots carry value 0, index 0 and local row 0.
    """
    nmodes = idx.shape[1]
    in_modes = [w for w in range(nmodes) if w != mode]
    local_row = torch.where(valid, (idx[:, mode] - row_offset),
                            0).to(torch.int32)
    vals = torch.where(valid, val, 0.0).to(torch.float32)
    n_pad = n_pad_for(local_row.shape[0], rows_cap, blk, tile_rows)
    idx_in = torch.stack([idx[:, w] for w in in_modes], dim=1)
    idx_in = torch.where(valid[:, None], idx_in, 0).to(torch.int32)
    slot, tile_of_block = build_block_layout(
        local_row, valid, rows_cap=rows_cap, blk=blk, tile_rows=tile_rows)
    return (_align_to_blocks(vals, slot, n_pad),
            _align_to_blocks(idx_in, slot, n_pad),
            tuple(pad_rank(factors[w].to(torch.float32), slab).contiguous()
                  for w in in_modes),
            _align_to_blocks(local_row % tile_rows, slot, n_pad),
            tile_of_block)


def mttkrp_device_step(idx, val, valid, factors, *, mode: int, rows_cap: int,
                       row_offset: int = 0, blk: int = 512,
                       tile_rows: int = 8,
                       backend: str = "pallas_fused_gather",
                       gather_dtype: str = "float32",
                       ordering: str = "none"):
    """Per-device mode step: gather → Hadamard → blocked scatter.

    Args:
      idx: ``(cap, N)`` int32 permuted coordinates of owned nonzeros,
        sorted by output row (valid first).
      val: ``(cap,)`` float32 values (0 on padding).
      valid: ``(cap,)`` bool.
      factors: N ``(I_pad_w, R)`` factor matrices (permuted row space).
      mode: output mode.
      rows_cap: owned output rows.
      row_offset: first owned permuted row.
      backend: one of :data:`BACKENDS`.
      gather_dtype: only ``"float32"`` (bf16 gathers: ROADMAP A6).
      ordering: only ``"none"`` (ROADMAP A7).

    Returns ``(rows_cap, R)`` float32 output rows.
    """
    if gather_dtype != "float32":
        if gather_dtype == "bfloat16":
            raise NotImplementedError(
                "bf16 gathers are not ported yet (ROADMAP A6)")
        raise ValueError(f"unknown gather_dtype {gather_dtype!r}")
    if ordering != "none":
        raise NotImplementedError(
            f"ordering={ordering!r} is not ported yet (ROADMAP A7)")
    check_backend(backend)
    rank = factors[mode].shape[-1]
    if backend in GATHER_BACKENDS:
        tiled = backend == "pallas_fused_gather_tiled"
        slab = tiled_rank_slab(rank) if tiled else padded_rank(rank)
        operands = gather_operands(
            idx, val, valid, factors, mode=mode, rows_cap=rows_cap,
            row_offset=row_offset, blk=blk, tile_rows=tile_rows, slab=slab)
        if tiled:
            out = _kernel.fused_mttkrp_nmode_gather_tiled(
                *operands, rows_cap=rows_cap, blk=blk, tile_rows=tile_rows,
                rank_slab=slab)
        else:
            out = _kernel.fused_mttkrp_nmode_gather(
                *operands, rows_cap=rows_cap, blk=blk, tile_rows=tile_rows)
        return out[:, :rank]
    # ref: the per-nonzero contribution is materialized, then scattered.
    local_row = torch.where(valid, idx[:, mode] - row_offset, 0)
    ell = hadamard_rows(idx, torch.where(valid, val, 0.0), factors, mode)
    return _ref.segment_accumulate_ref(ell.float(), local_row, rows_cap)
