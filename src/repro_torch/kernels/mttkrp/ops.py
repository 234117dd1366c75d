"""Block layout construction and per-mode MTTKRP dispatch, in PyTorch.

Port of ``repro/kernels/mttkrp/ops.py``:

* :func:`build_block_layout` turns the row-sorted nonzero stream into the
  block-aligned layout the kernels require (no block straddles an output
  row tile), ranking each tile's run by locality keys when given
  (``order_keys``); with the same geometry it returns exactly the JAX
  slots and ``tile_of_block``.
* :func:`tile_schedule` lists the factor tiles each block reads, the
  stream kernel's per-block window (equal to the reference's).
* :func:`select_backend` resolves ``auto`` on the Hopper residency ladder
  (``oocore.planner.plan_residency``), or by a calibration table's
  measured argmin where the ladder's budgets accept it, and passes
  explicit names through.
* :func:`step_traffic_bytes` is the counted traffic model of a mode
  step, and :func:`timed_device_step` runs a mode step fenced and timed
  from the host, emitting both (``ops.step.model_bytes``, ``ops.step_s``).
* :func:`mttkrp_device_step` runs one mode step through the backends of
  :data:`BACKENDS` — the JAX package's names, on CUDA kernels: ``ref``
  (materialized ``index_add_``), ``pallas`` (materialized contribution,
  scattered by B5 through :func:`mttkrp_blocked`), ``pallas_fused`` (B3)
  and ``pallas_fused_tiled`` (B4) on rows gathered here,
  ``pallas_fused_gather`` (B1) and ``pallas_fused_gather_tiled`` (B2),
  which gather in the kernel, and the out-of-core stream kernel
  ``pallas_fused_gather_stream`` (B6). ``gather_dtype="bfloat16"`` runs
  any of B1–B4 and B6 on bf16 factor operands with fp32 products and
  sums (their bf16 variants); the names ``pallas_fused_bf16`` and
  ``pallas_fused_gather_bf16`` are B3 and B1 with it forced on, as in
  the reference.
"""
from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from ...core.mttkrp import hadamard_rows
from ...obs import counters as _obs
from ...obs import tracer as _tracer
from ...oocore import planner as _planner
from ...reorder import ordering as _reorder
from ...resilience import faults as _faults
from ...resilience import policy as _policy
from . import kernel as _kernel
from . import ref as _ref

__all__ = [
    "AUTO_BACKENDS",
    "BACKENDS",
    "BF16_BACKENDS",
    "FUSED_BACKENDS",
    "GATHER_BACKENDS",
    "GATHER_DTYPES",
    "STREAM_BACKEND",
    "blocked_operands",
    "build_block_layout",
    "check_backend",
    "check_gather_dtype",
    "fused_fits_smem",
    "gather_fits",
    "gather_operands",
    "gather_stream_fits_smem",
    "mttkrp_blocked",
    "mttkrp_device_step",
    "n_pad_for",
    "pad_rank",
    "padded_rank",
    "pregathered_rows",
    "select_backend",
    "step_traffic_bytes",
    "stream_schedules",
    "tile_schedule",
    "tiled_rank_slab",
    "timed_device_step",
]

# Backends this module runs. ``segsum`` is accepted one level up, in
# core.distributed.device_mttkrp, and runs here as ``ref``.
STREAM_BACKEND = _kernel.STREAM_BACKEND_NAME
# The bf16 backend names: the kernel each runs with gather_dtype forced
# to "bfloat16" (the reference's _dispatch folds them the same way).
BF16_BACKENDS = {"pallas_fused_bf16": "pallas_fused",
                 "pallas_fused_gather_bf16": "pallas_fused_gather"}
BACKENDS = ("ref", "pallas", "pallas_fused", "pallas_fused_tiled",
            "pallas_fused_bf16", "pallas_fused_gather",
            "pallas_fused_gather_tiled", "pallas_fused_gather_bf16",
            STREAM_BACKEND)
GATHER_BACKENDS = ("pallas_fused_gather", "pallas_fused_gather_tiled")
# The kernels on rows gathered outside them (B3, B4).
FUSED_BACKENDS = ("pallas_fused", "pallas_fused_tiled")
# What ``auto`` may resolve to: the reference's AUTO_BACKENDS, every
# backend but the bf16 names, which change the numerics.
AUTO_BACKENDS = tuple(b for b in BACKENDS if b not in BF16_BACKENDS)
# The element types the fused family may gather factor rows in.
GATHER_DTYPES = _kernel.GATHER_DTYPES

padded_rank = _kernel.padded_rank


def check_backend(backend: str, extra: tuple = ()) -> None:
    """Raise ``ValueError`` for a backend this port does not know
    (``extra``: more it runs; ``auto`` is always accepted)."""
    if backend == "auto" or backend in BACKENDS or backend in extra:
        return
    raise ValueError(f"unknown MTTKRP backend {backend!r}: expected 'auto' "
                     f"or one of {BACKENDS + extra}")


def check_gather_dtype(gather_dtype: str) -> torch.dtype:
    """The torch dtype of ``gather_dtype`` (``"float32"`` or
    ``"bfloat16"``); anything else raises ``ValueError``, as in the
    reference."""
    if gather_dtype not in GATHER_DTYPES:
        raise ValueError(f"unknown gather_dtype {gather_dtype!r}: expected "
                         "'float32' or 'bfloat16'")
    return GATHER_DTYPES[gather_dtype]


def pad_rank(x, multiple: int = _kernel.RANK_MULTIPLE):
    """Zero-pad the trailing (rank) dim to a multiple of ``multiple``."""
    pad = (-x.shape[-1]) % multiple
    return x if pad == 0 else F.pad(x, (0, pad))


def _pad_factor_rows(x, multiple: int):
    """Zero-pad a factor's rows to a whole number of stream tiles; the
    padding rows are unreachable (indices stay below the true count)."""
    pad = (-x.shape[0]) % multiple
    return x if pad == 0 else F.pad(x, (0, 0, 0, pad))


def tiled_rank_slab(rank: int) -> int:
    """Column slab of the tiled kernel for ``rank``: the padded rank up to
    ``RANK_SLAB`` (a single slab), else ``RANK_SLAB``."""
    return min(padded_rank(rank), _kernel.RANK_SLAB)


def fused_fits_smem(nmodes: int, rank: int, blk: int, tile_rows: int,
                    smem_budget: int = _kernel.SMEM_LIMIT_BYTES, *,
                    tiled: bool = False) -> bool:
    """Does a CTA of B3 (``tiled``: B4, one ``RANK_SLAB`` slab) fit
    ``smem_budget``? Delegates to ``oocore.planner.backend_fits``."""
    return _planner.backend_fits(
        "pallas_fused_tiled" if tiled else "pallas_fused", nmodes=nmodes,
        rank=rank, blk=blk, tile_rows=tile_rows, smem_budget=smem_budget)


def gather_fits(nmodes: int, rank: int, blk: int, tile_rows: int,
                factor_rows, *, l2_budget: int = _kernel.L2_BUDGET_BYTES,
                smem_budget: int = _kernel.SMEM_LIMIT_BYTES,
                tiled: bool = False) -> bool:
    """Do B1's factors (``tiled``: B2's, one slab wide) fit ``l2_budget``
    and its CTA ``smem_budget``? ``factor_rows``: the input factors' row
    counts (per mode, or their total). Delegates to the planner."""
    return _planner.backend_fits(
        "pallas_fused_gather_tiled" if tiled else "pallas_fused_gather",
        nmodes=nmodes, rank=rank, blk=blk, tile_rows=tile_rows,
        factor_rows=factor_rows, l2_budget=l2_budget,
        smem_budget=smem_budget)


def gather_stream_fits_smem(nmodes: int, rank: int, blk: int,
                            tile_rows: int, factor_rows,
                            smem_budget: int = _kernel.SMEM_LIMIT_BYTES
                            ) -> bool:
    """Does the stream kernel's data-blind window fit ``smem_budget``?
    Delegates to the planner (``stream_fits_smem``)."""
    return _planner.backend_fits(
        STREAM_BACKEND, nmodes=nmodes, rank=rank, blk=blk,
        tile_rows=tile_rows, factor_rows=factor_rows,
        smem_budget=smem_budget)


def select_backend(backend: str, *, nmodes: int, rank: int, blk: int = 512,
                   tile_rows: int = 8,
                   smem_budget: int = _kernel.SMEM_LIMIT_BYTES,
                   l2_budget: int = _kernel.L2_BUDGET_BYTES,
                   table=None, factor_rows=None) -> str:
    """Resolve ``auto`` to a concrete backend; pass others through.

    ``auto`` takes the first rung of the residency ladder that fits the
    budgets (``oocore.planner.plan_residency``): B1 → B2 → the stream
    kernel B6 → B3 → B4 → B5 (``pallas``). The gather and stream rungs
    need ``factor_rows`` (the input factors' rows, per mode or in total)
    and are skipped without it. ``auto`` never resolves to a bf16 name
    and does not see the gather dtype (as in the reference): a bf16 mode
    step takes the rung an fp32 one takes, and runs it in bf16. Explicit
    names, the bf16 ones among them, pass through and ignore ``table``;
    an unknown one raises ``ValueError``.

    With a calibration ``table`` (``repro_torch.tune``; duck-typed: its
    ``best_backend``), ``auto`` takes the table's interpolated argmin
    over :data:`AUTO_BACKENDS`, so never a bf16 name nor ``segsum``,
    when the residency planner accepts it (``oocore.planner
    .backend_fits`` on ``smem_budget`` and ``l2_budget``; the gather and
    stream rungs need ``factor_rows`` to be certified). An answer it
    rejects, or no answer, falls through to the static ladder. The
    reference also keeps the table off its kernels below
    ``MIN_MXU_RANK`` unless that rank was measured; the port's ladder
    has no rung that guard protects (``tune.model``), so it keeps none.
    ``table=None`` is the static ladder, bit for bit.

    Every resolution counts ``dispatch.backend{backend,source}``: the
    decision and why (``explicit``, ``table`` or ``static``). The count
    is per call, the reference's per jit trace (``obs.counters``).
    """
    check_backend(backend)
    if backend != "auto":
        _obs.add("dispatch.backend", backend=backend, source="explicit")
        return backend
    if table is not None:
        choice = table.best_backend(nmodes=nmodes, rank=rank, blk=blk,
                                    tile_rows=tile_rows,
                                    allowed=AUTO_BACKENDS)
        if choice is not None and not _planner.backend_fits(
                choice, nmodes=nmodes, rank=rank, blk=blk,
                tile_rows=tile_rows, factor_rows=factor_rows,
                smem_budget=smem_budget, l2_budget=l2_budget):
            choice = None               # infeasible extrapolation
        if choice is not None:
            _obs.add("dispatch.backend", backend=choice, source="table")
            return choice
    chosen = _planner.plan_residency(
        nmodes=nmodes, rank=rank, blk=blk, tile_rows=tile_rows,
        factor_rows=factor_rows, smem_budget=smem_budget,
        l2_budget=l2_budget).backend
    _obs.add("dispatch.backend", backend=chosen, source="static")
    return chosen


def n_pad_for(cap: int, rows_cap: int, blk: int, tile_rows: int) -> int:
    """Static aligned-stream length: every tile wastes < blk slots."""
    num_tiles = rows_cap // tile_rows
    return ((cap + blk - 1) // blk) * blk + num_tiles * blk


def build_block_layout(local_row, valid, *, rows_cap: int, blk: int,
                       tile_rows: int, order_keys=None):
    """Block-aligned slots for a sorted nonzero stream.

    Args:
      local_row: ``(cap,)`` int32 output row per element, ascending among
        valid elements; invalid elements trail. (Only the output-tile
        runs must be contiguous and ascending.)
      valid: ``(cap,)`` bool.
      rows_cap: output rows (multiple of ``tile_rows``).
      order_keys: optional tuple of ``(cap,)`` integer keys, most
        significant first (``reorder.locality_keys``). Elements are then
        ranked within their output-tile run by these keys, position
        breaking ties, as the reference's lexsort does; beyond
        valid-first the input need not be sorted.

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
    pos = torch.arange(cap, dtype=torch.int32, device=dev)
    if order_keys:
        # Rank within the tile run = position under the (tile, keys,
        # position) lexsort.
        order = _reorder.lexsort(
            (tile_of_elem,) + tuple(k.to(torch.int32) for k in order_keys))
        inv = torch.empty_like(pos).scatter_(0, order, pos)
        first_of_tile = torch.searchsorted(tile_of_elem[order], tile_of_elem,
                                           side="left", out_int32=True)
        rank_in_tile = inv - first_of_tile
    else:
        # Elements sorted by (valid desc, row asc) => per-tile runs are
        # contiguous; rank = distance from the run's first position.
        first_of_tile = torch.searchsorted(tile_of_elem, tile_of_elem,
                                           side="left", out_int32=True)
        rank_in_tile = pos - first_of_tile
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


def tile_schedule(indices_aligned, blk: int, window: int,
                  frow_tile: int = _kernel.FACTOR_ROW_TILE):
    """Per-block factor-tile schedule of the stream kernel.

    ``indices_aligned`` is one mode's block-aligned ``(n_pad,)`` factor-row
    stream. Returns ``(n_pad // blk, window)`` int32: row ``b`` holds the
    sorted distinct ``frow_tile``-row tiles block ``b`` touches, the
    unfilled slots repeating the block's *first* tile, as the reference
    builds it; a block with more than ``window`` distinct tiles keeps its
    first ``window``.
    """
    tiles = torch.div(indices_aligned.long(), frow_tile,
                      rounding_mode="floor").reshape(-1, blk, 1)
    st, first, rank_of, _ = _planner.block_tile_analysis(tiles)
    return _schedule_from_analysis(st[..., 0], first[..., 0],
                                   rank_of[..., 0], window)


def _schedule_from_analysis(st, first, rank_of, window: int):
    """One mode's ``(num_blocks, window)`` schedule from its
    ``(num_blocks, blk)`` sorted tiles, first-occurrence mask and distinct
    ranks: first occurrences scatter to their rank, the rest to a dump
    column that is cut off."""
    dest = torch.where(first & (rank_of < window), rank_of.long(), window)
    sched = st[:, :1].expand(-1, window + 1).clone()
    sched.scatter_(1, dest, st)
    return sched[:, :window].to(torch.int32).contiguous()


def stream_schedules(idx_stream, blk: int, factor_rows, *,
                     frow_tile: int = _kernel.FACTOR_ROW_TILE):
    """The stream kernel's schedules for a block-aligned ``(n_pad, K)``
    index stream, with windows tightened to the data.

    Each input mode's window is the data-blind bound
    ``min(blk, ceil(rows / frow_tile))`` cut to the largest per-block
    distinct-tile count. The reference's jit path must plan with the
    bound; the port runs eagerly and reads the data, as the reference's
    executor does. Returns ``(schedules, windows, distinct_counts)``.
    """
    k = idx_stream.shape[1]
    tiles = torch.div(idx_stream.long(), frow_tile,
                      rounding_mode="floor").reshape(-1, blk, k)
    st, first, rank_of, dcounts = _planner.block_tile_analysis(tiles)
    windows = _planner.stream_windows(dcounts, factor_rows, blk, frow_tile)
    scheds = tuple(_schedule_from_analysis(st[..., i], first[..., i],
                                           rank_of[..., i], windows[i])
                   for i in range(k))
    return scheds, windows, dcounts


def blocked_operands(contrib, local_row, valid, *, rows_cap: int,
                     blk: int, tile_rows: int):
    """Block-aligned operands of B5 (``segment_accumulate``) for a sorted
    stream: ``(contrib, local_row_in_tile, tile_of_block)``.

    ``contrib`` is the ``(cap, R)`` materialized contribution per element
    (zero-padded here to a multiple of ``RANK_MULTIPLE`` columns),
    ``local_row`` its output row (ascending among valid elements, invalid
    ones trailing); invalid elements get zero rows. The reference aligns
    the whole ``n_pad``-slot stream; here the blocks past the last tile's
    run, which hold only padding clipped onto the last tile, are cut off:
    they would add zeros, and B5, which has no values to skip them by,
    would read them all in the last tile's CTA.
    """
    slot, tile_of_block = build_block_layout(
        local_row, valid, rows_cap=rows_cap, blk=blk, tile_rows=tile_rows)
    used = int(torch.where(valid, slot + 1, 0).max()) if slot.numel() else 0
    n_used = max(blk, -(-used // blk) * blk)
    slot = torch.where(slot < n_used, slot, n_used)
    return (_align_to_blocks(
                pad_rank(torch.where(valid[:, None], contrib, 0.0).float()),
                slot, n_used),
            _align_to_blocks((local_row % tile_rows).to(torch.int32), slot,
                             n_used),
            tile_of_block[:n_used // blk].contiguous())


def mttkrp_blocked(contrib, local_row, valid, *, rows_cap: int,
                   blk: int = 512, tile_rows: int = 8,
                   use_ref: bool = False):
    """Scatter stage on a sorted stream through B5 (``segment_accumulate``)
    on :func:`blocked_operands`; invalid elements add nothing.
    ``use_ref=True`` routes to the plain ``index_add_`` oracle."""
    if use_ref:
        masked = torch.where(valid[:, None], contrib, 0.0)
        row = torch.where(valid, local_row, 0)
        return _ref.segment_accumulate_ref(masked, row, rows_cap)
    out = _kernel.segment_accumulate(
        *blocked_operands(contrib, local_row, valid, rows_cap=rows_cap,
                          blk=blk, tile_rows=tile_rows),
        rows_cap=rows_cap, blk=blk, tile_rows=tile_rows)
    return out[:, :contrib.shape[-1]]


def pregathered_rows(idx_stream, factors):
    """B3/B4's row operands: each input factor's rows gathered by the
    block-aligned ``(n_pad, K)`` index stream, one ``(n_pad, R)``
    ``index_select`` per input mode, in the factors' element type (bf16
    factors give bf16 rows: the gather moves half the bytes). Padding
    slots (index 0, value 0) hold row 0; the kernels skip them."""
    return tuple(f.index_select(0, idx_stream[:, i])
                 for i, f in enumerate(factors))


def gather_operands(idx, val, valid, factors, *, mode: int, rows_cap: int,
                    row_offset: int, blk: int, tile_rows: int, slab: int,
                    ordering: str = "none", dtype=torch.float32):
    """Block-aligned operands of the in-kernel-gather kernels for one mode.

    Returns ``(vals, idx_stream, factors, local_row_in_tile,
    tile_of_block)`` in the kernels' argument order: only the scalar and
    int32 index streams are block-aligned; the K input-factor matrices
    go whole, cast to ``dtype`` (float32, or bfloat16 for bf16 gathers:
    the matrix is cast, once, before any gather, as the reference does)
    and zero-padded to a multiple of ``slab`` columns. Padding and
    invalid slots carry value 0, index 0 and local row 0. ``ordering``
    (``reorder.ORDERINGS``) ranks each output-tile run by the locality
    keys of ``FACTOR_ROW_TILE``-row factor tiles before alignment.
    """
    nmodes = idx.shape[1]
    in_modes = [w for w in range(nmodes) if w != mode]
    local_row = torch.where(valid, (idx[:, mode] - row_offset),
                            0).to(torch.int32)
    vals = torch.where(valid, val, 0.0).to(torch.float32)
    n_pad = n_pad_for(local_row.shape[0], rows_cap, blk, tile_rows)
    idx_in = torch.stack([idx[:, w] for w in in_modes], dim=1)
    idx_in = torch.where(valid[:, None], idx_in, 0).to(torch.int32)
    # max_rows comes from the factor shapes, so a host-side sort of the
    # same stream derives the same Morton bit budget.
    order_keys = _reorder.locality_keys(
        idx_in, ordering,
        max_rows=max(factors[w].shape[0] for w in in_modes))
    slot, tile_of_block = build_block_layout(
        local_row, valid, rows_cap=rows_cap, blk=blk, tile_rows=tile_rows,
        order_keys=order_keys)
    return (_align_to_blocks(vals, slot, n_pad),
            _align_to_blocks(idx_in, slot, n_pad),
            tuple(pad_rank(factors[w].to(dtype), slab).contiguous()
                  for w in in_modes),
            _align_to_blocks(local_row % tile_rows, slot, n_pad),
            tile_of_block)


def mttkrp_device_step(idx, val, valid, factors, *, mode: int, rows_cap: int,
                       row_offset: int = 0, blk: int = 512,
                       tile_rows: int = 8,
                       backend: str = "pallas_fused_gather",
                       gather_dtype: str = "float32",
                       ordering: str = "none",
                       smem_budget: int = _kernel.SMEM_LIMIT_BYTES,
                       l2_budget: int = _kernel.L2_BUDGET_BYTES):
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
      backend: ``auto`` or one of :data:`BACKENDS`. ``auto`` resolves
        through :func:`select_backend` with the input factors' row counts
        and the budgets ``smem_budget`` and ``l2_budget``; the bf16 names
        are B3 (``pallas_fused_bf16``) and B1 (``pallas_fused_gather_bf16``)
        with ``gather_dtype="bfloat16"``.
      gather_dtype: ``"float32"`` or ``"bfloat16"``: the element type the
        fused family (B1–B4, B6) gathers factor rows in; products and sums
        stay fp32. Each factor matrix is cast before any gather. ``ref``
        and ``pallas`` ignore it, as in the reference. Anything else raises
        ``ValueError``.
      ordering: ``reorder.ORDERINGS`` policy; anything but ``"none"``
        ranks each output-tile run by factor-tile locality before block
        alignment, for the fused and gather kernels (B1–B4, B6) alike (one
        aligned stream, so they stay bitwise equal per ordering); ``ref``
        and ``pallas`` do not align gathered indices and ignore it, as in
        the reference.

    The fused backends (B3, B4) take the rows of each input factor
    gathered here, in plain PyTorch as the reference does outside its
    kernel: one ``(n_pad, R)`` ``index_select`` on the block-aligned index
    stream per input mode (padding slots hold row 0 and value 0; the
    kernel skips them). The stream backend (B6) tightens each window to
    the data (:func:`stream_schedules`) and launches once; its window must
    fit shared memory (the kernel raises otherwise).

    The step is the ``ops.kernel`` fault site (``resilience.faults``).
    Under an active policy (``resilience.use_policy``) an injected
    transient fault retries the step and an injected resource fault runs
    it one rung down ``resilience.DEGRADATION_LADDER``; anything else
    raises, as with no policy.

    Returns ``(rows_cap, R)`` float32 output rows.
    """
    gdt = check_gather_dtype(gather_dtype)
    _reorder.validate_ordering(ordering)
    nmodes = idx.shape[1]
    rank = factors[mode].shape[-1]
    backend = select_backend(
        backend, nmodes=nmodes, rank=rank, blk=blk, tile_rows=tile_rows,
        smem_budget=smem_budget, l2_budget=l2_budget,
        factor_rows=tuple(factors[w].shape[0] for w in range(nmodes)
                          if w != mode))

    def _dispatch(backend: str, gdt=gdt):
        if backend in BF16_BACKENDS:
            backend, gdt = BF16_BACKENDS[backend], torch.bfloat16
        if backend in ("ref", "pallas"):
            # The per-nonzero contribution is materialized, then scattered.
            local_row = torch.where(valid, idx[:, mode] - row_offset, 0)
            safe_idx = torch.where(valid[:, None], idx, 0)
            ell = hadamard_rows(safe_idx, torch.where(valid, val, 0.0),
                                factors, mode).float()
            return mttkrp_blocked(ell, local_row.to(torch.int32), valid,
                                  rows_cap=rows_cap, blk=blk,
                                  tile_rows=tile_rows,
                                  use_ref=backend == "ref")
        if backend == STREAM_BACKEND:
            slab = min(padded_rank(rank), _kernel.STREAM_RANK_SLAB)
        elif backend in ("pallas_fused_gather_tiled", "pallas_fused_tiled"):
            slab = tiled_rank_slab(rank)
        else:
            slab = padded_rank(rank)
        vals, idx_al, fmats, r_al, tob = gather_operands(
            idx, val, valid, factors, mode=mode, rows_cap=rows_cap,
            row_offset=row_offset, blk=blk, tile_rows=tile_rows, slab=slab,
            ordering=ordering, dtype=gdt)
        kw = dict(rows_cap=rows_cap, blk=blk, tile_rows=tile_rows)
        if backend in FUSED_BACKENDS:
            rows = pregathered_rows(idx_al, fmats)
            del idx_al, fmats
            if backend == "pallas_fused_tiled":
                out = _kernel.fused_mttkrp_nmode_tiled(
                    vals, rows, r_al, tob, rank_slab=slab, **kw)
            else:
                out = _kernel.fused_mttkrp_nmode(vals, rows, r_al, tob, **kw)
        elif backend == STREAM_BACKEND:
            fmats = tuple(_pad_factor_rows(f, _kernel.FACTOR_ROW_TILE)
                          for f in fmats)
            scheds, _, _ = stream_schedules(idx_al, blk,
                                            tuple(f.shape[0] for f in fmats))
            out = _kernel.fused_mttkrp_nmode_gather_stream(
                vals, idx_al, fmats, r_al, tob, scheds, rank_slab=slab, **kw)
        elif backend == "pallas_fused_gather_tiled":
            out = _kernel.fused_mttkrp_nmode_gather_tiled(
                vals, idx_al, fmats, r_al, tob, rank_slab=slab, **kw)
        else:
            out = _kernel.fused_mttkrp_nmode_gather(
                vals, idx_al, fmats, r_al, tob, **kw)
        return out[:, :rank]

    def _attempt(backend: str):
        # Registered failure boundary (repro_torch.resilience): where a
        # kernel's build or resources fail. It fires before any work, so a
        # retry or a lower rung starts from the same inputs.
        _faults.fault_site("ops.kernel")
        return _dispatch(backend)

    pol = _policy.get_policy()
    if pol is None:
        # No active policy: fail fast, one attempt at the selected backend.
        return _attempt(backend)
    return pol.dispatch(_attempt, backend)


def step_traffic_bytes(*, cap: int, nmodes: int, rank: int, rows_cap: int,
                       gather_dtype: str = "float32",
                       rank_multiple: int = _kernel.RANK_MULTIPLE) -> int:
    """First-order counted traffic model of one device mode step.

    What the step minimally moves, whatever the backend: the nonzero
    stream (value, local row and K gathered-mode indices, 4 B each), one
    gathered factor row per nonzero per input mode (``rpad`` elements of
    the gather dtype), and the output factor written once. A *model*, not
    a measurement: the byte count the roofline divides a measured step
    time by. ``rpad`` is the rank padded to ``rank_multiple`` (the port's
    16; the reference pads to its MXU's 128, which ``rank_multiple=128``
    reproduces).
    """
    k = nmodes - 1
    gi = check_gather_dtype(gather_dtype).itemsize
    rpad = _kernel.padded_rank(rank, rank_multiple)
    return cap * (4 + 4 + 4 * k) + cap * k * rpad * gi + rows_cap * rpad * 4


def timed_device_step(idx, val, valid, factors, *, mode: int, rows_cap: int,
                      backend: str = "pallas_fused_gather",
                      gather_dtype: str = "float32", **step_kw):
    """:func:`mttkrp_device_step`, fenced and timed from the host.

    An ``ops.device_step`` span around the call, with the step's modeled
    traffic (:func:`step_traffic_bytes`, ``ops.step.model_bytes``) emitted
    inside it so the roofline can join measured seconds with counted
    bytes, then ``ops.step_s`` (host seconds). On CUDA the clock starts
    after ``torch.cuda.synchronize`` on the inputs' device, so work queued
    before the call is not counted, and the call ends with another, where
    the reference calls ``block_until_ready``; on the CPU, which runs
    eagerly, nothing needs fencing. The labels carry the *requested* backend
    (``auto`` stays ``auto``), as in the reference: the step's own
    ``dispatch.backend`` count says what it resolved to. ``step_kw``
    (``row_offset``, ``blk``, ``tile_rows``, ``ordering``, the budgets) go
    to :func:`mttkrp_device_step`.
    """
    tracer = _tracer.get_tracer()
    model_b = step_traffic_bytes(
        cap=int(idx.shape[0]), nmodes=int(idx.shape[1]),
        rank=int(factors[mode].shape[-1]), rows_cap=rows_cap,
        gather_dtype=gather_dtype)
    if idx.is_cuda:
        torch.cuda.synchronize(idx.device)
    t0 = time.perf_counter()
    with tracer.span("ops.device_step", backend=backend, mode=mode,
                     ordering=step_kw.get("ordering", "none")):
        _obs.add("ops.step.model_bytes", model_b, backend=backend)
        out = mttkrp_device_step(idx, val, valid, factors, mode=mode,
                                 rows_cap=rows_cap, backend=backend,
                                 gather_dtype=gather_dtype, **step_kw)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    _obs.add("ops.step_s", time.perf_counter() - t0, backend=backend)
    return out
