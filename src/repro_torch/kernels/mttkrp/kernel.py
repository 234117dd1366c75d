"""spMTTKRP kernels for Hopper and their plain versions.

Port of the six Pallas kernels of ``repro/kernels/mttkrp/kernel.py``:
``fused_mttkrp_nmode_gather`` (B1), ``fused_mttkrp_nmode_gather_tiled``
(B2), ``fused_mttkrp_nmode`` (B3), ``fused_mttkrp_nmode_tiled`` (B4),
``segment_accumulate`` (B5) and ``fused_mttkrp_nmode_gather_stream`` (B6).
The wrappers keep the JAX signatures. On a CUDA tensor they launch the
hand-written kernels in ``csrc/gather_mttkrp.cu`` (B1, B2),
``csrc/fused_mttkrp.cu`` (B3, B4, B5) and ``csrc/gather_stream_mttkrp.cu``
(B6), built for ``sm_90a`` at first use, or raise; on a CPU tensor they
run the plain PyTorch version beside them (``*_plain``), which the tests
hold against the JAX package. Nothing falls back from one to the other.

B1–B4 and B6 take float32 or bfloat16 factor operands (the reference's
bf16 gathers): the CUDA sources instantiate each kernel for both element
types, a bf16 element becomes fp32 as it is loaded (B3, B4 and B6: as it is
read from shared memory), and every product
and sum is fp32, so the bf16 variants agree bitwise among themselves as
the fp32 ones do. The plain versions upcast the gathered bf16 rows before
the Hadamard product, as the reference's type promotion does. B5 takes
fp32 only: its contribution is made in fp32 on every path.

Each wrapper counts its kernel launches in its ``launches`` attribute,
and those of its bf16 variant in ``launches_bf16``. Where a wrapper picks
its route (kernel or plain version) it calls the ``execution.resolve``
fault site (``resilience.faults``, the counterpart of the reference's
``resolve_interpret``): once per wrapper call.
The ``*_smem_bytes`` functions give each kernel's per-CTA shared memory,
which the launch checks and the residency planner
(``oocore.planner.plan_residency``) both read.

Geometry is re-derived for Hopper, not copied from the TPU:

* ``RANK_MULTIPLE = 16`` — the rank is padded so a factor row is a whole
  number of 64-byte segments and 16 or 32 threads split its columns (the
  TPU padded to the 128-wide MXU).
* ``RANK_SLAB = 128`` — the tiled kernel's default column slab.
* ``ROW_SLOTS = 128`` — one CTA holds ``groups ≈ ROW_SLOTS // tile_rows``
  private partial tiles (a power of two in 1..16). It depends on
  ``tile_rows`` only, so all six kernels add in the same order and agree
  bitwise on one aligned stream.
* ``FACTOR_ROW_TILE = 8`` and ``STREAM_RANK_SLAB = 16`` — the stream
  kernel's window unit is an 8-row x 16-column factor tile, 512 B: four
  128-byte lines, one bulk copy (runs of consecutive tiles go in one).
  The TPU's 128 x 128 tile (64 KiB) suits a DMA engine and 64 MiB of
  VMEM; a CTA here has 227 KB of shared memory. With these, a block of
  ``blk <= 128`` nonzeros and K <= 3 input modes fits the data-blind
  window bound ``min(blk, ceil(rows / 8))`` per mode (3 x 128 tiles =
  192 KiB plus 8 KiB of partial tiles and three meta slots) in a CTA of
  one ring stage for any index data, so the stream rung never needs an
  ordering to run; an ordering shrinks the window, and the kernel then
  takes as many ring stages as fit (:func:`stream_ring`). A taller tile
  copies more rows that no nonzero of the block reads; a shorter one
  lengthens the schedules the kernel searches for every nonzero.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...resilience import faults as _faults
from ...runtime.device import require_sm90
from . import build as _build

__all__ = [
    "FACTOR_ROW_TILE",
    "GATHER_DTYPES",
    "L2_BUDGET_BYTES",
    "RANK_MULTIPLE",
    "RANK_SLAB",
    "ROW_SLOTS",
    "SMEM_LIMIT_BYTES",
    "STREAM_BACKEND_NAME",
    "STREAM_RANK_SLAB",
    "MAX_STREAM_MAPPERS",
    "MAX_STREAM_STAGES",
    "StreamCarry",
    "fused_mttkrp_nmode",
    "fused_mttkrp_nmode_plain",
    "fused_mttkrp_nmode_tiled",
    "fused_mttkrp_nmode_tiled_plain",
    "fused_ring",
    "fused_smem_bytes",
    "fused_stage_partition",
    "gather_smem_bytes",
    "gather_stream_smem_bytes",
    "stream_ring",
    "padded_rank",
    "segment_accumulate",
    "segment_accumulate_plain",
    "segment_slab",
    "segment_smem_bytes",
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
# Shared memory of one H100 SM (228 KB), and what each CTA resident on it
# takes besides its own (1 KB).
SM_SMEM_BYTES = 233_472
CTA_SMEM_RESERVED = 1024
# L2 bytes the gather kernels' factors may take (the residency ladder's
# default l2_budget): half of the H100's 50 MB L2. B1 and B2 hold no factor
# in shared memory; they gather rows out of L2, which plays the part VMEM
# plays on the TPU. Half of it is the reference's half-the-fast-memory rule
# (its VMEM budget is half a core's VMEM), kept as a rule: the other half
# serves the nonzero stream, the output tiles and the L2's set conflicts.
L2_BUDGET_BYTES = 25 * 2**20
FACTOR_ROW_TILE = 8
STREAM_RANK_SLAB = 16
STREAM_BACKEND_NAME = "pallas_fused_gather_stream"
# Stream slots a CTA of B1 and B2 stages in shared memory at a time, in
# STAGE_BUFFERS buffers of STAGE_SLOTS // STAGE_BUFFERS (kBuffers, kChunk
# in gather_mttkrp.cu).
STAGE_SLOTS = 2048
STAGE_BUFFERS = 2
# B1/B2 on bf16 factors load rows 16 bytes (8 columns) a lane at slabs of
# this many columns or more (kVecMinSlab in gather_mttkrp.cu).
BF16_VEC_MIN_SLAB = 64
# B3/B4's ring (fused_mttkrp.cu; kernel.fused_ring picks it): stages of a
# power of two of slots, FUSED_MIN_SLOTS to FUSED_STAGE_SLOTS, holding at
# most FUSED_STAGE_BYTES of rows; FUSED_STAGES of them when a stage's rows
# are whole (one bulk copy per row array), FUSED_SLAB_STAGES when they are
# slabs of wider rows (2-D tensor copies of short row pieces, which need
# more bytes in flight). Chosen on the nell-2 stand-in
# (bench_torch/kernel_ablation.py). Beside the ring, a meta ring of
# FUSED_META_STAGES chunks of FUSED_META_CHUNK slots' values and local
# rows (kMetaStages, kMetaChunk).
FUSED_STAGE_SLOTS = 256
FUSED_MIN_SLOTS = 16
FUSED_STAGE_BYTES = 32 * 1024
FUSED_STAGES = 2
FUSED_SLAB_STAGES = 4
FUSED_META_STAGES = 4
FUSED_META_CHUNK = 1024
# Ints of one ring or meta header (kHdrInts).
_FUSED_HDR_INTS = 8
# Most ring stages and mapper warps the stream kernel (B6) is given (each
# mapper warp holds one more block's meta slot).
MAX_STREAM_STAGES = 8
MAX_STREAM_MAPPERS = 8
# Bytes of contribution rows a CTA of B5 stages at a time.
SEGMENT_STAGE_BYTES = 32 * 1024
# Elements of one (chunk, R) temporary in the plain version (~256 MB).
_PLAIN_CHUNK_ELEMS = 1 << 26
# Element types of the factor operands of B1–B4 and B6, by the names the
# reference's ``gather_dtype`` takes.
GATHER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _entry(library: str, mats) -> str:
    """The launch function of ``library`` for the operands' element type:
    ``<library>_launch`` (float32) or ``<library>_bf16_launch``."""
    bf16 = mats[0].dtype == torch.bfloat16
    return f"{library}_bf16_launch" if bf16 else f"{library}_launch"


def _count_launch(wrapper, mats) -> None:
    """One launch of ``wrapper``'s kernel: of its bf16 variant when the
    operands are bf16 (``launches_bf16``), else of the fp32 one."""
    if mats[0].dtype == torch.bfloat16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1


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


def _lanes(slab: int) -> int:
    """Threads of a group: 32 when they split the slab evenly, else 16."""
    return 32 if slab % 32 == 0 else 16


def _vec_rows(slab: int, gather_itemsize: int) -> bool:
    """Does B1/B2 load rows 16 bytes a lane (``gather_mttkrp_vec_kernel``):
    bf16 factors at a slab of :data:`BF16_VEC_MIN_SLAB` or more."""
    return gather_itemsize == 2 and slab >= BF16_VEC_MIN_SLAB


def _gather_lanes(slab: int, gather_itemsize: int = 4) -> int:
    """Threads of a group of B1/B2: :func:`_lanes`, but where each lane
    owns blocks of 8 columns read 16 bytes at a time (:func:`_vec_rows`;
    ``kVec`` in ``csrc/gather_mttkrp.cu``): ``slab // 8`` lanes, at most
    32."""
    return min(32, slab // 8) if _vec_rows(slab, gather_itemsize) \
        else _lanes(slab)


def _stream_lanes(slab: int, gather_itemsize: int = 4) -> int:
    """Consumer threads of a group of B6: :func:`_lanes` for float32
    windows; for bf16 ones each lane reads two columns at once, so
    ``slab // 2`` lanes, at most 32."""
    return _lanes(slab) if gather_itemsize == 4 else min(32, slab // 2)


def _tile_starts(tile_of_block, num_tiles: int):
    """``(num_tiles + 1,)`` int32: the first block of each output tile's
    run (``tile_of_block`` is non-decreasing) and the end of the last."""
    return torch.searchsorted(
        tile_of_block,
        torch.arange(num_tiles + 1, dtype=torch.int32,
                     device=tile_of_block.device),
        out_int32=True)


def _out_start(out_init, rows_cap: int, rank: int, dev):
    """The kernels' output buffer: a copy of ``out_init``, or zeros."""
    if out_init is None:
        return torch.zeros(rows_cap, rank, dtype=torch.float32, device=dev)
    return out_init.contiguous().clone()


def gather_smem_bytes(num_in_modes: int, rank_padded: int, tile_rows: int,
                      rank_slab: int | None = None) -> int:
    """Shared memory of one CTA of the in-kernel-gather kernels (B1, B2).

    The ``groups`` partial output tiles, one slab wide (the padded rank for
    B1, ``min(rank_padded, rank_slab)`` for B2), then ``STAGE_BUFFERS``
    staging buffers of ``STAGE_SLOTS // STAGE_BUFFERS`` slots each: value,
    local row and ``num_in_modes`` indices per slot (chunk c+1 lands in one
    while chunk c gathers from the other). The factors are not held: they
    are read from device memory (L2). The layout is
    ``csrc/gather_mttkrp.cu``'s; the launch check and the residency planner
    read this one number. It holds no factor element, so it is the same
    for float32 and bf16 factors.
    """
    slab = rank_padded if rank_slab is None else min(rank_padded, rank_slab)
    chunk = STAGE_SLOTS // STAGE_BUFFERS
    return 4 * (_groups(tile_rows) * tile_rows * slab
                + STAGE_BUFFERS * chunk * (2 + num_in_modes))


def _check_async_operands(blk: int, **operands) -> None:
    """The asynchronous copies of B1–B4 and B6 move 16-byte pieces: every
    named operand must start on a 16-byte boundary and ``blk`` be a
    multiple of 4 (so every block, and every chunk of blocks, starts on
    one). B6 also copies factor tiles and B3/B4 pre-gathered rows: those
    bases are checked, float32 or bf16 alike; a tile (``frow_tile x slab``
    elements), a per-row copy and a row slice (``slab`` elements) are whole
    16-byte pieces at either itemsize, since the slab and the row are
    multiples of 16 elements. Raises ``ValueError`` naming the first
    operand that does not; there is no unaligned fallback."""
    if blk % 4:
        raise ValueError(f"blk={blk} is not a multiple of 4: the kernel's "
                         "16-byte copies of a block would be misaligned")
    for name, t in operands.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned (data_ptr "
                             f"{t.data_ptr():#x}); pass a fresh contiguous "
                             "tensor")


def _check_stream_layout(n_pad: int, local_row_in_tile, tile_of_block, *,
                         rows_cap: int, blk: int, tile_rows: int):
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


def _check_common(vals, mats, local_row_in_tile, tile_of_block, *,
                  rows_cap: int, blk: int, tile_rows: int, slab: int | None,
                  out_init, others=()):
    """Checks B1–B4 and B6 share: the float32 values, the stream layout,
    the K ``(·, R)`` matrices (factors or pre-gathered rows) of one element
    type, float32 or bfloat16, with R a multiple of the slab (``None``:
    R), a float32 ``out_init``, one device for all (``others`` too).
    Returns ``(mats, R)`` with ``mats`` as a tuple."""
    mats = tuple(mats)
    if not 1 <= len(mats) <= MAX_IN_MODES:
        raise ValueError(f"need 1..{MAX_IN_MODES} input-factor operands "
                         f"(tensor order 2..5), got {len(mats)}")
    if vals.dtype != torch.float32 or vals.dim() != 1:
        raise ValueError(f"vals must be (n_pad,) float32, got "
                         f"{tuple(vals.shape)} {vals.dtype}")
    _check_stream_layout(vals.shape[0], local_row_in_tile, tile_of_block,
                         rows_cap=rows_cap, blk=blk, tile_rows=tile_rows)
    rank, dtype = mats[0].shape[-1], mats[0].dtype
    if dtype not in GATHER_DTYPES.values():
        raise ValueError(f"input-factor operands must be float32 or "
                         f"bfloat16, got {dtype}")
    for m in mats:
        if m.dim() != 2 or m.shape[1] != rank or m.dtype != dtype:
            raise ValueError("input-factor operands must be (rows, R) of "
                             "one element type with one R")
    slab = rank if slab is None else slab
    if slab <= 0 or rank % slab or slab % RANK_MULTIPLE:
        raise ValueError(
            f"rank {rank} must be a multiple of the slab {slab}, itself a "
            f"multiple of {RANK_MULTIPLE} (pad with ops.pad_rank)")
    if out_init is not None and (out_init.shape != (rows_cap, rank)
                                 or out_init.dtype != torch.float32):
        raise ValueError(f"out_init must be ({rows_cap}, {rank}) float32")
    tensors = (vals, local_row_in_tile, tile_of_block) + mats \
        + tuple(others) + ((out_init,) if out_init is not None else ())
    if any(t.device != vals.device for t in tensors):
        raise ValueError("all operands must be on one device")
    return mats, rank


def _check_args(vals, idx_stream, factors, local_row_in_tile, tile_of_block,
                *, rows_cap: int, blk: int, tile_rows: int, slab: int,
                out_init):
    """Shapes, dtypes and devices B1/B2 and their plain versions require.

    Returns ``(factors, R)`` with ``factors`` as a tuple.
    """
    factors, rank = _check_common(
        vals, factors, local_row_in_tile, tile_of_block, rows_cap=rows_cap,
        blk=blk, tile_rows=tile_rows, slab=slab, out_init=out_init,
        others=(idx_stream,))
    n_pad, k = vals.shape[0], len(factors)
    if idx_stream.shape != (n_pad, k) or idx_stream.dtype != torch.int32:
        raise ValueError(f"idx_stream must be ({n_pad}, {k}) int32, got "
                         f"{tuple(idx_stream.shape)} {idx_stream.dtype}")
    return factors, rank


def _stream_rows(tile_of_block, local_row_in_tile, blk: int,
                 tile_rows: int):
    """Output row of every slot of a block-aligned stream (int64)."""
    return (torch.repeat_interleave(tile_of_block.long(), blk) * tile_rows
            + local_row_in_tile.long())


def _plain(vals, idx_stream, factors, local_row_in_tile, tile_of_block, *,
           rows_cap: int, blk: int, tile_rows: int, out_init):
    rank = factors[0].shape[1]
    rows = _stream_rows(tile_of_block, local_row_in_tile, blk, tile_rows)
    out = (torch.zeros(rows_cap, rank, dtype=torch.float32,
                       device=vals.device)
           if out_init is None else out_init.clone())
    step = max(blk, _PLAIN_CHUNK_ELEMS // rank)
    for lo in range(0, vals.shape[0], step):
        contrib = vals[lo:lo + step, None]
        for w, f in enumerate(factors):
            # bf16 rows go to fp32 before the product (exact), as the
            # reference promotes them; a bf16 multiply would round.
            contrib = contrib * f.index_select(
                0, idx_stream[lo:lo + step, w].long()).float()
        out.index_add_(0, rows[lo:lo + step], contrib)
    return out


def _launch(vals, idx_stream, factors, local_row_in_tile, tile_of_block, *,
            rows_cap: int, blk: int, tile_rows: int, slab: int, out_init):
    dev = vals.device
    require_sm90(dev)
    rank, itemsize = factors[0].shape[1], factors[0].element_size()
    groups = _groups(tile_rows)
    lanes = _gather_lanes(slab, itemsize)
    smem = gather_smem_bytes(len(factors), rank, tile_rows, rank_slab=slab)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"a {tile_rows} x {slab} output tile with {groups} partials needs "
            f"{smem} B of shared memory (> {SMEM_LIMIT_BYTES}); use the tiled "
            "kernel with a narrower rank_slab")
    tensors = (vals, idx_stream, local_row_in_tile, tile_of_block) + factors
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all operands must be contiguous")
    # Rows read 16 bytes at a time: the factors' bases are checked too.
    _check_async_operands(
        blk, vals=vals, idx_stream=idx_stream,
        local_row_in_tile=local_row_in_tile,
        **({f"factors[{w}]": f for w, f in enumerate(factors)}
           if _vec_rows(slab, itemsize) else {}))
    if any(f.numel() >= 2**31 for f in factors):
        raise ValueError("a factor matrix of 2**31 or more elements: the "
                         "kernel keeps 32-bit row offsets")
    num_tiles = rows_cap // tile_rows
    blk_start = _tile_starts(tile_of_block, num_tiles)
    out = _out_start(out_init, rows_cap, rank, dev)
    ptrs = [f.data_ptr() for f in factors] + [0] * (MAX_IN_MODES
                                                     - len(factors))
    nrows = [f.shape[0] for f in factors] + [0] * (MAX_IN_MODES
                                                   - len(factors))
    lib = _build.load("gather_mttkrp")
    err = getattr(lib, _entry("gather_mttkrp", factors))(
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
    _faults.fault_site("execution.resolve")
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
      factors: K ``(I_w, R)`` input-factor matrices, all float32 or all
        bfloat16 (bf16 gathers, fp32 products and sums), R a multiple of
        :data:`RANK_MULTIPLE` (``ops.pad_rank``).
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
        _count_launch(fused_mttkrp_nmode_gather, factors)
    return out


fused_mttkrp_nmode_gather.launches = 0
fused_mttkrp_nmode_gather.launches_bf16 = 0


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
        _count_launch(fused_mttkrp_nmode_gather_tiled, factors)
    return out


fused_mttkrp_nmode_gather_tiled.launches = 0
fused_mttkrp_nmode_gather_tiled.launches_bf16 = 0


def fused_mttkrp_nmode_gather_plain(vals, idx_stream, factors,
                                    local_row_in_tile, tile_of_block, *,
                                    rows_cap: int, blk: int = 512,
                                    tile_rows: int = 8, out_init=None):
    """Plain PyTorch version of B1 (``index_select`` + ``index_add_``).

    Runs on any device; the sum order differs from the kernel's, so the
    two agree to fp32 rounding, not bitwise. bf16 factor rows are upcast
    to fp32 before the products.
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
                             rank_slab: int = STREAM_RANK_SLAB,
                             stages: int = 1, mappers: int = 1,
                             gather_itemsize: int = 4) -> int:
    """Shared memory of one CTA of the stream kernel (B6) with a ring of
    ``stages`` stages and ``mappers`` mapper warps.

    The Hopper counterpart of the reference's ``gather_stream_vmem_bytes``,
    byte for byte the layout of ``csrc/gather_stream_mttkrp.cu``: the
    ``groups`` partial output tiles; per stage a factor-tile window (per
    input mode ``window_tiles`` tiles of ``frow_tile`` rows, one slab
    wide); ``stages + mappers + 1`` meta slots, each the staged
    block (value, local row and one index per input mode for each of
    ``blk`` slots, and the schedule rows, padded to 16 bytes) and its plan
    (a copy-run length per schedule entry and a flag, padded to 16 bytes);
    and 8-byte mbarriers, two per stage and three per meta slot.
    ``window_tiles`` is an int for every mode or a per-mode sequence.
    ``stages=1, mappers=1`` is the smallest CTA, the one the residency
    ladder asks about (:func:`oocore.planner.stream_fits_smem`).
    ``gather_itemsize`` is the bytes of one factor element (4 for
    float32, 2 for bf16): the windows are the only part of any of these
    kernels' shared memory that holds factor elements.
    """
    if isinstance(window_tiles, int):
        window_tiles = (window_tiles,) * num_in_modes
    if len(window_tiles) != num_in_modes:
        raise ValueError(f"{len(window_tiles)} window widths for "
                         f"{num_in_modes} input modes")
    if stages < 1 or mappers < 1:
        raise ValueError(f"stages={stages}, mappers={mappers}: both must be "
                         ">= 1")
    slab = min(rank_padded, rank_slab)
    wsum = sum(int(w) for w in window_tiles)
    slot = ((2 + num_in_modes) * blk + padded_rank(wsum, 4)
            + padded_rank(wsum + 1, 4))
    slots = stages + mappers + 1
    return (4 * (_groups(tile_rows) * tile_rows * slab + slots * slot)
            + gather_itemsize * stages * wsum * frow_tile * slab
            + 8 * (2 * stages + 3 * slots))


def stream_ring(num_in_modes: int, rank_padded: int, blk: int,
                tile_rows: int, window_tiles,
                frow_tile: int = FACTOR_ROW_TILE,
                rank_slab: int = STREAM_RANK_SLAB,
                smem_budget: int = SMEM_LIMIT_BYTES,
                gather_itemsize: int = 4) -> tuple[int, int]:
    """``(stages, mappers)`` the stream kernel runs with: the most stages,
    up to :data:`MAX_STREAM_STAGES`, whose CTA fits ``smem_budget`` bytes
    (:func:`gather_stream_smem_bytes`) with :data:`MAX_STREAM_MAPPERS`
    mapper warps; where not even one stage fits with them, one stage and
    the most mapper warps that fit. ``(0, 0)`` when the smallest CTA does
    not fit. Both counts are monotone in the budget.

    bf16 windows (``gather_itemsize=2``) are half the bytes. For them the
    deepest ring of two stages or more with which two CTAs share an SM
    (:data:`SM_SMEM_BYTES`, each CTA also taking :data:`CTA_SMEM_RESERVED`)
    comes first: at one CTA an SM the bf16 kernel's copies and its adds
    each took most of the call, and two CTAs overlap them
    (``bench_torch/kernel_ablation.py``). Where no such ring fits, the
    rule above."""
    def fits(stages, mappers, budget=smem_budget):
        return gather_stream_smem_bytes(
            num_in_modes, rank_padded, blk, tile_rows, window_tiles,
            frow_tile=frow_tile, rank_slab=rank_slab, stages=stages,
            mappers=mappers, gather_itemsize=gather_itemsize) <= budget
    if gather_itemsize == 2:
        shared = min(smem_budget, SM_SMEM_BYTES // 2 - CTA_SMEM_RESERVED)
        for stages in range(MAX_STREAM_STAGES, 1, -1):
            if fits(stages, MAX_STREAM_MAPPERS, shared):
                return stages, MAX_STREAM_MAPPERS
    for stages in range(MAX_STREAM_STAGES, 0, -1):
        if fits(stages, MAX_STREAM_MAPPERS):
            return stages, MAX_STREAM_MAPPERS
    for mappers in range(MAX_STREAM_MAPPERS - 1, 0, -1):
        if fits(1, mappers):
            return 1, mappers
    return 0, 0


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
    rows = _stream_rows(tile_of_block, local_row_in_tile, blk, tile_rows)
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
            contrib = contrib * f.index_select(0, ix).float()
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
    itemsize = factors[0].element_size()
    groups = _groups(tile_rows)
    lanes = _stream_lanes(slab, itemsize)
    windows = tuple(s.shape[1] for s in scheds)
    stages, mappers = stream_ring(k, rank, blk, tile_rows, windows,
                                  frow_tile=frow_tile, rank_slab=slab,
                                  gather_itemsize=itemsize)
    if stages < 1:
        smem = gather_stream_smem_bytes(k, rank, blk, tile_rows, windows,
                                        frow_tile=frow_tile, rank_slab=slab,
                                        gather_itemsize=itemsize)
        raise ValueError(
            f"the stream kernel's window of {windows} tiles of {frow_tile} "
            f"x {slab} elements per input mode, with blk={blk} and "
            f"tile_rows={tile_rows}, needs {smem} B of shared memory "
            f"(> {SMEM_LIMIT_BYTES} B); use a smaller blk or frow_tile, a "
            "locality ordering, or smaller chunks")
    tensors = (vals, idx_stream, local_row_in_tile, tile_of_block) \
        + factors + scheds
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all operands must be contiguous")
    _check_async_operands(
        blk, vals=vals, idx_stream=idx_stream,
        local_row_in_tile=local_row_in_tile,
        **{f"factors[{w}]": f for w, f in enumerate(factors)})
    num_tiles, num_slabs = rows_cap // tile_rows, rank // slab
    part_shape = (num_slabs, groups, tile_rows, slab)
    if carry is not None and (tuple(carry.partials.shape) != part_shape
                              or carry.partials.device != dev
                              or not carry.partials.is_contiguous()):
        raise ValueError(f"carry partials must be {part_shape} float32 on "
                         f"{dev}")
    blk_start = _tile_starts(tile_of_block, num_tiles)
    out = _out_start(out_init, rows_cap, rank, dev)
    carry_out = (torch.empty(part_shape, dtype=torch.float32, device=dev)
                 if tail is not None else None)
    pad = [0] * (MAX_IN_MODES - k)
    lib = _build.load("gather_stream_mttkrp")
    err = getattr(lib, _entry("gather_stream_mttkrp", factors))(
        vals.data_ptr(), idx_stream.data_ptr(), local_row_in_tile.data_ptr(),
        blk_start.data_ptr(), *[f.data_ptr() for f in factors], *pad,
        *[f.shape[0] for f in factors], *pad,
        *[s.data_ptr() for s in scheds], *pad, *windows, *pad,
        out.data_ptr(),
        carry.partials.data_ptr() if carry is not None else 0,
        carry_out.data_ptr() if carry_out is not None else 0,
        k, num_tiles, num_slabs, blk, tile_rows, rank, slab, groups, lanes,
        frow_tile, stages, mappers,
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
    _faults.fault_site("execution.resolve")
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
        _count_launch(fused_mttkrp_nmode_gather_stream, factors)
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
fused_mttkrp_nmode_gather_stream.launches_bf16 = 0


def fused_mttkrp_nmode_gather_stream_plain(vals, idx_stream, factors,
                                           local_row_in_tile, tile_of_block,
                                           tile_schedules, *, rows_cap: int,
                                           blk: int = 128,
                                           tile_rows: int = 8,
                                           frow_tile: int = FACTOR_ROW_TILE,
                                           rank_slab: int = STREAM_RANK_SLAB,
                                           out_init=None):
    """Plain PyTorch version of B6 (runs on any device): B1's plain sum
    with the schedule test (bf16 rows upcast before the products); agrees
    with the kernel to fp32 rounding."""
    factors, scheds, _ = _check_stream_args(
        vals, idx_stream, factors, local_row_in_tile, tile_of_block,
        tile_schedules, rows_cap=rows_cap, blk=blk, tile_rows=tile_rows,
        frow_tile=frow_tile, rank_slab=rank_slab, out_init=out_init)
    return _plain_stream(vals, idx_stream, factors, local_row_in_tile,
                         tile_of_block, scheds, rows_cap=rows_cap, blk=blk,
                         tile_rows=tile_rows, frow_tile=frow_tile,
                         out_init=out_init)


# ---------------------------------------------------------------------------
# B3, B4: fused Hadamard + scatter on pre-gathered rows; B5: the scatter of
# a materialized contribution
# ---------------------------------------------------------------------------

def _fused_slab(rank_padded: int, rank_slab: int | None) -> int:
    return rank_padded if rank_slab is None else min(rank_padded, rank_slab)


def _fused_part_stride(tile_elems: int) -> int:
    """Floats from one of B3/B4's partial tiles to the next: the tile
    rounded up to an odd multiple of 16 (``part_stride`` in
    ``csrc/fused_mttkrp.cu``: two 16-lane groups of a warp then add into
    different banks)."""
    return (tile_elems // 16 | 1) * 16


def fused_smem_bytes(num_in_modes: int, rank_padded: int, tile_rows: int,
                     rank_slab: int | None = None, stages: int = 1,
                     slots: int = FUSED_MIN_SLOTS,
                     gather_itemsize: int = 4) -> int:
    """Shared memory of one CTA of the fused kernels on pre-gathered rows
    (B3; B4 with ``rank_slab``) with a ring of ``stages`` stages of
    ``slots`` slots.

    Byte for byte the layout of ``csrc/fused_mttkrp.cu``: the ring (per
    stage, ``num_in_modes`` row slices of ``slots`` rows one slab wide,
    ``gather_itemsize`` bytes per element: 4 for float32, 2 for bf16), the
    ``groups`` partial output tiles (fp32, each padded to an odd multiple
    of 16 floats), the meta ring
    (``FUSED_META_STAGES`` chunks of ``FUSED_META_CHUNK`` values and local
    rows), one 8-int header per ring stage and meta slot, and two 8-byte
    mbarriers per ring stage and meta slot. The ring holds factor elements
    (the rows), so the count depends on K and on the element type. The
    defaults (one stage of ``FUSED_MIN_SLOTS`` slots) are the smallest
    CTA, the one the residency ladder asks about; the kernel runs the ring
    :func:`fused_ring` picks.
    """
    slab = _fused_slab(rank_padded, rank_slab)
    return (gather_itemsize * stages * num_in_modes * slots * slab
            + 4 * (_groups(tile_rows) * _fused_part_stride(tile_rows * slab)
                   + FUSED_META_STAGES * FUSED_META_CHUNK * 2
                   + (stages + FUSED_META_STAGES) * _FUSED_HDR_INTS)
            + 8 * 2 * (stages + FUSED_META_STAGES))


def fused_ring(num_in_modes: int, rank_padded: int, tile_rows: int,
               rank_slab: int | None = None,
               smem_budget: int = SMEM_LIMIT_BYTES,
               gather_itemsize: int = 4) -> tuple[int, int]:
    """``(stages, slots)`` of the ring B3/B4 run with.

    A stage takes the most slots, a power of two up to
    ``FUSED_STAGE_SLOTS``, whose rows (``num_in_modes`` slab-wide rows per
    slot at ``gather_itemsize`` bytes) stay within ``FUSED_STAGE_BYTES``;
    the ring takes ``FUSED_STAGES`` such stages (``FUSED_SLAB_STAGES`` for
    a slab narrower than the row), as many of them as fit ``smem_budget``
    beside the rest of the CTA (:func:`fused_smem_bytes`), at least two.
    Where two do not fit, the stages halve, down to ``FUSED_MIN_SLOTS``
    slots; where not even two of those fit, one; ``(0, 0)`` when not even
    that fits. The slots and the ring's bytes are monotone in the budget.
    bf16 rows (``gather_itemsize=2``) are half the bytes, so a stage takes
    twice the slots.
    """
    slab = _fused_slab(rank_padded, rank_slab)

    def fits(stages, slots):
        return fused_smem_bytes(num_in_modes, rank_padded, tile_rows,
                                rank_slab, stages=stages, slots=slots,
                                gather_itemsize=gather_itemsize) \
            <= smem_budget
    least = max(FUSED_MIN_SLOTS, _groups(tile_rows))
    want = FUSED_STAGES if slab == rank_padded else FUSED_SLAB_STAGES
    row = num_in_modes * slab * gather_itemsize
    slots = FUSED_STAGE_SLOTS
    while slots > least and slots * row > FUSED_STAGE_BYTES:
        slots //= 2
    while slots >= least:
        if fits(2, slots):
            return max(n for n in range(2, want + 1) if fits(n, slots)), slots
        slots //= 2
    return (1, least) if fits(1, least) else (0, 0)


def fused_stage_partition(run_start: int, run_end: int, vals,
                          slots: int, groups: int):
    """The ring stages B3/B4 post for one output tile's run of slots
    ``[run_start, run_end)``, as ``csrc/fused_mttkrp.cu`` walks it.

    The meta warp cuts the run into chunks of ``FUSED_META_CHUNK`` slots
    from its start, the row warp each chunk into stages of ``slots``
    (``vals`` gives each slot's value: a stage of zeros only is never
    copied). Returns ``(stages, groups_of)``: each posted stage as
    ``(first, count)``, in order, and each slot of a posted stage mapped to
    the group that adds it: group g of the consumers takes the stage's
    slots g, g + groups, ... . A run whose last chunk holds only padding
    posts one more stage without rows, ``(first, 0)``, which carries the
    end of the tile.
    """
    posted = []
    for c0 in range(run_start, run_end, FUSED_META_CHUNK):
        c1 = min(c0 + FUSED_META_CHUNK, run_end)
        live = [(i, min(i + slots, c1)) for i in range(c0, c1, slots)
                if any(float(vals[j]) != 0.0 for j in range(i, min(i + slots,
                                                                   c1)))]
        posted += [(i, j - i) for i, j in live]
        if not live and c1 == run_end:
            posted.append((c0, 0))
    groups_of = {first + j: j % groups
                 for first, count in posted for j in range(count)}
    return posted, groups_of


def segment_slab(rank_padded: int) -> int:
    """B5's column slab: the padded rank up to ``RANK_SLAB``, else the
    widest multiple of ``RANK_MULTIPLE`` up to ``RANK_SLAB`` that divides
    it. B5 splits the columns itself (a grid axis), so it runs at any
    rank."""
    if rank_padded % RANK_MULTIPLE:
        raise ValueError(f"rank {rank_padded} is not a multiple of "
                         f"{RANK_MULTIPLE}")
    if rank_padded <= RANK_SLAB:
        return rank_padded
    return next(s for s in range(RANK_SLAB, 0, -RANK_MULTIPLE)
                if rank_padded % s == 0)


def _segment_chunk(slab: int) -> int:
    """Contribution rows B5 stages at a time: ``SEGMENT_STAGE_BYTES`` of
    rows one slab wide, a multiple of 16 (so of every ``groups``)."""
    return max(16, SEGMENT_STAGE_BYTES // (4 * slab) // 16 * 16)


def segment_smem_bytes(rank_padded: int, tile_rows: int) -> int:
    """Shared memory of one CTA of B5: the ``groups`` partial tiles and the
    staged chunk of contribution rows and local rows, one
    :func:`segment_slab` wide (``csrc/fused_mttkrp.cu``). At most
    ~97 KB for any rank."""
    slab = segment_slab(rank_padded)
    chunk = _segment_chunk(slab)
    return 4 * (_groups(tile_rows) * tile_rows * slab + chunk * slab + chunk)


def _check_fused_args(vals, factor_rows, local_row_in_tile, tile_of_block,
                      *, rows_cap: int, blk: int, tile_rows: int,
                      slab: int | None, out_init):
    """Shapes, dtypes and devices B3/B4 and their plain versions require
    (``slab=None``: the whole rank). Returns ``(factor_rows, R)``."""
    rows, rank = _check_common(
        vals, factor_rows, local_row_in_tile, tile_of_block,
        rows_cap=rows_cap, blk=blk, tile_rows=tile_rows, slab=slab,
        out_init=out_init)
    if any(r.shape[0] != vals.shape[0] for r in rows):
        raise ValueError(f"factor_rows must be ({vals.shape[0]}, R): one row "
                         "per slot")
    return rows, rank


def _plain_fused(vals, rows, local_row_in_tile, tile_of_block, *,
                 rows_cap: int, blk: int, tile_rows: int, out_init):
    rank = rows[0].shape[1]
    out_rows = _stream_rows(tile_of_block, local_row_in_tile, blk, tile_rows)
    out = (torch.zeros(rows_cap, rank, dtype=torch.float32,
                       device=vals.device)
           if out_init is None else out_init.clone())
    step = max(blk, _PLAIN_CHUNK_ELEMS // rank)
    for lo in range(0, vals.shape[0], step):
        contrib = vals[lo:lo + step, None]
        for r in rows:
            contrib = contrib * r[lo:lo + step].float()  # bf16: exact
        out.index_add_(0, out_rows[lo:lo + step], contrib)
    return out


def _launch_fused(vals, rows, local_row_in_tile, tile_of_block, *,
                  rows_cap: int, blk: int, tile_rows: int, slab: int,
                  out_init):
    dev = vals.device
    require_sm90(dev)
    k, rank, n_pad = len(rows), rows[0].shape[1], vals.shape[0]
    itemsize = rows[0].element_size()
    stages, slots = fused_ring(k, rank, tile_rows, rank_slab=slab,
                               gather_itemsize=itemsize)
    if stages < 1:
        smem = fused_smem_bytes(k, rank, tile_rows, rank_slab=slab,
                                gather_itemsize=itemsize)
        raise ValueError(
            f"a {tile_rows} x {slab} output tile with {_groups(tile_rows)} "
            f"partials and a ring of one {FUSED_MIN_SLOTS}-slot stage of "
            f"{k} rows needs {smem} B of shared memory (> "
            f"{SMEM_LIMIT_BYTES}); use the tiled kernel with a narrower "
            "rank_slab")
    if slab < rank and slab > 256:
        raise ValueError(f"rank_slab={slab} < R={rank}: the 2-D tensor "
                         "copy of a slab takes at most 256 columns")
    if not all(t.is_contiguous()
               for t in (vals, local_row_in_tile, tile_of_block) + rows):
        raise ValueError("all operands must be contiguous")
    if n_pad >= 2**31:
        raise ValueError(f"a stream of {n_pad} slots: the kernel keeps "
                         "32-bit slot indices")
    _check_async_operands(
        blk, vals=vals, local_row_in_tile=local_row_in_tile,
        **{f"factor_rows[{w}]": r for w, r in enumerate(rows)})
    num_tiles = rows_cap // tile_rows
    blk_start = _tile_starts(tile_of_block, num_tiles)
    out = _out_start(out_init, rows_cap, rank, dev)
    next_item = torch.zeros(1, dtype=torch.int32, device=dev)
    ptrs = [r.data_ptr() for r in rows] + [0] * (MAX_IN_MODES - k)
    lib = _build.load("fused_mttkrp")
    err = getattr(lib, _entry("fused_mttkrp", rows))(
        vals.data_ptr(), *ptrs, local_row_in_tile.data_ptr(),
        blk_start.data_ptr(), out.data_ptr(), next_item.data_ptr(), k,
        num_tiles, rank // slab, blk, tile_rows, rank, slab,
        _groups(tile_rows), _lanes(slab), n_pad, stages, slots,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            "fused_mttkrp launch failed: "
            f"{lib.fused_mttkrp_error_string(err).decode()} ({err})")
    return out


def _fused_dispatch(vals, rows, local_row_in_tile, tile_of_block, *,
                    slab: int, **kw):
    """CPU tensor: plain version; CUDA tensor: the kernel. Returns
    ``(out, launched)``."""
    _faults.fault_site("execution.resolve")
    if vals.device.type == "cpu":
        return _plain_fused(vals, rows, local_row_in_tile, tile_of_block,
                            **kw), False
    if vals.device.type != "cuda":
        raise ValueError(f"unsupported device {vals.device}")
    return _launch_fused(vals, rows, local_row_in_tile, tile_of_block,
                         slab=slab, **kw), True


def fused_mttkrp_nmode(vals, factor_rows, local_row_in_tile, tile_of_block,
                       *, rows_cap: int, blk: int = 512, tile_rows: int = 8,
                       out_init=None):
    """Fused Hadamard + scatter on pre-gathered rows (B3).

    Args:
      vals: ``(n_pad,)`` float32 block-aligned values; padding slots 0.
      factor_rows: K ``(n_pad, R)`` arrays, all float32 or all bfloat16
        (bf16 gathers, fp32 products and sums), the input factors' rows of
        every slot, block-aligned with ``vals`` (``ops`` gathers them); R a
        multiple of :data:`RANK_MULTIPLE`.
      local_row_in_tile: ``(n_pad,)`` int32 row within the block's tile.
      tile_of_block: ``(n_pad // blk,)`` int32 output tile per block,
        non-decreasing.
      rows_cap: output rows, a multiple of ``tile_rows``.
      out_init: optional ``(rows_cap, R)`` float32 the sum starts from
        (``None``: zeros). It is not modified.

    A slot whose value is 0 adds nothing. Bitwise equal to B1
    (:func:`fused_mttkrp_nmode_gather`) when ``factor_rows[w]`` holds the
    rows B1 gathers. Raises when the output tile's partials and the
    smallest ring do not fit shared memory (:func:`fused_smem_bytes`; at
    tile_rows=8, R <= 304 for K=2 and R <= 272 for K=3 in float32, R <= 336
    and R <= 320 in bf16; :func:`fused_mttkrp_nmode_tiled` takes wider
    ranks). Returns ``(rows_cap, R)`` float32.
    """
    rows, rank = _check_fused_args(
        vals, factor_rows, local_row_in_tile, tile_of_block,
        rows_cap=rows_cap, blk=blk, tile_rows=tile_rows, slab=None,
        out_init=out_init)
    out, launched = _fused_dispatch(
        vals, rows, local_row_in_tile, tile_of_block, slab=rank,
        rows_cap=rows_cap, blk=blk, tile_rows=tile_rows, out_init=out_init)
    if launched:
        _count_launch(fused_mttkrp_nmode, rows)
    return out


fused_mttkrp_nmode.launches = 0
fused_mttkrp_nmode.launches_bf16 = 0


def fused_mttkrp_nmode_tiled(vals, factor_rows, local_row_in_tile,
                             tile_of_block, *, rows_cap: int, blk: int = 512,
                             tile_rows: int = 8, rank_slab: int = RANK_SLAB,
                             out_init=None):
    """Rank-slabbed fused kernel on pre-gathered rows (B4).

    :func:`fused_mttkrp_nmode` with R a multiple of ``rank_slab``: each
    (output tile, column slab) is a work item, whose CTA holds a
    ``tile_rows x rank_slab`` output tile and copies ``rank_slab`` columns
    of each row (2-D tensor copies; a slab narrower than R is at most 256
    columns), so the shared memory does not grow with R. Bitwise equal to
    B3.
    """
    rows, _ = _check_fused_args(
        vals, factor_rows, local_row_in_tile, tile_of_block,
        rows_cap=rows_cap, blk=blk, tile_rows=tile_rows, slab=rank_slab,
        out_init=out_init)
    out, launched = _fused_dispatch(
        vals, rows, local_row_in_tile, tile_of_block, slab=rank_slab,
        rows_cap=rows_cap, blk=blk, tile_rows=tile_rows, out_init=out_init)
    if launched:
        _count_launch(fused_mttkrp_nmode_tiled, rows)
    return out


fused_mttkrp_nmode_tiled.launches = 0
fused_mttkrp_nmode_tiled.launches_bf16 = 0


def fused_mttkrp_nmode_plain(vals, factor_rows, local_row_in_tile,
                             tile_of_block, *, rows_cap: int, blk: int = 512,
                             tile_rows: int = 8, out_init=None):
    """Plain PyTorch version of B3 (elementwise products + ``index_add_``,
    bf16 rows upcast before the products); runs on any device and agrees
    with the kernel to fp32 rounding."""
    rows, _ = _check_fused_args(
        vals, factor_rows, local_row_in_tile, tile_of_block,
        rows_cap=rows_cap, blk=blk, tile_rows=tile_rows, slab=None,
        out_init=out_init)
    return _plain_fused(vals, rows, local_row_in_tile, tile_of_block,
                        rows_cap=rows_cap, blk=blk, tile_rows=tile_rows,
                        out_init=out_init)


def fused_mttkrp_nmode_tiled_plain(vals, factor_rows, local_row_in_tile,
                                   tile_of_block, *, rows_cap: int,
                                   blk: int = 512, tile_rows: int = 8,
                                   rank_slab: int = RANK_SLAB,
                                   out_init=None):
    """Plain PyTorch version of B4: B3's, after B4's argument checks."""
    rows, _ = _check_fused_args(
        vals, factor_rows, local_row_in_tile, tile_of_block,
        rows_cap=rows_cap, blk=blk, tile_rows=tile_rows, slab=rank_slab,
        out_init=out_init)
    return _plain_fused(vals, rows, local_row_in_tile, tile_of_block,
                        rows_cap=rows_cap, blk=blk, tile_rows=tile_rows,
                        out_init=out_init)


def _check_segment_args(contrib, local_row_in_tile, tile_of_block, *,
                        rows_cap: int, blk: int, tile_rows: int) -> None:
    if contrib.dim() != 2 or contrib.dtype != torch.float32 \
            or contrib.shape[1] % RANK_MULTIPLE or contrib.shape[1] == 0:
        raise ValueError(
            f"contrib must be (n_pad, R) float32 with R a positive multiple "
            f"of {RANK_MULTIPLE} (pad with ops.pad_rank), got "
            f"{tuple(contrib.shape)} {contrib.dtype}")
    _check_stream_layout(contrib.shape[0], local_row_in_tile, tile_of_block,
                         rows_cap=rows_cap, blk=blk, tile_rows=tile_rows)
    if any(t.device != contrib.device
           for t in (local_row_in_tile, tile_of_block)):
        raise ValueError("all operands must be on one device")


def _launch_segment(contrib, local_row_in_tile, tile_of_block, *,
                    rows_cap: int, blk: int, tile_rows: int):
    dev = contrib.device
    require_sm90(dev)
    rank = contrib.shape[1]
    slab = segment_slab(rank)
    if not all(t.is_contiguous()
               for t in (contrib, local_row_in_tile, tile_of_block)):
        raise ValueError("all operands must be contiguous")
    if contrib.data_ptr() % 16:
        raise ValueError("contrib must be 16-byte aligned")
    num_tiles = rows_cap // tile_rows
    blk_start = _tile_starts(tile_of_block, num_tiles)
    out = torch.zeros(rows_cap, rank, dtype=torch.float32, device=dev)
    lib = _build.load("fused_mttkrp")
    err = lib.segment_accumulate_launch(
        contrib.data_ptr(), local_row_in_tile.data_ptr(),
        blk_start.data_ptr(), out.data_ptr(), num_tiles, rank // slab, blk,
        tile_rows, rank, slab, _groups(tile_rows), _lanes(slab),
        _segment_chunk(slab), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            "segment_accumulate launch failed: "
            f"{lib.fused_mttkrp_error_string(err).decode()} ({err})")
    return out


def segment_accumulate(contrib, local_row_in_tile, tile_of_block, *,
                       rows_cap: int, blk: int = 512, tile_rows: int = 8):
    """Blocked scatter of a materialized contribution (B5).

    Args:
      contrib: ``(n_pad, R)`` float32 block-aligned contributions, R a
        multiple of :data:`RANK_MULTIPLE`; padding rows are zero.
      local_row_in_tile: ``(n_pad,)`` int32 row within the block's tile.
      tile_of_block: ``(n_pad // blk,)`` int32 output tile per block,
        non-decreasing.
      rows_cap: output rows, a multiple of ``tile_rows``.

    Returns ``(rows_cap, R)`` float32: ``out[r] = Σ contrib[i]`` over the
    slots of row r. The kernel splits the columns into
    :func:`segment_slab`-wide slabs itself, so it runs at any rank; it is
    bitwise equal to B1 when ``contrib`` holds B1's products.
    """
    _check_segment_args(contrib, local_row_in_tile, tile_of_block,
                        rows_cap=rows_cap, blk=blk, tile_rows=tile_rows)
    _faults.fault_site("execution.resolve")
    if contrib.device.type == "cpu":
        return segment_accumulate_plain(
            contrib, local_row_in_tile, tile_of_block, rows_cap=rows_cap,
            blk=blk, tile_rows=tile_rows)
    if contrib.device.type != "cuda":
        raise ValueError(f"unsupported device {contrib.device}")
    out = _launch_segment(contrib, local_row_in_tile, tile_of_block,
                          rows_cap=rows_cap, blk=blk, tile_rows=tile_rows)
    segment_accumulate.launches += 1
    return out


segment_accumulate.launches = 0


def segment_accumulate_plain(contrib, local_row_in_tile, tile_of_block, *,
                             rows_cap: int, blk: int = 512,
                             tile_rows: int = 8):
    """Plain PyTorch version of B5 (one ``index_add_``); runs on any
    device and agrees with the kernel to fp32 rounding."""
    _check_segment_args(contrib, local_row_in_tile, tile_of_block,
                        rows_cap=rows_cap, blk=blk, tile_rows=tile_rows)
    out = torch.zeros(rows_cap, contrib.shape[1], dtype=torch.float32,
                      device=contrib.device)
    return out.index_add_(
        0, _stream_rows(tile_of_block, local_row_in_tile, blk, tile_rows),
        contrib)
