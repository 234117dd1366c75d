"""Chunked out-of-core spMTTKRP through the stream kernel (B6).

Port of ``repro/oocore/executor.py``. A mode step's block-aligned
streams are split into chunks of whole nonzero blocks
(:func:`~repro_torch.oocore.planner.chunk_boundaries`: chunk ends prefer
output-tile edges), and each chunk is one call of the stream kernel with
its own tightened window widths. The running output goes from call to
call as ``out_init``; where a chunk ends inside a tile's run the kernel
also hands that tile's partial sums to the next call
(``kernel.StreamCarry``), so the chunked result is bitwise the
single-pass one.

Each chunk launch is the ``oocore.chunk`` fault site
(``resilience.faults``); under an active policy
(``resilience.use_policy``) a transient fault there replays the chunk,
from the same ``out_init`` and carry.

Observability, as in the reference: an ``oocore.mode_step`` span around
the step and an ``oocore.chunk`` span around each chunk (the tracer of
``obs.tracer.get_tracer()``), the step's counted traffic
(``obs.counters.record_stream_stats``) emitted inside the mode-step span
so the roofline (``obs.prof.roofline``) can join it with the span's time,
and ``oocore.mode_step_s`` after it. Under an enabled tracer each chunk
ends with ``torch.cuda.synchronize`` on CUDA, so its span covers its
kernel. Like the fault sites, the counters fire per call; here that is
the reference's count too (its executor is a host loop).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ..kernels.mttkrp import kernel as _kernel
from ..kernels.mttkrp import ops as _ops
from ..obs import counters as _obs
from ..obs import tracer as _tracer
from ..reorder import ordering as _reorder
from ..resilience import faults as _faults
from ..resilience import policy as _policy
from ..runtime.device import resolve_device
from . import planner as _planner

__all__ = ["StreamStats", "mttkrp_out_of_core"]


@dataclasses.dataclass(frozen=True)
class StreamStats:
    """Counted traffic of one chunked out-of-core mode step.

    The tile-fetch counts come from the schedules the chunks run:
    ``scheduled`` is every window slot of every block, ``distinct`` the
    tiles the schedules reference (what the kernel copies: padding slots
    repeat a block's first tile), ``pipelined`` what a pipeline that keeps
    a slot whose tile is unchanged from the previous block would fetch.
    The counted fields equal the reference's for the same geometry; the
    memory sizes are the port's, in shared memory.
    """

    backend: str
    chunks: int
    num_blocks: int
    nnz: int                        # valid nonzeros
    blk: int
    rank_padded: int
    rank_slabs: int
    window_tiles: tuple[int, ...]   # per input mode
    chunk_block_counts: tuple[int, ...]
    scheduled_tile_bytes: int
    distinct_tile_bytes: int
    pipelined_tile_bytes: int
    index_stream_bytes: int         # vals + rows + K index streams, per slab
    window_smem_bytes: int          # one CTA's shared memory, global windows
    resident_equiv_smem_bytes: int  # the same with every factor tile held
    # The ordering the stream was permuted with ("none": as given) and
    # the predicted cost of the stream as it arrived (0 for "none").
    ordering: str = "none"
    presort_scheduled_tile_bytes: int = 0
    presort_distinct_tile_bytes: int = 0

    @property
    def scheduled_over_distinct(self) -> float:
        """The tile re-fetch factor (>= 1.0) an ordering attacks."""
        return self.scheduled_tile_bytes / max(self.distinct_tile_bytes, 1)

    @property
    def presort_scheduled_over_distinct(self) -> float:
        """Same ratio for the stream as it arrived (before reordering)."""
        return (self.presort_scheduled_tile_bytes
                / max(self.presort_distinct_tile_bytes, 1))


def _schedule_fetch_stats(scheds, chunks, chunk_windows, tile_bytes: int,
                          num_slabs: int, distinct_counts
                          ) -> tuple[int, int, int]:
    """Counted (scheduled, distinct, pipelined) tile-fetch bytes of the
    chunk loop: each chunk's schedule cut to that chunk's widths."""
    scheduled = sum((stop - start) * sum(cw)
                    for (start, stop), cw in zip(chunks, chunk_windows))
    distinct = int(distinct_counts.sum())
    pipelined = 0
    for i, s in enumerate(scheds):
        for (start, stop), cw in zip(chunks, chunk_windows):
            c = s[start:stop, :cw[i]]
            pipelined += c.shape[1]                     # first block: all
            pipelined += int((c[1:] != c[:-1]).sum())   # slot changed
    scale = tile_bytes * num_slabs
    return scheduled * scale, distinct * scale, pipelined * scale


def mttkrp_out_of_core(
    idx, val, valid, factors, *, mode: int, rows_cap: int,
    row_offset: int = 0, blk: int = 128, tile_rows: int = 8,
    max_chunk_bytes: int | None = None, gather_dtype: str = "float32",
    ordering: str = "none",
    frow_tile: int = _kernel.FACTOR_ROW_TILE,
    rank_slab: int = _kernel.STREAM_RANK_SLAB,
    rank_multiple: int = _kernel.RANK_MULTIPLE,
    device=None,
):
    """One mode step, out of core: streamed factor tiles, chunked blocks.

    Same data contract as ``ops.mttkrp_device_step`` (stream sorted by
    output row, trailing invalid elements, whole factor matrices), run
    through the stream kernel:

    * per input mode the kernel holds a window of ``frow_tile``-row
      factor tiles in shared memory, tightened to the data (the
      executor sees it);
    * the blocks are split into chunks whose aligned operands (values,
      rows, index streams, schedules) stay under ``max_chunk_bytes``
      (``None``: one chunk), each chunk's windows tightened again;
    * the result is bitwise the single-pass kernel's — and B1's on the
      same stream — for any chunk split.

    ``ordering`` (``reorder.ORDERINGS``) permutes the stream for tile
    locality before alignment (:func:`reorder.reorder_stream`); the
    predicted cost of the stream as it arrived goes into the stats'
    ``presort_*`` fields. ``frow_tile``, ``rank_slab`` and
    ``rank_multiple`` are the geometry (the port's by default). Inputs
    may be numpy arrays or tensors; they run on ``device`` (``None``:
    CUDA).

    ``gather_dtype="bfloat16"`` casts each factor matrix to bf16 before
    the run (the bf16 variant of B6: bf16 window tiles, fp32 products and
    sums); the counted tile bytes are then at 2 bytes per element, as the
    reference counts them. The chunk budget counts the aligned operands
    (values, rows, indices, schedules), which hold no factor element, so
    the chunks are the same at either dtype. Anything else raises
    ``ValueError``.

    Returns ``(out, stats)``: ``(rows_cap, R)`` float32 and a
    :class:`StreamStats`.
    """
    gdt = _ops.check_gather_dtype(gather_dtype)
    gi = gdt.itemsize
    _reorder.validate_ordering(ordering)
    dev = resolve_device(device)
    idx = torch.as_tensor(idx).to(dev)
    val = torch.as_tensor(val, dtype=torch.float32).to(dev)
    valid = torch.as_tensor(valid, dtype=torch.bool).to(dev)
    factors = [torch.as_tensor(f, dtype=torch.float32).to(dev)
               for f in factors]
    in_modes = [w for w in range(idx.shape[1]) if w != mode]
    k = len(in_modes)
    rank = factors[mode].shape[-1]
    rpad, slab, num_slabs = _planner.stream_slabs(rank, rank_slab,
                                                  rank_multiple)
    factor_rows = tuple(factors[w].shape[0] for w in in_modes)

    presort_scheduled_b = presort_distinct_b = 0
    if ordering != "none":
        pre = _planner.predict_stream_traffic(
            idx, valid, mode=mode, rows_cap=rows_cap, blk=blk,
            tile_rows=tile_rows, rank=rank, factor_rows=factor_rows,
            row_offset=row_offset, ordering="none",
            max_chunk_bytes=max_chunk_bytes, frow_tile=frow_tile,
            rank_slab=rank_slab, rank_multiple=rank_multiple,
            gather_itemsize=gi)
        presort_scheduled_b = pre.scheduled_tile_bytes
        presort_distinct_b = pre.distinct_tile_bytes
        idx, val, valid, _ = _reorder.reorder_stream(
            idx, val, valid, mode=mode, ordering=ordering,
            tile_rows=tile_rows, row_offset=row_offset, frow_tile=frow_tile,
            max_rows=max(factor_rows))

    # Block-aligned streams as for B1; factors cast to the gather dtype,
    # padded to rpad columns and to whole tiles of rows.
    vals, idx_al, fmats, r_al, tob = _ops.gather_operands(
        idx, val, valid, factors, mode=mode, rows_cap=rows_cap,
        row_offset=row_offset, blk=blk, tile_rows=tile_rows, slab=rpad,
        dtype=gdt)
    fmats = tuple(_ops._pad_factor_rows(f, frow_tile) for f in fmats)
    scheds, windows, dcounts = _ops.stream_schedules(
        idx_al, blk, tuple(f.shape[0] for f in fmats), frow_tile=frow_tile)
    tob_host = tob.cpu()
    chunks, cwindows = _planner.plan_chunks(
        tob_host, dcounts, windows, blk=blk, max_chunk_bytes=max_chunk_bytes)
    num_blocks = vals.shape[0] // blk
    scheduled_b, distinct_b, pipelined_b = _schedule_fetch_stats(
        scheds, chunks, cwindows, frow_tile * slab * gi, num_slabs, dcounts)
    smem_kw = dict(frow_tile=frow_tile, rank_slab=slab, gather_itemsize=gi)
    stats = StreamStats(
        backend=_planner.STREAM_BACKEND,
        chunks=len(chunks),
        num_blocks=num_blocks,
        nnz=int(valid.sum()),
        blk=blk,
        rank_padded=rpad,
        rank_slabs=num_slabs,
        window_tiles=windows,
        chunk_block_counts=tuple(stop - start for start, stop in chunks),
        scheduled_tile_bytes=scheduled_b,
        distinct_tile_bytes=distinct_b,
        pipelined_tile_bytes=pipelined_b,
        index_stream_bytes=num_slabs * vals.shape[0] * (4 + 4 + 4 * k),
        window_smem_bytes=_kernel.gather_stream_smem_bytes(
            k, rpad, blk, tile_rows, windows, **smem_kw),
        resident_equiv_smem_bytes=_kernel.gather_stream_smem_bytes(
            k, rpad, blk, tile_rows,
            [f.shape[0] // frow_tile for f in fmats], **smem_kw),
        ordering=ordering,
        presort_scheduled_tile_bytes=presort_scheduled_b,
        presort_distinct_tile_bytes=presort_distinct_b,
    )

    tracer = _tracer.get_tracer()
    out = torch.zeros(rows_cap, rpad, dtype=torch.float32, device=dev)
    carry = None
    pol = _policy.get_policy()
    t_step = time.perf_counter()
    with tracer.span("oocore.mode_step", mode=mode, chunks=len(chunks),
                     backend=_planner.STREAM_BACKEND, rung="stream",
                     ordering=ordering):
        # Inside the span, so the byte deltas land in its self_counters.
        _obs.record_stream_stats(stats)
        for ci, ((start, stop), cw) in enumerate(zip(chunks, cwindows)):
            def _launch(out=out, carry=carry, start=start, stop=stop, cw=cw):
                # Registered failure boundary: one chunk is one kernel
                # launch, the unit a transient fault costs and the policy
                # replays. The kernel never writes out_init or the carry,
                # so a replay starts from the same state.
                _faults.fault_site("oocore.chunk")
                sl = slice(start * blk, stop * blk)
                return _kernel.fused_mttkrp_nmode_gather_stream_chunk(
                    vals[sl], idx_al[sl], fmats, r_al[sl], tob[start:stop],
                    tuple(s[start:stop, :cw[i]].contiguous()
                          for i, s in enumerate(scheds)),
                    rows_cap=rows_cap, blk=blk, tile_rows=tile_rows,
                    frow_tile=frow_tile, rank_slab=slab, out_init=out,
                    carry=carry,
                    split_tail=bool(stop < num_blocks
                                    and tob_host[stop] == tob_host[stop - 1]))

            with tracer.span("oocore.chunk", chunk=ci, blocks=stop - start):
                out, carry = (_launch() if pol is None
                              else pol.run("oocore.chunk", _launch))
                if tracer.enabled and dev.type == "cuda":
                    torch.cuda.synchronize(dev)
    _obs.add("oocore.mode_step_s", time.perf_counter() - t_step,
             backend=_planner.STREAM_BACKEND, ordering=ordering)
    return out[:, :rank], stats
