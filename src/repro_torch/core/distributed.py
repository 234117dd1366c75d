"""Owner-computes spMTTKRP with dynamic remapping, on D workers.

Port of ``repro/core/distributed.py`` (Alg. 2, Dynasor). Each of the D
workers owns the output rows of the super-shards LPT-assigned to it
(baked into the FLYCOO row permutation): worker ``d`` owns rows
``[d·rows_cap, (d+1)·rows_cap)`` of every mode's ``i_pad``. Per mode it
computes its rows alone (:func:`device_mttkrp`, no reduction: an
all_gather re-replicates the factor), and between modes the nonzeros are
re-bucketed for the next mode's owners and exchanged
(:func:`device_remap`), the layout that keeps storage at ``2·|T|``.

The reference runs this under ``shard_map`` on a device mesh; here the
workers and their collectives are ``core.workers`` objects
(:class:`~.workers.LocalWorkers`: D workers in one process, stacked on a
leading axis; :class:`~.workers.GroupWorkers`: one worker per process of
a ``torch.distributed`` group). Per-worker tensors carry a leading axis
over the workers this process holds. The builders return plain callables
over those tensors:

* :func:`make_spmttkrp_all_modes` — spMTTKRP along all modes, and with
  ``remap=False`` the paper's Fig. 9 "Case 2" (the layout stays in mode-0
  order; later modes psum dense partial outputs);
* :func:`make_baseline_all_modes` with :func:`even_split_pack` — the
  ALTO/HiCOO-style nonzero-parallel baseline: every mode psums a dense
  ``(i_pad, R)`` partial, the traffic Dynasor avoids.

Host preprocessing (:func:`prepare_runtime`, :func:`init_factors`,
:func:`unpermute_factor`, :func:`even_split_pack`) stays numpy and equals
the reference exactly; the stream and factors move to the device in
``core.cpals``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..kernels.mttkrp import ops as kops
from ..obs import counters as _obs
from ..oocore import planner as _planner
from ..resilience import faults as _faults
from . import remap as remap_lib
from .flycoo import FlycooTensor, pack_mode
from .mttkrp import mttkrp

__all__ = [
    "DynasorRuntime",
    "ModePlan",
    "prepare_runtime",
    "permuted_factor_init",
    "init_factors",
    "unpermute_factor",
    "device_mttkrp",
    "local_mttkrp",
    "device_remap",
    "make_spmttkrp_all_modes",
    "make_baseline_all_modes",
    "even_split_pack",
    "stack_workers",
]


class ModePlan(NamedTuple):
    """One mode's kernel configuration: tuned (``repro_torch.tune``), or
    the runtime's static one (:meth:`DynasorRuntime.plan_for`)."""

    backend: str                # segsum | ref | auto | any ops backend
    blk: int                    # nonzero block of this mode's layout
    tile_rows: int              # output row tile of this mode's layout
    # Column slabs the resolved backend runs (oocore.planner.rung_slabs:
    # RANK_SLAB for B2/B4, STREAM_RANK_SLAB for B6, B5's own slab; 1
    # otherwise). Metadata: the kernels derive their grids from shapes.
    rank_slabs: int = 1
    # Stream-window widths per *input* mode, in FACTOR_ROW_TILE-row tiles
    # (the data-blind bound), when the backend is the stream kernel, else
    # (). Metadata: the mode step tightens the windows to the data.
    window_tiles: tuple = ()
    # reorder.ORDERINGS policy of the mode step: not metadata, it
    # changes the aligned stream the kernel sees.
    ordering: str = "none"


@dataclasses.dataclass(frozen=True)
class DynasorRuntime:
    """Static metadata of one decomposition."""

    num_workers: int
    nmodes: int
    rank: int
    rows_cap: tuple[int, ...]   # owned output rows per worker, per mode
    i_pad: tuple[int, ...]      # num_workers * rows_cap, per mode
    nnz_cap: int                # per-worker nonzero capacity
    bucket_cap: int             # exchange per-(src,dst) capacity (max)
    shape: tuple[int, ...]      # natural tensor shape
    blk: int = 512              # nonzero block
    tile_rows: int = 8          # output row tile
    # Per-transition exchange capacities (entry n bounds mode n -> n+1);
    # None means bucket_cap for every transition (``uniform_cap``).
    bucket_caps: tuple[int, ...] | None = None
    # Tuned (backend, blk, tile_rows) per mode from a calibration table;
    # None: every mode takes (blk, tile_rows) above and the caller's
    # backend.
    mode_plans: tuple[ModePlan, ...] | None = None
    # The element type the fused family gathers factor rows in, "float32"
    # or "bfloat16" (bf16 gathers, fp32 products and sums): threaded to
    # every mode step, never chosen by ``auto``.
    gather_dtype: str = "float32"
    ordering: str = "none"

    def __post_init__(self):
        # Checked here, as in the reference: the ref and pallas mode steps
        # never read it, so a typo would otherwise pass silently.
        kops.check_gather_dtype(self.gather_dtype)
        from ..reorder import validate_ordering  # deferred: reorder→kernels
        validate_ordering(self.ordering)

    def bucket_cap_for(self, from_mode: int) -> int:
        """Exchange capacity of the ``from_mode -> from_mode+1`` remap."""
        if self.bucket_caps is None:
            return self.bucket_cap
        return self.bucket_caps[from_mode]

    def plan_for(self, mode: int, backend: str = "auto") -> ModePlan:
        """The kernel configuration of ``mode``: what every mode step
        reads its ``(backend, blk, tile_rows, ordering)`` from.

        A tuned runtime always takes the plan's ``(blk, tile_rows)``
        (``rows_cap`` was rounded to the plan's tile) and substitutes the
        plan's backend only when the caller asked for ``auto``; an
        untuned one gives ``(backend, blk, tile_rows, ordering)`` of the
        runtime. ``rank_slabs`` and ``window_tiles`` are re-derived from
        the resolved backend (``oocore.planner.rung_slabs``, the
        data-blind window over each input mode's ``i_pad``), so an
        explicit override never carries a plan's stale metadata; for an
        unresolved ``auto`` they stay trivial.
        """
        if self.mode_plans is not None:
            p = self.mode_plans[mode]
            if backend != "auto":
                p = p._replace(backend=backend)
        else:
            p = ModePlan(backend, self.blk, self.tile_rows,
                         ordering=self.ordering)
        window = ()
        if p.backend == _planner.STREAM_BACKEND:
            window = tuple(_planner.stream_window_tiles(p.blk, self.i_pad[w])
                           for w in range(self.nmodes) if w != mode)
        return p._replace(rank_slabs=_planner.rung_slabs(p.backend,
                                                         self.rank),
                          window_tiles=window)


def prepare_runtime(
    ft: FlycooTensor, rank: int, *, blk: int | None = None,
    tile_rows: int = 8, uniform_cap: bool = False, table=None,
    gather_dtype: str = "float32", ordering: str | None = None,
) -> tuple[DynasorRuntime, tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Runtime metadata + the initial mode-0 packed layout (H_0), numpy.

    Args:
      uniform_cap: the escape hatch: size every remap exchange to the
        largest transition's capacity instead of each transition's own
        ``remap_capacities`` bound (``bucket_caps=None``).
      table: a calibration table or cost model (``repro_torch.tune``).
        Each mode then gets a tuned ``(backend, blk, tile_rows)`` plan
        (``tune.model.plan_modes``), its ``rows_cap`` rounds to the
        plan's tile, and ``backend="auto"`` callers follow it. ``None``,
        or a table that cannot answer, keeps the static configuration.
      gather_dtype: ``"float32"`` or ``"bfloat16"``, to every mode step.
      ordering: ``reorder.ORDERINGS`` policy of every mode step; ``None``
        inherits ``ft.ordering``.

    Each call counts the exchange's per-transition allocation
    (``obs.counters.record_remap_exchange``: ``remap.a2a.*``,
    ``remap.transitions``), so every driver that builds a runtime counts
    its collective bytes.
    """
    ordering = ft.ordering if ordering is None else ordering
    D = ft.params.num_workers
    plans = None
    if table is not None:
        from ..tune.model import plan_modes  # deferred: tune imports core
        plans = plan_modes(table, ft, rank, ordering=ordering)
    tiles = (tuple(p.tile_rows for p in plans) if plans is not None
             else (tile_rows,) * ft.nmodes)
    rows_cap = tuple(int(-(-mp.rows_cap // t) * t)       # round to tile
                     for mp, t in zip(ft.modes, tiles))
    i_pad = tuple(D * rc for rc in rows_cap)
    blk = int(blk if blk is not None else min(ft.params.g, 512))
    caps = remap_lib.remap_capacities(ft)
    _obs.record_remap_exchange(caps, D, ft.nmodes, uniform_cap=uniform_cap)
    rt = DynasorRuntime(
        num_workers=D, nmodes=ft.nmodes, rank=rank, rows_cap=rows_cap,
        i_pad=i_pad, nnz_cap=ft.nnz_cap,
        bucket_cap=max(caps), shape=ft.tensor.shape,
        blk=blk, tile_rows=tile_rows,
        bucket_caps=None if uniform_cap else tuple(caps),
        mode_plans=plans, gather_dtype=gather_dtype, ordering=ordering,
    )
    # pack_mode used flycoo rows_cap; re-pad indices to tile-rounded layout.
    idx, val, mask = pack_mode(ft, 0)
    idx = _repad_indices(ft, idx, rows_cap)
    return rt, (idx, val, mask)


def _repad_indices(ft: FlycooTensor, idx: np.ndarray,
                   rows_cap: Sequence[int]) -> np.ndarray:
    """Map device-major slots from flycoo rows_cap to tile-rounded rows_cap."""
    out = idx.copy()
    for n, mp in enumerate(ft.modes):
        old, new = mp.rows_cap, rows_cap[n]
        if old == new:
            continue
        dev = idx[..., n] // old
        out[..., n] = dev * new + idx[..., n] % old
    return out


def permuted_factor_init(ft: FlycooTensor, mode: int, rank: int,
                         rows_cap: int, seed: int) -> np.ndarray:
    """Random factor in permuted row space; padding rows exactly zero."""
    rng = np.random.default_rng(seed * 1000 + mode)
    D = ft.params.num_workers
    nat = rng.standard_normal((ft.tensor.shape[mode], rank)).astype(np.float32)
    out = np.zeros((D * rows_cap, rank), np.float32)
    mp = ft.modes[mode]
    # natural row r lives at permuted slot row_perm[r] (re-padded to rows_cap)
    slot = (mp.row_perm // mp.rows_cap) * rows_cap + mp.row_perm % mp.rows_cap
    out[slot] = nat
    return out


def init_factors(ft: FlycooTensor, rt: DynasorRuntime, seed: int = 0):
    return [
        permuted_factor_init(ft, n, rt.rank, rt.rows_cap[n], seed)
        for n in range(rt.nmodes)
    ]


def unpermute_factor(ft: FlycooTensor, rt: DynasorRuntime, mode: int,
                     factor: np.ndarray) -> np.ndarray:
    """Permuted (i_pad, R) → natural (I_n, R)."""
    mp = ft.modes[mode]
    slot = (mp.row_perm // mp.rows_cap) * rt.rows_cap[mode] \
        + mp.row_perm % mp.rows_cap
    return np.asarray(factor)[slot]


def _check_local(x, workers, rt: DynasorRuntime) -> None:
    if workers.num_workers != rt.num_workers:
        raise ValueError(f"{workers.num_workers} workers for a runtime of "
                         f"{rt.num_workers}")
    if x.shape[0] != len(workers.ranks):
        raise ValueError(f"leading axis {x.shape[0]}: this process holds "
                         f"{len(workers.ranks)} workers")


def stack_workers(xs):
    """``torch.stack``, with no copy for one worker's tensor."""
    return xs[0][None] if len(xs) == 1 else torch.stack(xs)


def device_mttkrp(idx, val, mask, factors, mode: int, rt: DynasorRuntime,
                  backend: str, worker: int = 0):
    """Owner-computes local MTTKRP of ``worker`` for ``mode`` →
    ``(rows_cap, R)`` f32: the rows ``[worker·rows_cap, (worker+1)·rows_cap)``
    of the output, from that worker's ``(cap, N)`` stream.

    ``backend`` is ``segsum`` (gather + ``index_add_``), ``auto`` (the
    residency ladder, ``ops.select_backend``, sized with the replicated
    factors' rows) or one of ``ops.BACKENDS`` (``ref``, and B1–B6 behind
    the JAX package's names, the bf16 ones among them). The mode step's
    ``(backend, blk, tile_rows, ordering)`` come from
    ``rt.plan_for(mode, backend)``: a tuned runtime's plan (its backend
    when the caller asks for ``auto``, and it may be ``segsum``), else
    the runtime's static configuration. The runtime's ``gather_dtype``
    applies to the fused and gather kernels. Padding entries (mask off)
    may point at any row: they are masked before the row offset is
    subtracted.
    """
    kops.check_backend(backend, extra=("segsum",))
    plan = rt.plan_for(mode, backend)
    rows_cap = rt.rows_cap[mode]
    # segsum and ref compute the same plain gather + index_add_ here.
    return kops.mttkrp_device_step(
        idx, val, mask, factors, mode=mode, rows_cap=rows_cap,
        row_offset=worker * rows_cap, blk=plan.blk,
        tile_rows=plan.tile_rows,
        backend="ref" if plan.backend == "segsum" else plan.backend,
        gather_dtype=rt.gather_dtype, ordering=plan.ordering)


def local_mttkrp(idx, val, mask, factors, mode, rt, backend, workers):
    """``(L, rows_cap, R)``: :func:`device_mttkrp` of each worker this
    process holds (``workers.ranks``), on its ``(L, cap, ...)`` layouts."""
    return stack_workers([
        device_mttkrp(idx[l], val[l], mask[l], factors, mode, rt, backend,
                      worker=d)
        for l, d in enumerate(workers.ranks)])


def device_remap(idx, val, mask, next_mode: int, rt: DynasorRuntime,
                 workers):
    """Dynamic tensor remapping: re-bucket owned nonzeros for ``next_mode``.

    ``idx (L, cap, N)``, ``val``/``mask`` ``(L, cap)``: the layouts of the
    ``L`` workers this process holds (``workers``, ``core.workers``). Each
    worker buckets its nonzeros by the next mode's owner, into this
    transition's capacity (``rt.bucket_cap_for``), the buckets go through
    ``workers``' all_to_all, and each worker compacts what it received;
    bucketing and compaction run over all local workers at once.

    Returns ``(idx', val', mask', dropped)`` — the new owner-sorted
    layouts, and each local worker's count of nonzeros that exceeded the
    capacity (``(L,)``, 0 when the capacities come from
    ``remap_capacities``).

    The remap is the ``distributed.remap`` fault site
    (``resilience.faults``): the exchange is the one collective of the
    sweep. It fires before any work, so the stepped CP-ALS driver can
    retry the whole call.
    """
    _faults.fault_site("distributed.remap")
    _check_local(idx, workers, rt)
    D, L = rt.num_workers, idx.shape[0]
    cap = rt.bucket_cap_for((next_mode - 1) % rt.nmodes)
    dest = torch.where(
        mask, torch.div(idx[..., next_mode], rt.rows_cap[next_mode],
                        rounding_mode="floor"), D).to(torch.int32)
    (bidx, bval), bmask, dropped = remap_lib.bucket_by_destination(
        dest, (idx, val), D, cap)
    (ridx, rval), rmask = remap_lib.exchange((bidx, bval), bmask, workers)
    del bidx, bval, bmask
    ridx = ridx.reshape(L, -1, rt.nmodes)
    key = ridx[..., next_mode]  # permuted slot == sort by local row
    (oidx, oval), omask = remap_lib.compact_sorted(
        (ridx, rval.reshape(L, -1)), rmask.reshape(L, -1), key, rt.nnz_cap)
    oval = torch.where(omask, oval, 0.0)
    # Padding entries point at row 0 (in-bounds gather, zero value: harmless).
    oidx = torch.where(omask[..., None], oidx, 0)
    return oidx, oval, omask, dropped


def _dense_partial_mttkrp(idx, val, mask, factors, mode: int,
                          rt: DynasorRuntime, workers):
    """Non-owner path: each worker's dense ``(i_pad, R)`` partial over
    all rows (``index_add_``), then psum (the baseline's traffic)."""
    return workers.psum(stack_workers([
        mttkrp(torch.where(m[:, None], i, 0), torch.where(m, v, 0.0),
               factors, mode, rt.i_pad[mode])
        for i, v, m in zip(idx, val, mask)]))


def make_spmttkrp_all_modes(rt: DynasorRuntime, workers, *,
                            backend: str = "segsum", remap: bool = True):
    """spMTTKRP along all modes (the paper's headline benchmark op).

    Returns ``fn(idx, val, mask, *factors) -> (outs, (idx', val', mask'),
    diagnostics)`` over the stacked layouts of the workers this process
    holds (``workers``, ``core.workers``) and the replicated ``(i_pad_n, R)`` factors. ``outs`` are the replicated
    ``(i_pad_n, R)`` MTTKRP results (pre-solve), the primed layouts the
    remapped ones (back at mode 0 after a full cycle), and
    ``diagnostics["dropped"]`` each local worker's ``(L,)`` count of
    nonzeros past an exchange capacity.

    ``remap=False`` is Fig. 9 "Case 2": the layout stays in mode-0 order;
    for modes ≥ 1 each worker computes a dense partial over *all* rows
    and they are psummed (the intermediate-value traffic Dynasor avoids).
    """
    kops.check_backend(backend, extra=("segsum",))

    def run(idx, val, mask, *factors):
        _check_local(idx, workers, rt)
        factors = list(factors)
        outs = []
        dropped = torch.zeros(idx.shape[0], dtype=torch.int64,
                              device=idx.device)
        for n in range(rt.nmodes):
            if remap or n == 0:
                outs.append(workers.all_gather(local_mttkrp(
                    idx, val, mask, factors, n, rt, backend, workers)))
            else:
                outs.append(_dense_partial_mttkrp(idx, val, mask, factors,
                                                  n, rt, workers))
            if remap:
                idx, val, mask, d = device_remap(
                    idx, val, mask, (n + 1) % rt.nmodes, rt, workers)
                dropped = dropped + d
        return outs, (idx, val, mask), {"dropped": dropped}

    return run


def make_baseline_all_modes(rt: DynasorRuntime, workers):
    """ALTO/HiCOO-style nonzero-parallel baseline.

    ``fn(idx, val, mask, *factors) -> outs`` on an even nonzero split
    (:func:`even_split_pack`, no ownership structure): every mode psums a
    dense ``(i_pad_n, R)`` partial per worker. Same outputs as Dynasor;
    different (much larger) collective traffic.
    """
    def run(idx, val, mask, *factors):
        _check_local(idx, workers, rt)
        return [_dense_partial_mttkrp(idx, val, mask, list(factors), n, rt,
                                      workers)
                for n in range(rt.nmodes)]

    return run


def even_split_pack(ft: FlycooTensor, rt: DynasorRuntime):
    """Nonzero-parallel layout for the baseline: even chunks, natural order.

    Indices are still in permuted row space so baseline outputs are directly
    comparable with Dynasor outputs. Returns numpy ``(idx (D, cap, N),
    val (D, cap), mask (D, cap))``.
    """
    D = rt.num_workers
    nnz = ft.nnz
    cap = -(-nnz // D)
    idx = np.zeros((D, cap, ft.nmodes), np.int32)
    val = np.zeros((D, cap), np.float32)
    mask = np.zeros((D, cap), bool)
    perm_idx = _repad_indices(ft, ft.perm_indices.astype(np.int32),
                              rt.rows_cap)
    for d in range(D):
        lo, hi = d * cap, min(nnz, (d + 1) * cap)
        k = hi - lo
        if k <= 0:
            continue
        idx[d, :k] = perm_idx[lo:hi]
        val[d, :k] = ft.tensor.values[lo:hi]
        mask[d, :k] = True
    return idx, val, mask
