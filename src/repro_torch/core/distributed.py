"""Owner-computes spMTTKRP with dynamic remapping, on one device.

Port of ``repro/core/distributed.py`` for one worker (one GPU): the
runtime metadata, the initial packed layout, the permuted factor
initialization, and the per-device mode step (:func:`device_mttkrp`) and
remap (:func:`device_remap`). At D=1 the worker owns every row, so the
all_gather of the JAX version is the identity and the remap is a stable
re-sort into the next mode's row order. D>1 raises ``NotImplementedError``
(ROADMAP A9).

Host preprocessing (:func:`prepare_runtime`, :func:`init_factors`,
:func:`unpermute_factor`) stays numpy and equals the reference exactly;
the stream and factors move to the device in ``core.cpals``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..kernels.mttkrp import ops as kops
from . import remap as remap_lib
from .flycoo import FlycooTensor, pack_mode

__all__ = [
    "DynasorRuntime",
    "prepare_runtime",
    "permuted_factor_init",
    "init_factors",
    "unpermute_factor",
    "device_mttkrp",
    "device_remap",
]


@dataclasses.dataclass(frozen=True)
class DynasorRuntime:
    """Static metadata of one decomposition (the fields this slice reads)."""

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
    # None means bucket_cap for every transition.
    bucket_caps: tuple[int, ...] | None = None
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


def prepare_runtime(
    ft: FlycooTensor, rank: int, *, blk: int | None = None,
    tile_rows: int = 8, table=None,
    gather_dtype: str = "float32", ordering: str | None = None,
) -> tuple[DynasorRuntime, tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Runtime metadata + the initial mode-0 packed layout (H_0), numpy.

    ``gather_dtype`` (``"float32"`` or ``"bfloat16"``) goes to every mode
    step through the runtime. ``table`` (calibration tables, ROADMAP A12)
    must be ``None``.
    """
    if table is not None:
        raise NotImplementedError(
            "calibration tables are not ported yet (ROADMAP A12)")
    ordering = ft.ordering if ordering is None else ordering
    D = ft.params.num_workers
    rows_cap = tuple(int(-(-mp.rows_cap // tile_rows) * tile_rows)
                     for mp in ft.modes)
    i_pad = tuple(D * rc for rc in rows_cap)
    blk = int(blk if blk is not None else min(ft.params.g, 512))
    caps = remap_lib.remap_capacities(ft)
    rt = DynasorRuntime(
        num_workers=D, nmodes=ft.nmodes, rank=rank, rows_cap=rows_cap,
        i_pad=i_pad, nnz_cap=ft.nnz_cap,
        bucket_cap=max(caps), shape=ft.tensor.shape,
        blk=blk, tile_rows=tile_rows,
        bucket_caps=tuple(caps),
        gather_dtype=gather_dtype, ordering=ordering,
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


def _require_one_worker(rt: DynasorRuntime) -> None:
    if rt.num_workers != 1:
        raise NotImplementedError(
            f"num_workers={rt.num_workers}: the multi-GPU path is not "
            "ported yet (ROADMAP A9); build FLYCOO with num_workers=1")


def device_mttkrp(idx, val, mask, factors, mode: int, rt: DynasorRuntime,
                  backend: str):
    """Owner-computes local MTTKRP for ``mode`` → ``(rows_cap, R)`` f32.

    ``backend`` is ``segsum`` (gather + ``index_add_``), ``auto`` (the
    residency ladder, ``ops.select_backend``) or one of ``ops.BACKENDS``
    (``ref``, and B1–B6 behind the JAX package's names, the bf16 ones
    among them). The runtime's ``gather_dtype`` and ``ordering`` apply to
    the fused and gather kernels.
    """
    kops.check_backend(backend, extra=("segsum",))
    _require_one_worker(rt)
    # segsum and ref compute the same plain gather + index_add_ here.
    return kops.mttkrp_device_step(
        idx, val, mask, factors, mode=mode, rows_cap=rt.rows_cap[mode],
        row_offset=0, blk=rt.blk, tile_rows=rt.tile_rows,
        backend="ref" if backend == "segsum" else backend,
        gather_dtype=rt.gather_dtype, ordering=rt.ordering)


def device_remap(idx, val, mask, next_mode: int, rt: DynasorRuntime):
    """Dynamic tensor remapping: re-bucket owned nonzeros for ``next_mode``.

    Returns ``(idx', val', mask', dropped)`` — the new owner-sorted layout.
    """
    _require_one_worker(rt)
    D = rt.num_workers
    cap = rt.bucket_cap_for((next_mode - 1) % rt.nmodes)
    dest = torch.where(
        mask, torch.div(idx[:, next_mode], rt.rows_cap[next_mode],
                        rounding_mode="floor"), D).to(torch.int32)
    (bidx, bval), bmask, dropped = remap_lib.bucket_by_destination(
        dest, (idx, val), D, cap)
    (ridx, rval), rmask = remap_lib.exchange((bidx, bval), bmask, D)
    ridx = ridx.reshape(D * cap, rt.nmodes)
    key = ridx[:, next_mode]  # permuted slot == sort by local row
    (oidx, oval), omask = remap_lib.compact_sorted(
        (ridx, rval.reshape(D * cap)), rmask.reshape(D * cap), key,
        rt.nnz_cap)
    oval = torch.where(omask, oval, 0.0)
    # Padding entries point at row 0 (in-bounds gather, zero value: harmless).
    oidx = torch.where(omask[:, None], oidx, 0)
    return oidx, oval, omask, dropped
