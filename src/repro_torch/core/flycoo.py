"""FLYCOO tensor format (paper §III): host-side preprocessing.

The port's own copy of ``repro/core/flycoo.py`` (numpy, plus the
locality sort of ``repro_torch.reorder`` on the CPU for the orderings).
Preprocessing works for any ``num_workers``, although the port's device
path runs one worker (one GPU).

Per output mode ``n`` the format:
  * splits the ``|I_n|`` output-factor rows into equal intervals of ``m_n``
    rows; the nonzeros incident on an interval form a **super-shard**;
  * splits each super-shard into **shards** of ``g`` nonzeros (the cache /
    VMEM-fit unit for the compute kernel);
  * assigns super-shards to workers with the LPT greedy schedule (Alg. 3),
    so every nonzero that updates a given output row lands on exactly one
    worker → lock-free owner-computes execution;
  * records, for every nonzero, the shard it belongs to in *every* mode —
    this is what makes dynamic remapping (paper §III-B) a pure data
    movement with no recomputation.

Accelerator adaptation: "worker" is a device on the ``data`` axis. We bake the
super-shard→device assignment into a **row permutation** per mode (device-
major layout, padded to equal rows per device), so the runtime sees plain
contiguous row ownership while preprocessing carries all the load-balancing
intelligence. Factor matrices live in permuted row space throughout CP-ALS
(gram matrices and column norms are permutation-invariant) and are
un-permuted once at the end.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from .schedule import block_cyclic_schedule, lpt_schedule
from .tensors import SparseTensor

__all__ = [
    "PartitionParams",
    "ModePartition",
    "FlycooTensor",
    "choose_partition_params",
    "build_flycoo",
    "pack_mode",
    "gather_operand_bytes",
]


def gather_operand_bytes(nmodes: int, rank: int, g: int,
                         itemsize: int = 4) -> int:
    """Bytes of gathered input-factor rows one shard holds resident.

    The N-mode fused kernel streams N−1 gathered ``(g, R)`` factor-row
    blocks into VMEM per shard (``kernels.mttkrp.kernel.fused_mttkrp_nmode``)
    instead of one materialized contrib block — this is the extra working-set
    term Eq. 3 must carry when the fused path is enabled.
    """
    return (nmodes - 1) * g * rank * itemsize


@dataclasses.dataclass(frozen=True)
class PartitionParams:
    """Tensor partitioning parameters (paper Eq. 2 & 3)."""

    m: tuple[int, ...]        # rows per super-shard interval, per mode
    g: int                    # shard size in nonzeros (cache/VMEM unit)
    num_workers: int          # ν — threads on CPU, data-axis devices on TPU
    theta: float = 0.5        # cache fraction available to Dynasor (paper: 0.5)
    cache_bytes: int = 0      # Γ — informational
    satisfied: bool = True    # Eq.3 satisfied for all modes


@dataclasses.dataclass(frozen=True)
class ModePartition:
    """Per-mode FLYCOO partition metadata."""

    mode: int
    m: int                       # interval (super-shard) width in rows
    num_super: int               # k_n
    super_sizes: np.ndarray      # (k_n,) nnz per super-shard
    shard_counts: np.ndarray     # (k_n,) ceil(size / g)
    super_to_device: np.ndarray  # (k_n,) worker id (LPT or block-cyclic)
    rows_cap: int                # padded rows per worker (static shape)
    row_perm: np.ndarray         # (I_n,) natural row -> device-major slot
    row_unperm: np.ndarray       # (num_workers*rows_cap,) slot -> natural row, -1 pad
    nnz_counts: np.ndarray       # (num_workers,) owned nonzeros per worker


@dataclasses.dataclass(frozen=True)
class FlycooTensor:
    """A sparse tensor in FLYCOO format for ``num_workers`` workers."""

    tensor: SparseTensor
    params: PartitionParams
    modes: list[ModePartition]
    perm_indices: np.ndarray     # (nnz, N) indices mapped through row_perm per mode
    # Nonzero order within equal (owner, output-row) groups; only
    # "none" (original position) is ported.
    ordering: str = "none"

    @property
    def nnz(self) -> int:
        return self.tensor.nnz

    @property
    def nmodes(self) -> int:
        return self.tensor.nmodes

    @property
    def nnz_cap(self) -> int:
        """Static per-worker nonzero capacity (max over modes × workers)."""
        return int(max(mp.nnz_counts.max() for mp in self.modes))

    def owner_of(self, mode: int) -> np.ndarray:
        """(nnz,) worker owning each nonzero for ``mode``."""
        mp = self.modes[mode]
        return mp.super_to_device[
            self.tensor.indices[:, mode] // mp.m
        ].astype(np.int32)

    def bits_per_nonzero(self) -> float:
        """FLYCOO storage model (paper §III-A)."""
        t, p = self.tensor, self.params
        shard_id_bits = t.nmodes * math.log2(max(2, t.nnz / p.g))
        index_bits = sum(math.log2(max(2, d)) for d in t.shape)
        return shard_id_bits + index_bits + 32.0  # β_float = fp32


def choose_partition_params(
    shape: Sequence[int],
    nnz: int,
    num_workers: int,
    *,
    rank: int = 16,
    cache_bytes: int = 128 * 1024 * 1024,
    theta: float = 0.5,
    m_bounds: tuple[int, int] = (1000, 16000),
    g_bounds: tuple[int, int] = (1024, 32768),
    itemsize: int = 4,
    fused_gather: bool = False,
) -> PartitionParams:
    """Pick ``m_n`` and ``g`` per paper Eq. 2 & 3.

    Eq. 2: ``|I_n| / m_n = q·ν`` — super-shard count divisible by workers.
    Eq. 3: ``θ·Γ >= (α·m_n·R + β·g)·ν + σ·Σ_j ceil(|SS_j|/g)`` — working set
    (output rows + one shard per worker + remap pointers) fits the cache
    budget. α = factor-row bytes, β = nonzero bytes, σ = pointer bytes.

    ``fused_gather=True`` targets the N-mode fused kernel: β additionally
    carries the N−1 gathered input-factor rows per nonzero
    (:func:`gather_operand_bytes` / g), shrinking ``g`` so the whole
    gather-operand block set stays cache/VMEM-resident.

    On TPU ``cache_bytes`` is the per-device VMEM budget (≈128 MB on v5e is
    the paper-analogue "total cache"; pass 64 MiB for a single core's view).
    """
    nmodes = len(shape)
    alpha = rank * itemsize
    beta = nmodes * 4 + itemsize        # N int32 coords + value
    if fused_gather:
        beta += gather_operand_bytes(nmodes, rank, 1, itemsize)  # per nnz
    sigma = 8                           # remap pointer
    budget = theta * cache_bytes

    ms: list[int] = []
    for dim in shape:
        if dim <= num_workers:
            m = 1                        # paper §V-A5: m_n = 1 when |I_n| < ν
        else:
            lo, hi = m_bounds
            target = int(np.clip(dim // (4 * num_workers), lo, hi))
            q = max(1, round(dim / (num_workers * target)))
            m = math.ceil(dim / (q * num_workers))
            m = max(1, m)
        ms.append(m)

    # Choose the largest g in bounds satisfying Eq. 3 for every mode
    # (bigger shards amortize grid overhead; the cache term caps them).
    satisfied = True
    g_lo, g_hi = g_bounds
    g = g_hi
    while g >= g_lo:
        ok = True
        for n, dim in enumerate(shape):
            k_n = math.ceil(dim / ms[n])
            est_shards = k_n + math.ceil(nnz / g)   # upper bound on Σ ceil(|SS|/g)
            used = (alpha * ms[n] + beta * g) * num_workers + sigma * est_shards
            if used > budget:
                ok = False
                break
        if ok:
            break
        g //= 2
    if g < g_lo:
        g, satisfied = g_lo, False

    return PartitionParams(
        m=tuple(ms), g=int(g), num_workers=num_workers, theta=theta,
        cache_bytes=cache_bytes, satisfied=satisfied,
    )


def _build_mode(
    t: SparseTensor, mode: int, m: int, g: int, num_workers: int, schedule: str
) -> ModePartition:
    dim = t.shape[mode]
    num_super = math.ceil(dim / m)
    super_of_nnz = t.indices[:, mode] // m
    super_sizes = np.bincount(super_of_nnz, minlength=num_super).astype(np.int64)
    shard_counts = np.ceil(np.maximum(super_sizes, 1) / g).astype(np.int64)

    if schedule == "lpt":
        super_to_device = lpt_schedule(shard_counts, num_workers)
    elif schedule == "cyclic":
        super_to_device = block_cyclic_schedule(num_super, num_workers)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")

    # Device-major row permutation. Super-shards keep their internal row
    # order (FLYCOO keeps rows of an interval together for locality).
    rows_per_dev = np.zeros(num_workers, dtype=np.int64)
    for j in range(num_super):
        lo = j * m
        hi = min(dim, lo + m)
        rows_per_dev[super_to_device[j]] += hi - lo
    rows_cap = int(rows_per_dev.max()) if num_workers > 0 else dim
    rows_cap = max(rows_cap, 1)

    row_perm = np.empty(dim, dtype=np.int64)
    fill = np.zeros(num_workers, dtype=np.int64)
    for j in range(num_super):
        d = super_to_device[j]
        lo = j * m
        hi = min(dim, lo + m)
        n_rows = hi - lo
        base = d * rows_cap + fill[d]
        row_perm[lo:hi] = np.arange(base, base + n_rows)
        fill[d] += n_rows

    row_unperm = np.full(num_workers * rows_cap, -1, dtype=np.int64)
    row_unperm[row_perm] = np.arange(dim)

    owner = super_to_device[super_of_nnz]
    nnz_counts = np.bincount(owner, minlength=num_workers).astype(np.int64)

    return ModePartition(
        mode=mode, m=m, num_super=num_super, super_sizes=super_sizes,
        shard_counts=shard_counts, super_to_device=super_to_device.astype(np.int32),
        rows_cap=rows_cap, row_perm=row_perm, row_unperm=row_unperm,
        nnz_counts=nnz_counts,
    )


def _validate_tensor(t: SparseTensor) -> None:
    """Reject malformed input before any partitioning arithmetic runs.

    FLYCOO preprocessing silently produced garbage on bad input: a
    negative index made ``//`` round toward a nonexistent super-shard, an
    out-of-range index scattered into another row's interval, and a
    non-finite value poisoned every sweep's fit. Each case is a
    ``ValueError`` naming the offending nonzero so the producer can fix
    its extraction, not a crash (or worse, a wrong decomposition) three
    layers down.
    """
    idx, vals = np.asarray(t.indices), np.asarray(t.values)
    if idx.ndim != 2 or idx.shape[1] != len(t.shape):
        raise ValueError(
            f"indices must be (nnz, {len(t.shape)}) for shape {t.shape}, "
            f"got {idx.shape}")
    if vals.shape != (idx.shape[0],):
        raise ValueError(
            f"values must be ({idx.shape[0]},) to match indices, got "
            f"{vals.shape}")
    if idx.size:
        for n, dim in enumerate(t.shape):
            col = idx[:, n]
            bad = np.flatnonzero((col < 0) | (col >= dim))
            if bad.size:
                b = int(bad[0])
                raise ValueError(
                    f"mode-{n} index out of range at nonzero {b}: index "
                    f"{int(col[b])} not in [0, {dim}) — fix the extraction "
                    f"or the declared shape {t.shape} ({bad.size} offending "
                    "nonzeros total)")
    if vals.size and not np.isfinite(vals).all():
        bad = np.flatnonzero(~np.isfinite(vals))
        b = int(bad[0])
        raise ValueError(
            f"non-finite value at nonzero {b}: {vals[b]!r} — a NaN/inf "
            "nonzero poisons every CP-ALS sweep's MTTKRP and fit; drop or "
            f"impute it before building FLYCOO ({bad.size} offending "
            "nonzeros total)")


def build_flycoo(
    t: SparseTensor,
    num_workers: int,
    *,
    params: PartitionParams | None = None,
    rank: int = 16,
    cache_bytes: int = 128 * 1024 * 1024,
    schedule: str = "lpt",
    m_bounds: tuple[int, int] = (1000, 16000),
    g_bounds: tuple[int, int] = (1024, 32768),
    fused_gather: bool = False,
    ordering: str = "none",
) -> FlycooTensor:
    """Preprocess ``t`` into FLYCOO format (paper §V-J stages 1–3).

    ``fused_gather=True`` sizes shards for the N-mode fused kernel's
    gather-operand working set (see :func:`choose_partition_params`).

    ``ordering`` (``repro_torch.reorder.ORDERINGS``) selects the
    locality-aware nonzero order :func:`pack_mode` applies within each
    (owner, output row) group.
    """
    from ..reorder import validate_ordering  # deferred: reorder imports kernels
    validate_ordering(ordering)
    _validate_tensor(t)
    if params is None:
        params = choose_partition_params(
            t.shape, t.nnz, num_workers, rank=rank, cache_bytes=cache_bytes,
            m_bounds=m_bounds, g_bounds=g_bounds, fused_gather=fused_gather,
        )
    modes = [
        _build_mode(t, n, params.m[n], params.g, num_workers, schedule)
        for n in range(t.nmodes)
    ]
    perm_indices = np.stack(
        [modes[n].row_perm[t.indices[:, n]] for n in range(t.nmodes)], axis=1
    ).astype(np.int64)
    return FlycooTensor(tensor=t, params=params, modes=modes,
                        perm_indices=perm_indices, ordering=ordering)


def pack_mode(
    ft: FlycooTensor, mode: int, cap: int | None = None, *,
    frow_tile: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Group nonzeros by mode-``mode`` owner, sorted by permuted output row.

    Returns ``(idx[(D, cap, N)], val[(D, cap)], mask[(D, cap)])`` — the
    initial distributed layout ``H_mode`` of Alg. 2. Padding entries have
    ``val = 0`` and point at local row 0 (they contribute exactly zero).

    When ``ft.ordering != "none"`` the sort's primaries stay (owner,
    permuted output row), but ties within an output row are broken by
    the policy's locality keys over ``frow_tile``-row factor tiles
    (``None``: the port's ``FACTOR_ROW_TILE``) instead of nonzero
    position.
    """
    D = ft.params.num_workers
    cap = int(cap if cap is not None else ft.nnz_cap)
    owner = ft.owner_of(mode)
    if ft.ordering != "none":
        from ..reorder import ordering as _reorder  # deferred: see above
        in_modes = [w for w in range(ft.nmodes) if w != mode]
        order = _reorder.locality_lexsort(
            torch.from_numpy(ft.perm_indices[:, in_modes]), ft.ordering,
            primaries=(torch.from_numpy(owner.astype(np.int64)),
                       torch.from_numpy(ft.perm_indices[:, mode])),
            frow_tile=(_reorder.FACTOR_ROW_TILE if frow_tile is None
                       else frow_tile),
            max_rows=max(ft.params.num_workers * ft.modes[w].rows_cap
                         for w in in_modes)).numpy()
    else:
        # max(initial=0) keeps the empty-tensor case (nnz == 0) a valid
        # all-padding layout instead of a ValueError on .max().
        key = owner.astype(np.int64) \
            * (ft.perm_indices[:, mode].max(initial=0) + 1) \
            + ft.perm_indices[:, mode]
        order = np.argsort(key, kind="stable")

    idx = np.zeros((D, cap, ft.nmodes), dtype=np.int32)
    val = np.zeros((D, cap), dtype=np.float32)
    mask = np.zeros((D, cap), dtype=bool)
    mp = ft.modes[mode]
    for d in range(D):
        sel = order[owner[order] == d]
        k = len(sel)
        if k > cap:
            raise ValueError(f"capacity {cap} < owned nnz {k} on worker {d}")
        idx[d, :k] = ft.perm_indices[sel]
        # Padding gathers factor row 0 of this device's range — harmless.
        idx[d, k:, mode] = d * mp.rows_cap
        val[d, :k] = ft.tensor.values[sel]
        mask[d, :k] = True
    return idx, val, mask
