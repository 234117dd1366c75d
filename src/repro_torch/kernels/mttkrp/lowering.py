"""Compile validation of every backend for ``sm_90a``, with no kernel run.

Port of ``repro/kernels/mttkrp/lowering.py``. The reference lowers each
backend's mode step through Mosaic per (backend, geometry) and checks
that a TPU custom call came out: "this compiles for the target". Here
the libraries are built once per source (``build.py``), not per
geometry; what depends on the geometry is the launch configuration. So a
point (backend, geometry) is validated in three steps:

* **(a) whether the geometry can run at all** —
  :func:`compiled_geometry_ok`: ``blk`` a multiple of 4 (the kernels'
  16-byte copies, ``kernel._check_async_operands``), at most
  ``kernel.MAX_IN_MODES`` input modes, the backend's shared memory per
  CTA at this geometry within ``kernel.SMEM_LIMIT_BYTES``
  (``gather_smem_bytes``, ``gather_stream_smem_bytes`` at one ring stage
  and one mapper warp, ``fused_smem_bytes``, ``segment_smem_bytes``) and
  its rank slabs within the grid's y limit. Its verdict equals
  ``oocore.planner.backend_fits`` at that shared-memory budget and an L2
  budget no factor reaches (L2 residency decides speed, not whether a
  kernel can be launched). A point it refuses is reported ``ok=False``
  with the byte count in ``error``; no rung of the residency ladder
  sends work there.
* **(b) the build** — ``build.build()`` compiles the backend's library
  with ``nvcc`` for ``sm_90a``; the library must export the backend's
  launch function and ``ptxas`` must have compiled the backend's kernel,
  at this geometry's input-mode count and element type, for ``sm_90a``.
  Its registers, static shared memory and spill bytes (``-Xptxas -v``,
  kept beside the library by ``build.py``) go into the row.
* **(c) the launch plan** — the grid, block and dynamic shared memory the
  wrapper would pass at this geometry (:func:`launch_plan`), checked
  against the card's opt-in shared-memory limit where a card is present
  and ``kernel.SMEM_LIMIT_BYTES`` where none is, and against the block
  and grid limits. Nothing is launched: the other phases of
  ``chip_smoke.py`` run the kernels.

``ref`` has nothing to build: it passes when (a) does, with
``sm90a=False``, as the reference's ``ref`` passes with ``mosaic=False``.
There is no fallback: with no ``nvcc``, :func:`lower_backend` returns
``ok=False`` with an error naming ``nvcc``, never a passing row made of
(a) and (c) alone.

Entry points: :func:`lower_backend` (one point; never raises),
:func:`run` (a grid of points) and ``python -m
repro_torch.kernels.mttkrp.lowering [--full]``, which exits 0 iff every
point passes: each point either builds with its launch plan, or is
refused by (a).
"""
from __future__ import annotations

import ctypes
import dataclasses
import re
import time

from ...oocore import planner as _planner
from . import build as _build
from . import kernel as _kernel
from . import ops as _ops

__all__ = [
    "Geometry",
    "LaunchPlan",
    "LoweringResult",
    "SMOKE_GEOMETRIES",
    "FULL_GEOMETRIES",
    "compiled_geometry_ok",
    "launch_plan",
    "lower_backend",
    "parse_ptxas_report",
    "kernel_label",
    "kernel_resources",
    "run",
    "main",
]

# CUDA's launch limits: threads per block, grid y and grid x.
MAX_BLOCK_THREADS = 1024
MAX_GRID_Y = 65535
MAX_GRID_X = 2**31 - 1
# The stream kernel's issuer warps (kIssuerWarps in gather_stream_mttkrp.cu).
_STREAM_ISSUER_WARPS = 4
# B1/B2's kernel for bf16 factors at slabs of kernel.BF16_VEC_MIN_SLAB or
# more (16-byte row loads).
_GATHER_VEC_KERNEL = "gather_mttkrp_vec_kernel"

# Per kernel backend: its library, its kernel (the name in the source),
# its launch function and its factor element bytes.
_BACKEND_KERNEL = {
    "pallas": ("fused_mttkrp", "segment_accumulate_kernel",
               "segment_accumulate_launch", 4),
    "pallas_fused": ("fused_mttkrp", "fused_mttkrp_kernel",
                     "fused_mttkrp_launch", 4),
    "pallas_fused_tiled": ("fused_mttkrp", "fused_mttkrp_kernel",
                           "fused_mttkrp_launch", 4),
    "pallas_fused_bf16": ("fused_mttkrp", "fused_mttkrp_kernel",
                          "fused_mttkrp_bf16_launch", 2),
    "pallas_fused_gather": ("gather_mttkrp", "gather_mttkrp_kernel",
                            "gather_mttkrp_launch", 4),
    "pallas_fused_gather_tiled": ("gather_mttkrp", "gather_mttkrp_kernel",
                                  "gather_mttkrp_launch", 4),
    "pallas_fused_gather_bf16": ("gather_mttkrp", "gather_mttkrp_kernel",
                                 "gather_mttkrp_bf16_launch", 2),
    _ops.STREAM_BACKEND: ("gather_stream_mttkrp",
                          "gather_stream_mttkrp_kernel",
                          "gather_stream_mttkrp_launch", 4),
}


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One compile-validation configuration (the reference's fields).

    ``factor_rows`` is the row count of every non-output-mode factor: it
    sizes the stream backend's per-mode window,
    ``min(blk, ceil(rows / frow_tile))`` tiles. ``num_tiles`` output row
    tiles give ``rows_cap = num_tiles * tile_rows``; ``nnz_cap`` is the
    unaligned stream length.
    """

    nmodes: int
    rank: int
    blk: int
    tile_rows: int
    factor_rows: int = 64
    num_tiles: int = 4
    nnz_cap: int = 256

    @property
    def rows_cap(self) -> int:
        return self.num_tiles * self.tile_rows

    def window_tiles(self, *,
                     frow_tile: int = _kernel.FACTOR_ROW_TILE) -> int:
        """The stream backend's data-blind per-mode window at this
        geometry, in ``frow_tile``-row tiles (``frow_tile=128``: the
        reference's)."""
        return _planner.stream_window_tiles(self.blk, self.factor_rows,
                                            frow_tile)

    def label(self) -> str:
        return (f"N{self.nmodes}_R{self.rank}_blk{self.blk}"
                f"_t{self.tile_rows}_rows{self.factor_rows}")


# The reference's grids, value for value. Smoke: one small-everything
# point, a higher-order point, and a multi-slab + multi-tile-window point.
SMOKE_GEOMETRIES = (
    Geometry(nmodes=3, rank=128, blk=128, tile_rows=8, factor_rows=64),
    Geometry(nmodes=4, rank=128, blk=128, tile_rows=128, factor_rows=96),
    Geometry(nmodes=3, rank=256, blk=256, tile_rows=8, factor_rows=300),
)

# Full: adds a 5-mode point, a rank that is not a multiple of 128, wide
# blocks, and a many-tile stream window.
FULL_GEOMETRIES = SMOKE_GEOMETRIES + (
    Geometry(nmodes=5, rank=128, blk=128, tile_rows=16, factor_rows=64),
    Geometry(nmodes=3, rank=200, blk=128, tile_rows=8, factor_rows=64),
    Geometry(nmodes=3, rank=512, blk=384, tile_rows=128, factor_rows=700),
    Geometry(nmodes=4, rank=256, blk=256, tile_rows=32, factor_rows=1000,
             num_tiles=8, nnz_cap=1024),
)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """What a wrapper passes to its kernel's launch: grid, threads per
    block and dynamic shared memory. B3/B4 launch persistent CTAs: their
    ``grid`` is the work items, an upper bound on the CTAs launched."""

    grid: tuple[int, int]
    block: int
    smem: int


@dataclasses.dataclass(frozen=True)
class LoweringResult:
    """Outcome of one (backend, geometry) validation."""

    backend: str
    geometry: Geometry
    ok: bool
    sm90a: bool            # the entry point was found in an sm_90a build
    seconds: float
    error: str = ""
    launchable: bool = True    # step (a)'s verdict
    plan: LaunchPlan | None = None
    registers: int | None = None
    static_smem: int | None = None
    spill_bytes: int | None = None

    def row(self) -> dict:
        """Flat dict for the CLI report and ``chip_smoke.py``."""
        g, p = self.geometry, self.plan
        return dict(
            backend=self.backend, nmodes=g.nmodes, rank=g.rank, blk=g.blk,
            tile_rows=g.tile_rows, factor_rows=g.factor_rows,
            window_tiles=g.window_tiles(), lowered_ok=self.ok,
            sm90a=self.sm90a, launchable=self.launchable,
            grid=list(p.grid) if p else None, block=p.block if p else None,
            smem=p.smem if p else None, registers=self.registers,
            static_smem=self.static_smem, spill_bytes=self.spill_bytes,
            seconds=round(self.seconds, 4), error=self.error)


def _slabs(backend: str, rank: int) -> tuple[int, int]:
    """``(slab, num_slabs)`` the backend's mode step runs at ``rank``
    (``ops.mttkrp_device_step``: the rank padded to a multiple of the
    slab)."""
    rpad = _kernel.padded_rank(rank)
    if backend == _ops.STREAM_BACKEND:
        slab = min(rpad, _kernel.STREAM_RANK_SLAB)
    elif backend in ("pallas_fused_gather_tiled", "pallas_fused_tiled"):
        slab = _ops.tiled_rank_slab(rank)
    elif backend == "pallas":
        slab = _kernel.segment_slab(rpad)
    else:
        slab = rpad
    return slab, _kernel.padded_rank(rank, slab) // slab


def _smem_at_ladder(backend: str, geom: Geometry) -> int:
    """The backend's shared memory per CTA in its smallest configuration:
    what step (a) holds against the limit."""
    k, rpad = geom.nmodes - 1, _kernel.padded_rank(geom.rank)
    slab, _ = _slabs(backend, geom.rank)
    gi = _BACKEND_KERNEL[backend][3]
    if backend in ("pallas_fused_gather", "pallas_fused_gather_bf16"):
        return _kernel.gather_smem_bytes(k, rpad, geom.tile_rows)
    if backend == "pallas_fused_gather_tiled":
        return _kernel.gather_smem_bytes(k, rpad, geom.tile_rows,
                                         rank_slab=slab)
    if backend == _ops.STREAM_BACKEND:
        return _kernel.gather_stream_smem_bytes(
            k, rpad, geom.blk, geom.tile_rows, geom.window_tiles(),
            stages=1, mappers=1, gather_itemsize=gi)
    if backend in ("pallas_fused", "pallas_fused_bf16"):
        return _kernel.fused_smem_bytes(k, rpad, geom.tile_rows,
                                        gather_itemsize=gi)
    if backend == "pallas_fused_tiled":
        return _kernel.fused_smem_bytes(k, rpad, geom.tile_rows,
                                        rank_slab=slab, gather_itemsize=gi)
    return _kernel.segment_smem_bytes(rpad, geom.tile_rows)


def compiled_geometry_ok(geom: Geometry, backend: str | None = None
                         ) -> tuple[bool, str]:
    """Step (a): can ``backend`` launch at ``geom`` at all?

    Returns ``(ok, reason)``. ``backend=None`` checks the rules every
    kernel shares (``blk``, input-mode count); ``ref`` launches nothing
    and takes any geometry; a kernel backend also needs its CTA within
    ``kernel.SMEM_LIMIT_BYTES`` and its rank slabs within the grid's y
    limit.
    """
    if backend == "ref":
        return True, ""
    if geom.blk % 4:
        return False, (f"blk={geom.blk} is not a multiple of 4: the "
                       "kernels' 16-byte copies of a block would be "
                       "misaligned")
    k = geom.nmodes - 1
    if not 1 <= k <= _kernel.MAX_IN_MODES:
        return False, (f"{k} input modes: the kernels take 1.."
                       f"{_kernel.MAX_IN_MODES} (tensor order 2.."
                       f"{_kernel.MAX_IN_MODES + 1})")
    if backend is None:
        return True, ""
    smem = _smem_at_ladder(backend, geom)
    if smem > _kernel.SMEM_LIMIT_BYTES:
        return False, (f"{backend} needs {smem} B of shared memory per CTA "
                       f"at this geometry (> {_kernel.SMEM_LIMIT_BYTES} B)")
    _, num_slabs = _slabs(backend, geom.rank)
    if num_slabs > MAX_GRID_Y:
        return False, (f"{num_slabs} rank slabs exceed the grid's y limit "
                       f"{MAX_GRID_Y}")
    return True, ""


def launch_plan(backend: str, geom: Geometry) -> LaunchPlan | None:
    """Step (c): the grid, block and dynamic shared memory ``backend``'s
    wrapper would pass at ``geom`` (``None`` for ``ref``). Mirrors the
    wrappers in ``kernel.py`` and the launch functions in ``csrc/``."""
    if backend == "ref":
        return None
    k, rpad, tr = geom.nmodes - 1, _kernel.padded_rank(geom.rank), \
        geom.tile_rows
    slab, num_slabs = _slabs(backend, geom.rank)
    gi = _BACKEND_KERNEL[backend][3]
    groups, lanes = _kernel._groups(tr), _kernel._lanes(slab)
    consumers = (groups * lanes + 31) // 32 * 32
    grid = (geom.num_tiles, num_slabs)
    if backend in ("pallas_fused_gather", "pallas_fused_gather_tiled",
                   "pallas_fused_gather_bf16"):
        rcols = _kernel.padded_rank(geom.rank, slab)
        return LaunchPlan(grid, groups * _kernel._gather_lanes(slab, gi),
                          _kernel.gather_smem_bytes(k, rcols, tr,
                                                    rank_slab=slab))
    if backend == _ops.STREAM_BACKEND:
        windows = (geom.window_tiles(),) * k
        stages, mappers = _kernel.stream_ring(k, rpad, geom.blk, tr, windows,
                                              rank_slab=slab,
                                              gather_itemsize=gi)
        return LaunchPlan(
            grid, consumers + 32 * (mappers + _STREAM_ISSUER_WARPS + 1),
            _kernel.gather_stream_smem_bytes(
                k, rpad, geom.blk, tr, windows, rank_slab=slab,
                stages=stages, mappers=mappers, gather_itemsize=gi))
    if backend in ("pallas_fused", "pallas_fused_tiled", "pallas_fused_bf16"):
        rcols = _kernel.padded_rank(geom.rank, slab)
        stages, slots = _kernel.fused_ring(k, rcols, tr, rank_slab=slab,
                                           gather_itemsize=gi)
        return LaunchPlan(
            (geom.num_tiles * num_slabs, 1), consumers + 64,
            _kernel.fused_smem_bytes(k, rcols, tr, rank_slab=slab,
                                     stages=stages, slots=slots,
                                     gather_itemsize=gi))
    return LaunchPlan(grid, groups * lanes,
                      _kernel.segment_smem_bytes(rpad, tr))


def _smem_limit() -> int:
    """The card's opt-in shared memory per block, or
    ``kernel.SMEM_LIMIT_BYTES`` where no card is present."""
    import torch
    if not torch.cuda.is_available():
        return _kernel.SMEM_LIMIT_BYTES
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return int(getattr(props, "shared_memory_per_block_optin",
                       _kernel.SMEM_LIMIT_BYTES))


def check_plan(plan: LaunchPlan, smem_limit: int) -> str:
    """Why ``plan`` cannot launch ('' when it can)."""
    if plan.smem > smem_limit:
        return (f"launch plan needs {plan.smem} B of dynamic shared memory "
                f"(> {smem_limit} B)")
    if not 1 <= plan.block <= MAX_BLOCK_THREADS:
        return f"launch plan has {plan.block} threads per block"
    if not (1 <= plan.grid[0] <= MAX_GRID_X and 1 <= plan.grid[1]
            <= MAX_GRID_Y):
        return f"launch plan has grid {plan.grid}"
    return ""


_ENTRY = re.compile(r"Compiling entry function '([^']+)' for '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def parse_ptxas_report(report: str) -> dict[str, dict]:
    """``ptxas -v`` output → ``{entry function: resources}``.

    Per kernel (its mangled name): ``arch``, ``registers``,
    ``static_smem`` (bytes of ``__shared__`` declared in the source; the
    dynamic part is the launch plan's), ``stack``, ``spill_stores`` and
    ``spill_loads`` (bytes). Functions that are not entry points are
    left out.
    """
    out: dict[str, dict] = {}
    entry = props = None
    for line in report.splitlines():
        m = _ENTRY.search(line)
        if m:
            entry = m.group(1)
            out[entry] = dict(arch=m.group(2), registers=0, static_smem=0,
                              stack=0, spill_stores=0, spill_loads=0)
            continue
        m = _PROPS.search(line)
        if m:
            props = m.group(1)
            continue
        m = _SPILL.search(line)
        if m and props in out:
            out[props].update(stack=int(m.group(1)),
                              spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
            continue
        m = _USED.search(line)
        if m and entry in out:
            out[entry]["registers"] = int(m.group(1))
            s = _SMEM.search(line)
            out[entry]["static_smem"] = int(s.group(1)) if s else 0
    return out


_TEMPLATE_ARGS = re.compile(r"ILi(\d+)E(f|13__nv_bfloat16)E")


def kernel_label(mangled: str) -> str:
    """``gather_mttkrp_kernel<3, bf16>`` for the mangled name of one of
    this package's kernels (``mangled`` itself for any other)."""
    kernels = {kern for _, kern, _, _ in _BACKEND_KERNEL.values()} \
        | {_GATHER_VEC_KERNEL}
    for kern in sorted(kernels | {"l2_read_kernel"}, key=len, reverse=True):
        base = f"{len(kern)}{kern}"
        if base in mangled:
            m = _TEMPLATE_ARGS.match(mangled.split(base, 1)[1])
            if not m:
                return kern
            elem = "float" if m.group(2) == "f" else "bf16"
            return f"{kern}<{m.group(1)}, {elem}>"
    return mangled


def _instantiation(kernel: str, k: int, itemsize: int, mangled: str) -> bool:
    """Is ``mangled`` the ``kernel<k, T>`` the backend launches (any
    instantiation for the one kernel that is not a template)?"""
    base = f"{len(kernel)}{kernel}"
    if base not in mangled:
        return False
    tail = mangled.split(base, 1)[1]
    if not tail.startswith("I"):
        return True
    elem = "f" if itemsize == 4 else "13__nv_bfloat16"
    return tail.startswith(f"ILi{k}E{elem}E")


def kernel_resources(reports: dict[str, str] | None = None) -> list[dict]:
    """Every kernel entry of the built libraries with its ptxas resources,
    ``[{library, kernel, ...parse_ptxas_report fields}]``. ``reports``
    maps a library name to its report (``None``: ``build.build()``'s)."""
    if reports is None:
        reports = {name: rep for name, (_, rep) in _build.build().items()}
    return [dict(library=lib, kernel=name, **res)
            for lib, rep in reports.items()
            for name, res in parse_ptxas_report(rep).items()]


def lower_backend(backend: str, geom: Geometry) -> LoweringResult:
    """Validate one backend at one geometry: (a), then (b) and (c).

    Never raises: every failure, a geometry (a) refuses included, comes
    back as ``ok=False`` with its reason, so a grid reports every broken
    point instead of stopping at the first.
    """
    t0 = time.perf_counter()

    def result(ok, error="", **kw):
        return LoweringResult(backend=backend, geometry=geom, ok=ok,
                              seconds=time.perf_counter() - t0, error=error,
                              **{"sm90a": False, **kw})
    try:
        ok_a, why = compiled_geometry_ok(geom, backend)
        if not ok_a:
            return result(False, why, launchable=False)
        if backend == "ref":
            return result(True)
        library, kernel, entry, itemsize = _BACKEND_KERNEL[backend]
        if kernel == "gather_mttkrp_kernel" and _kernel._vec_rows(
                _slabs(backend, geom.rank)[0], itemsize):
            kernel = _GATHER_VEC_KERNEL   # what the wrapper launches there
        path, report = _build.build()[library]
        lib = ctypes.CDLL(str(path))
        if not hasattr(lib, entry) \
                or entry not in _build._LAUNCH_ARGTYPES[library]:
            return result(False, f"{path.name} does not export {entry}")
        found = [res for name, res in parse_ptxas_report(report).items()
                 if _instantiation(kernel, geom.nmodes - 1, itemsize, name)]
        if not found or any(r["arch"] != "sm_90a" for r in found):
            return result(False, f"ptxas compiled no {kernel} for "
                          f"{geom.nmodes - 1} input modes for sm_90a in "
                          f"{path.name}")
        res = dict(sm90a=True,
                   registers=max(r["registers"] for r in found),
                   static_smem=max(r["static_smem"] for r in found),
                   spill_bytes=max(r["spill_stores"] + r["spill_loads"]
                                   for r in found))
        plan = launch_plan(backend, geom)
        why = check_plan(plan, _smem_limit())
        return result(not why, why, plan=plan, **res)
    except Exception as e:  # noqa: BLE001 — every failure is a result row
        return result(False, f"{type(e).__name__}: {e}")


def run(geometries=SMOKE_GEOMETRIES, backends=_ops.BACKENDS
        ) -> list[LoweringResult]:
    """Validate every backend at every geometry; returns all results."""
    return [lower_backend(b, g) for b in backends for g in geometries]


def failed(results) -> list[LoweringResult]:
    """The points that fail: launchable by (a) but not built or planned."""
    return [r for r in results if r.launchable and not r.ok]


def main(argv=None) -> int:
    """CLI: 0 iff every point builds with its launch plan or is refused
    by the geometry rules."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.kernels.mttkrp.lowering",
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--full", action="store_true",
                    help="the full geometry grid instead of smoke")
    args = ap.parse_args(argv)
    geometries = FULL_GEOMETRIES if args.full else SMOKE_GEOMETRIES
    results = run(geometries)
    for r in results:
        status = "ok  " if r.ok else ("n/a " if not r.launchable else "FAIL")
        print(f"{status} {r.backend:28s} {r.geometry.label():32s} "
              f"{r.seconds:6.2f}s"
              + (f"  {r.error}" if r.error else ""))
    bad = failed(results)
    refused = sum(not r.launchable for r in results)
    n = len(results)
    print(f"lowering {'full' if args.full else 'smoke'}: "
          f"{sum(r.ok for r in results)}/{n} (backend, geometry) points "
          f"build for sm_90a with their launch plans; {refused} refused by "
          f"the geometry rules; {len(bad)} failed")
    return 1 if bad else 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
