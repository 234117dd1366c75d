"""Build and load the hand-written CUDA kernels of this package.

The sources under ``csrc/`` have a plain C interface: ``nvcc`` compiles
each into a shared library, and ``ctypes`` loads it (route (b): no
PyTorch headers, so a build takes seconds). The libraries go into
``build/kernels/`` at the root of the checkout, named by a hash of the
source, the shared header and the flags, and are built at first use, all
at once (one ``nvcc`` per source, started together) — importing this
module needs neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "NVCC_FLAGS", "build", "load", "nvcc_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
# Library name -> source; each defines the launch functions of
# `_LAUNCH_ARGTYPES[name]` and `<name>_error_string`.
SOURCES = {
    "gather_mttkrp": CSRC / "gather_mttkrp.cu",              # B1, B2
    "gather_stream_mttkrp": CSRC / "gather_stream_mttkrp.cu",  # B6
    "fused_mttkrp": CSRC / "fused_mttkrp.cu",                # B3, B4, B5
    "l2_probe": CSRC / "l2_probe.cu",          # L2 read-rate yardstick
}
HEADERS = (CSRC / "mttkrp_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# <checkout>/build/kernels (this file is src/repro_torch/kernels/mttkrp/).
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_GATHER_ARGS = (
    [_P] * 4          # vals, idx, local rows, block starts
    + [_P] * 4        # factor pointers f0..f3
    + [_I] * 4        # factor row counts
    + [_P]            # out
    + [_I] * 9        # num_in, num_tiles, num_slabs, blk, tile_rows, ld,
                      # slab, groups, lanes
    + [_P])           # stream
_STREAM_ARGS = (
    [_P] * 4          # vals, idx, local rows, block starts
    + [_P] * 4        # factor pointers f0..f3
    + [_I] * 4        # factor row counts (multiples of frow)
    + [_P] * 4        # schedule pointers s0..s3
    + [_I] * 4        # schedule widths
    + [_P] * 3        # out, carry_in, carry_out
    + [_I] * 15       # num_in, num_tiles, num_slabs, blk, tile_rows, ld,
                      # slab, groups, lanes, frow, stages, mappers,
                      # carry_in_tile, carry_in_phase, carry_out_tile
    + [_P])           # stream
_FUSED_ARGS = (
    [_P]              # vals
    + [_P] * 4        # pre-gathered row arrays r0..r3
    + [_P] * 4        # local rows, block starts, out, work counter
    + [_I] * 12       # num_in, num_tiles, num_slabs, blk, tile_rows, ld,
                      # slab, groups, lanes, n_slots, stages, slots
    + [_P])           # stream
# Library name -> {launch function: argument types}. B1/B2, B3/B4 and B6
# each have a float and a bf16 entry point (the factor or row element
# type); their arguments are the same.
_LAUNCH_ARGTYPES = {
    "gather_mttkrp": {"gather_mttkrp_launch": _GATHER_ARGS,
                      "gather_mttkrp_bf16_launch": _GATHER_ARGS},
    "gather_stream_mttkrp": {
        "gather_stream_mttkrp_launch": _STREAM_ARGS,
        "gather_stream_mttkrp_bf16_launch": _STREAM_ARGS},
    "fused_mttkrp": {
        "fused_mttkrp_launch": _FUSED_ARGS,
        "fused_mttkrp_bf16_launch": _FUSED_ARGS,
        "segment_accumulate_launch": (
            [_P] * 4      # contrib, local rows, block starts, out
            + [_I] * 9    # num_tiles, num_slabs, blk, tile_rows, ld, slab,
                          # groups, lanes, chunk
            + [_P]),      # stream
    },
    "l2_probe": {"l2_read_launch": (
        [_P, _L, _I]      # buffer, 16-byte elements, passes
        + [_I, _I]        # blocks, threads
        + [_P, _P])},     # sink, stream
}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine that has the card")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(
        SOURCES[name].read_bytes()
        + b"".join(h.read_bytes() for h in HEADERS)
        + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _report_path(library: Path) -> Path:
    """Where the ``ptxas`` report of ``library`` is kept."""
    return library.with_suffix(".ptxas.txt")


def build() -> dict[str, tuple[Path, str]]:
    """Compile every library not built yet for its current source, with
    one ``nvcc`` per source running at once.

    Returns ``{name: (path, compiler_output)}``; the output holds
    ``ptxas``'s register, shared-memory and spill report, which is kept
    beside the library (``<name>-<hash>.ptxas.txt``, written before the
    library is renamed into place), so a library already built answers
    with it too. Concurrent builds each write private files and rename
    them into place.
    """
    result, procs = {}, {}
    for name in SOURCES:
        path = _library_path(name)
        if path.exists():
            report = _report_path(path)
            result[name] = (path, report.read_text()
                            if report.exists() else "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (path, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (path, tmp, cmd, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{report}")
            continue
        report_tmp = tmp.with_suffix(".txt.tmp")
        report_tmp.write_text(report)
        os.replace(report_tmp, _report_path(path))
        os.replace(tmp, path)
        result[name] = (path, report)
    if failed:
        raise RuntimeError("\n".join(failed))
    return result


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Library ``name`` of :data:`SOURCES` with its argument types declared
    (every library is built first if absent)."""
    path, _ = build()[name]
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _LAUNCH_ARGTYPES[name].items():
        launch = getattr(lib, fn)
        launch.argtypes = argtypes
        launch.restype = ctypes.c_int
    error_string = getattr(lib, f"{name}_error_string")
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    return lib
