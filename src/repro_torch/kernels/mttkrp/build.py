"""Build and load the hand-written CUDA kernels of this package.

The sources under ``csrc/`` have a plain C interface: ``nvcc`` compiles
them into a shared library, and ``ctypes`` loads it (route (b): no
PyTorch headers, so a build takes seconds). The library goes into
``build/kernels/`` at the root of the checkout, named by a hash of the
source and the flags, and is built at first use — importing this module
needs neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCE", "NVCC_FLAGS", "build", "load", "nvcc_path"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "gather_mttkrp.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# <checkout>/build/kernels (this file is src/repro_torch/kernels/mttkrp/).
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"

_P, _I = ctypes.c_void_p, ctypes.c_int
_LAUNCH_ARGTYPES = ([_P] * 4          # vals, idx, local rows, block starts
                    + [_P] * 4        # factor pointers f0..f3
                    + [_I] * 4        # factor row counts
                    + [_P]            # out
                    + [_I] * 9        # num_in, num_tiles, num_slabs, blk,
                                      # tile_rows, ld, slab, groups, lanes
                    + [_P])           # stream


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


def _library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{SOURCE.stem}-{digest[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the kernels if no library for this source exists yet.

    Returns ``(path, compiler_output)``; the output holds ``ptxas``'s
    register and shared-memory report, and is empty when the library was
    already built. Concurrent builders each write a private file and
    rename it into place.
    """
    path = _library_path()
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built library with its argument types declared (built if absent)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.gather_mttkrp_launch.argtypes = _LAUNCH_ARGTYPES
    lib.gather_mttkrp_launch.restype = ctypes.c_int
    lib.gather_mttkrp_error_string.argtypes = [ctypes.c_int]
    lib.gather_mttkrp_error_string.restype = ctypes.c_char_p
    return lib
