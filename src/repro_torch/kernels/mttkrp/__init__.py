"""In-kernel-gather spMTTKRP: CUDA kernels, block layout, oracles."""
from . import build, kernel, ops, ref  # noqa: F401
