"""In-kernel-gather and stream spMTTKRP: CUDA kernels, block layout,
schedules, oracles."""
from . import build, kernel, ops, ref  # noqa: F401
