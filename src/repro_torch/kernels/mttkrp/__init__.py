"""spMTTKRP: CUDA kernels, block layout, schedules, dispatch, oracles."""
from . import build, kernel, ops, ref  # noqa: F401
