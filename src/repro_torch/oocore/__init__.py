"""Out-of-core spMTTKRP in PyTorch (port of ``repro.oocore``).

* :mod:`repro_torch.oocore.planner` — the stream kernel's windows, the
  chunk plan and the counted traffic predictor, with
  :func:`~repro_torch.oocore.planner.stream_fits_smem`, the shared-memory
  feasibility test of the stream rung.
* :mod:`repro_torch.oocore.executor` — :func:`mttkrp_out_of_core`, a mode
  step through the stream kernel (B6) in chunks of whole blocks, bitwise
  equal to one pass, with counted traffic (``StreamStats``).

The residency ladder (``plan_residency``) comes with ``auto`` (ROADMAP
A6).
"""
from . import executor, planner  # noqa: F401
from .executor import StreamStats, mttkrp_out_of_core

__all__ = ["executor", "planner", "StreamStats", "mttkrp_out_of_core"]
