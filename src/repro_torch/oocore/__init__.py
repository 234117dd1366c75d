"""Out-of-core spMTTKRP in PyTorch (port of ``repro.oocore``).

* :mod:`repro_torch.oocore.planner` — the residency ladder behind
  ``auto`` (:func:`~repro_torch.oocore.planner.plan_residency`), the
  stream kernel's windows, the chunk plan and the counted traffic
  predictor.
* :mod:`repro_torch.oocore.executor` — :func:`mttkrp_out_of_core`, a mode
  step through the stream kernel (B6) in chunks of whole blocks, bitwise
  equal to one pass, with counted traffic (``StreamStats``).
"""
from . import executor, planner  # noqa: F401
from .executor import StreamStats, mttkrp_out_of_core

__all__ = ["executor", "planner", "StreamStats", "mttkrp_out_of_core"]
