"""``repro_torch.obs.prof`` — wall-clock profiling over the obs tracer.

Port of ``repro.obs.prof``. Four pieces, all stdlib-only at import time
(torch is only imported when a profile actually runs):

* :mod:`.harness`  — steady-state timing (warmup + fenced repeats; the
  fence is ``torch.cuda.synchronize`` on CUDA), median/MAD robust stats,
  host and card fingerprint, noise calibration.
* :mod:`.selftime` — span self-time attribution: top-down / bottom-up
  tables and collapsed-stack flamegraph export.
* :mod:`.roofline` — achieved bandwidth: measured span time joined with
  counted byte deltas, per kernel backend and residency rung.
* :mod:`.gate`     — the noise-aware timed regression gate over versioned
  ``bench_torch/obs/PROF_*.json`` artifacts.

CLI: ``python -m repro_torch.obs.prof run|report|gate [--update-baseline]
[--device]``.
"""
from .gate import (GateResult, MAX_RATIO, NOISE_BAR, PROF_SCHEMA,
                   TOLERANCE_Z, compare, validate_prof)
from .harness import (MAD_SIGMA, OUTLIER_Z, PhaseStats, env_fingerprint,
                      fingerprint_compatible, measure_steady,
                      noise_calibration, robust_stats)
from .roofline import (RUNG_BY_BACKEND, bandwidth_rows, mode_breakdown,
                       moved_bytes)
from .selftime import (bottomup_table, flamegraph_lines, self_times_s,
                       span_paths, topdown_table, write_flamegraph)

__all__ = [
    "GateResult",
    "MAD_SIGMA",
    "MAX_RATIO",
    "NOISE_BAR",
    "OUTLIER_Z",
    "PROF_SCHEMA",
    "PhaseStats",
    "RUNG_BY_BACKEND",
    "TOLERANCE_Z",
    "bandwidth_rows",
    "bottomup_table",
    "compare",
    "env_fingerprint",
    "fingerprint_compatible",
    "flamegraph_lines",
    "measure_steady",
    "mode_breakdown",
    "moved_bytes",
    "noise_calibration",
    "robust_stats",
    "self_times_s",
    "span_paths",
    "topdown_table",
    "validate_prof",
    "write_flamegraph",
]
