"""repro_torch.obs — span tracing, unified counters, the counted baseline.

Port of ``repro/obs``, the observability layer the rest of the port
emits into:

* :mod:`repro_torch.obs.counters` — the process-wide
  :class:`CounterRegistry` with its closed namespace (``oocore.dma.*``,
  ``remap.a2a.*``, ``dispatch.backend``, ``cpals.*``, ``resilience.*``,
  …) and the absorbers :func:`record_stream_stats` and
  :func:`record_remap_exchange`;
* :mod:`repro_torch.obs.tracer` — nested wall-time spans with per-span
  counter deltas, Chrome-trace/Perfetto export, no-op by default;
* :mod:`repro_torch.obs.baseline` — the counted-metric baseline gate
  (``bench_torch/obs/BASELINE_counters.json``);
* :mod:`repro_torch.obs.prof` — steady-state profiling, self time, the
  achieved-bandwidth roofline and the timed gate.

CLI: ``python -m repro_torch.obs report|export|validate|baseline`` and
``python -m repro_torch.obs.prof run|report|gate``, each on ``--device``
(default: CUDA).
"""
from .counters import (
    NAMESPACES,
    CounterRegistry,
    add,
    counter_key,
    get_registry,
    record_remap_exchange,
    record_stream_stats,
    split_key,
    use_registry,
)
from .tracer import (
    NULL,
    NullTracer,
    SpanRecord,
    Tracer,
    get_tracer,
    sanitize_span_name,
    set_tracer,
    unique_path,
    use_tracer,
    validate_chrome_trace,
)

__all__ = [
    "NAMESPACES",
    "CounterRegistry",
    "add",
    "counter_key",
    "get_registry",
    "record_remap_exchange",
    "record_stream_stats",
    "split_key",
    "use_registry",
    "NULL",
    "NullTracer",
    "SpanRecord",
    "Tracer",
    "get_tracer",
    "sanitize_span_name",
    "set_tracer",
    "unique_path",
    "use_tracer",
    "validate_chrome_trace",
]
