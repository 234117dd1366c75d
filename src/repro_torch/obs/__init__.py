"""repro_torch.obs — span tracing and unified counters.

Port of ``repro/obs`` (the two stdlib-only modules the resilience layer
and the stepped CP-ALS driver emit into):

* :mod:`repro_torch.obs.counters` — the process-wide
  :class:`CounterRegistry` with its closed namespace (``cpals.*``,
  ``resilience.*``);
* :mod:`repro_torch.obs.tracer` — nested wall-time spans with per-span
  counter deltas, Chrome-trace/Perfetto export, no-op by default.

Not yet ported (ROADMAP A11): the baseline gate, ``obs/prof``, the
``python -m repro.obs`` CLI, and the ``record_stream_stats`` /
``record_remap_exchange`` absorbers with their emit sites.
"""
from .counters import (
    NAMESPACES,
    CounterRegistry,
    add,
    counter_key,
    get_registry,
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
