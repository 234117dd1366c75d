"""Process-wide counter registry: one namespace for every counted metric.

Port of ``repro/obs/counters.py``. Every layer emits into one flat dotted
namespace (``resilience.retries{site=ops.kernel}``,
``cpals.phase_s{mode=0,phase=mttkrp}``), and tooling (the span tracer's
per-span counter deltas, the chaos smoke's injected-vs-handled check)
reads it back uniformly.

Design rules, as in the reference:

* **Closed namespace.** Every counter's base name must be a member of
  :data:`NAMESPACES`; an undocumented counter is a ``ValueError`` at the
  emit site. The port's namespace holds only what it emits: the CP-ALS
  driver's ``cpals.*`` and the resilience layer's ``resilience.*``. The
  reference's ``resilience.interpret_fallbacks`` is left out (the port
  has no interpreter to fall back to), and so is
  ``resilience.table_fallbacks`` (calibration tables, ROADMAP A12).
* **Labels, not name explosions.** Breakdowns attach as sorted
  ``{key=value}`` suffixes (:func:`counter_key`), so the base name stays
  a stable aggregation key (:meth:`CounterRegistry.total`).
* **Counted, not timed, unless suffixed ``_s``.**
* **stdlib only**, so any layer can emit without an import cycle.

The reference's absorbers ``record_stream_stats`` (oocore DMA bytes) and
``record_remap_exchange`` (all_to_all sizing) are not here: they come
with their emit sites (``oocore.dma.*``, ``remap.a2a.*``) in ROADMAP A11.
"""
from __future__ import annotations

import contextlib
import threading

__all__ = [
    "NAMESPACES",
    "CounterRegistry",
    "add",
    "counter_key",
    "get_registry",
    "split_key",
    "use_registry",
]

# The closed counter namespace. Keep it sorted.
NAMESPACES = (
    "cpals.phase_s",
    "cpals.sweep_s",
    "cpals.sweeps",
    "resilience.checkpoint.restores",
    "resilience.checkpoint.saves",
    "resilience.degradations",
    "resilience.injected",
    "resilience.retries",
    "resilience.site_calls",
    "resilience.solve.guards",
)

_NAMESPACE_SET = frozenset(NAMESPACES)


def counter_key(name: str, labels: dict | None = None) -> str:
    """Canonical registry key: ``name`` or ``name{k=v,...}`` (sorted keys)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def split_key(key: str) -> tuple[str, dict]:
    """Inverse of :func:`counter_key`: ``(base_name, labels)``."""
    if not key.endswith("}") or "{" not in key:
        return key, {}
    name, _, inner = key.partition("{")
    labels = {}
    for part in inner[:-1].split(","):
        if part:
            k, _, v = part.partition("=")
            labels[k] = v
    return name, labels


class CounterRegistry:
    """A flat, labeled, validated counter store.

    Values accumulate with :meth:`add` (ints stay ints; a float emit
    makes the counter float). Thread-safe; snapshots are plain dicts so
    the tracer can diff them per span.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, float] = {}

    def add(self, name: str, value=1, **labels) -> None:
        """Accumulate ``value`` into ``name`` (with optional labels).

        ``name`` must be a member of :data:`NAMESPACES`.
        """
        if name not in _NAMESPACE_SET:
            raise ValueError(
                f"counter {name!r} is not in "
                "repro_torch.obs.counters.NAMESPACES — add it there")
        key = counter_key(name, labels)
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + value

    def get(self, name: str, default=0, **labels):
        return self._counts.get(counter_key(name, labels), default)

    def total(self, prefix: str) -> float:
        """Sum of every counter whose base name starts with ``prefix``."""
        with self._lock:
            return sum(v for k, v in self._counts.items()
                       if split_key(k)[0].startswith(prefix))

    def snapshot(self) -> dict[str, float]:
        """Point-in-time copy (sorted keys: deterministic serialization)."""
        with self._lock:
            return {k: self._counts[k] for k in sorted(self._counts)}

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()

    def __len__(self) -> int:
        return len(self._counts)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"CounterRegistry({len(self._counts)} counters)"


# The process-wide default registry. Emitters resolve it at emit time so
# ``use_registry`` can scope collection.
_REGISTRY = CounterRegistry()


def get_registry() -> CounterRegistry:
    """The currently active process-wide registry."""
    return _REGISTRY


def add(name: str, value=1, **labels) -> None:
    """Emit into the active registry: the one-liner every layer uses."""
    _REGISTRY.add(name, value, **labels)


@contextlib.contextmanager
def use_registry(registry: CounterRegistry | None = None):
    """Scope the active registry (fresh one by default), then restore.

    Everything emitted inside the block, from any module, lands in the
    scoped registry: one run's counters without whatever the process did
    before.
    """
    global _REGISTRY
    scoped = CounterRegistry() if registry is None else registry
    previous = _REGISTRY
    _REGISTRY = scoped
    try:
        yield scoped
    finally:
        _REGISTRY = previous
