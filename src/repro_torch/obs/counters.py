"""Process-wide counter registry: one namespace for every counted metric.

Port of ``repro/obs/counters.py``. Every layer emits into one flat dotted
namespace (``oocore.dma.scheduled_bytes``, ``remap.a2a.bytes{transition=0}``,
``dispatch.backend{backend=pallas_fused_gather,source=static}``), and
tooling (the span tracer's per-span counter deltas, ``python -m
repro_torch.obs report``, the counted baseline gate
:mod:`repro_torch.obs.baseline`, the roofline of
:mod:`repro_torch.obs.prof`) reads it back uniformly.

Design rules, as in the reference:

* **Closed namespace.** Every counter's base name must be a member of
  :data:`NAMESPACES`; an undocumented counter is a ``ValueError`` at the
  emit site. The port's namespace holds what it emits: the reference's
  names, less those of layers it does not have yet. Left out, each with
  what brings it: ``execution.*`` and ``resilience.interpret_fallbacks``
  (the port has no interpreter to resolve or fall back to; a CUDA tensor
  runs the kernel, a CPU tensor its plain version), ``dryrun.*`` (the
  LM multi-pod dry run ``repro/launch/dryrun.py``: LM scaffolding,
  ROADMAP A15) and ``serve.*`` (the LM scaffolding, A15).
* **A TPU fact translated.** The reference's ``planner.vmem.plan_bytes``
  is the one VMEM budget of its ladder. The Hopper ladder has two
  (``oocore.planner.plan_residency``): shared memory per CTA and the L2
  the gathered factors take. So the plan's bytes are
  ``planner.smem.plan_bytes`` (``ResidencyPlan.smem_bytes``) and
  ``planner.l2.plan_bytes`` (``ResidencyPlan.l2_bytes``).
* **Labels, not name explosions.** Breakdowns attach as sorted
  ``{key=value}`` suffixes (:func:`counter_key`), so the base name stays
  a stable aggregation key (:meth:`CounterRegistry.total`).
* **Counted, not timed, unless suffixed ``_s``.** Counted metrics are
  host-independent and go into the baseline gate; ``_s`` ones never do.
* **stdlib only**, so any layer can emit without an import cycle.

**Sites fire per call, not per trace.** The reference's ``dispatch.*``
and ``planner.*`` counters fire while ``jax.jit`` traces a mode step:
once per static signature per process, 4 for the baseline's 4-mode
run. The port runs eagerly, so ``ops.select_backend`` and
``oocore.planner.plan_residency`` count every call: per worker, per mode,
per sweep (32 in that run: 4 workers x 4 modes x 2 sweeps), as the fault
sites' ``resilience.site_calls`` do (``resilience.faults``). The other
counted names (``oocore.*``, ``reorder.*``, ``remap.*``,
``cpals.sweeps``) fire once per host-level step in both packages and
equal the reference's at its geometry.
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
    "record_remap_exchange",
    "record_stream_stats",
    "split_key",
    "use_registry",
]

# The closed counter namespace. Keep it sorted.
NAMESPACES = (
    "cpals.phase_s",
    "cpals.sweep_s",
    "cpals.sweeps",
    "dispatch.backend",
    "oocore.chunks",
    "oocore.dma.distinct_bytes",
    "oocore.dma.index_stream_bytes",
    "oocore.dma.pipelined_bytes",
    "oocore.dma.scheduled_bytes",
    "oocore.mode_step_s",
    "oocore.mode_steps",
    "ops.step.model_bytes",
    "ops.step_s",
    "planner.l2.plan_bytes",
    "planner.plans",
    "planner.smem.plan_bytes",
    "remap.a2a.bytes",
    "remap.a2a.uniform_bytes",
    "remap.transitions",
    "reorder.dma.postsort_distinct_bytes",
    "reorder.dma.postsort_scheduled_bytes",
    "reorder.dma.presort_distinct_bytes",
    "reorder.dma.presort_scheduled_bytes",
    "reorder.perms",
    "resilience.checkpoint.restores",
    "resilience.checkpoint.saves",
    "resilience.degradations",
    "resilience.injected",
    "resilience.retries",
    "resilience.site_calls",
    "resilience.solve.guards",
    "resilience.table_fallbacks",
    "tune.measure_s",
    "tune.points",
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


# ---------------------------------------------------------------------------
# Absorbers: the counted structs of other layers -> one namespace
# ---------------------------------------------------------------------------

def record_stream_stats(stats) -> None:
    """Absorb an out-of-core ``StreamStats`` into the registry.

    Duck-typed on the stat fields, so this module never imports the
    executor. Each field maps to exactly one counter, so the stats'
    ordering (``scheduled >= distinct``, ``scheduled >= pipelined``)
    survives the round trip. A reordered stream also records the
    before/after tile bytes under ``reorder.dma.*``, labelled with the
    ordering: presort is what the stream as given would have cost,
    postsort repeats the ``oocore.dma.*`` bytes.
    """
    reg = _REGISTRY
    reg.add("oocore.mode_steps", 1, backend=stats.backend)
    reg.add("oocore.chunks", stats.chunks)
    reg.add("oocore.dma.scheduled_bytes", stats.scheduled_tile_bytes)
    reg.add("oocore.dma.distinct_bytes", stats.distinct_tile_bytes)
    reg.add("oocore.dma.pipelined_bytes", stats.pipelined_tile_bytes)
    reg.add("oocore.dma.index_stream_bytes", stats.index_stream_bytes)
    if getattr(stats, "ordering", "none") != "none":
        o = stats.ordering
        reg.add("reorder.dma.presort_scheduled_bytes",
                stats.presort_scheduled_tile_bytes, ordering=o)
        reg.add("reorder.dma.presort_distinct_bytes",
                stats.presort_distinct_tile_bytes, ordering=o)
        reg.add("reorder.dma.postsort_scheduled_bytes",
                stats.scheduled_tile_bytes, ordering=o)
        reg.add("reorder.dma.postsort_distinct_bytes",
                stats.distinct_tile_bytes, ordering=o)


def record_remap_exchange(caps, num_workers: int, nmodes: int, *,
                          uniform_cap: bool = False) -> None:
    """Absorb a runtime's per-transition all_to_all sizing.

    ``caps`` is ``remap_capacities(ft)``: entry ``n`` bounds the mode
    ``n -> n+1`` exchange. Bytes per transition are the reference's
    allocated payload ``D * D * cap * (4 * nmodes + 4)``: an int32
    coordinate per mode and a float32 value per slot. The port's exchange
    sends the same coordinates and values, as two tensors, plus a bool
    mask per slot (``core.remap.exchange``); the counter keeps the
    reference's arithmetic, so the two packages' counts stay comparable.
    ``remap.a2a.uniform_bytes`` is what one capacity of ``max(caps)`` for
    every transition allocates, as the reference computes it; with
    ``uniform_cap`` (``prepare_runtime``'s escape hatch) every
    transition's ``remap.a2a.bytes`` is that capacity's.
    """
    reg = _REGISTRY
    caps = [int(c) for c in caps]
    per_pair = num_workers * num_workers * (4 * nmodes + 4)
    cap_used = [max(caps)] * len(caps) if uniform_cap else caps
    for n, cap in enumerate(cap_used):
        reg.add("remap.a2a.bytes", cap * per_pair, transition=n)
    reg.add("remap.a2a.uniform_bytes", len(caps) * max(caps) * per_pair)
    reg.add("remap.transitions", len(caps))
