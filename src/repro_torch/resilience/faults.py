"""Deterministic, seeded fault injection at the stack's failure boundaries.

Port of ``repro/resilience/faults.py``. A decomposition dies in a
handful of well-defined places: the kernel call can fail to build or run
out of a resource (``ops.mttkrp_device_step``), a kernel wrapper's route
decision can find the device path gone (``kernel.py``, where each
wrapper picks its CUDA kernel or plain version), a per-chunk launch can
hiccup (``oocore.executor``), and the remap exchange can drop a link
(``core.distributed.device_remap``). Each of those boundaries calls
:func:`fault_site` with its registered site name. Normally that is a
counted no-op; inside an :func:`inject` block the active
:class:`FaultInjector` raises a *typed* fault when the site's call
index matches its schedule.

Design rules, as in the reference:

* **Closed site registry.** :data:`SITES` is the complete list and
  equals the reference's, so :func:`seeded_schedule` gives the same
  schedule for the same seed. ``tune.table_load`` is
  ``tune.table.CalibrationTable.load``, which the registry
  (``tune.table.find_table``) calls for every table it reads.
* **Seeded, bit-reproducible schedules** (``np.random.default_rng``).
* **Typed faults.** :class:`TransientFault` (retry-able),
  :class:`ResourceFault` (not retry-able at the same rung; the policy
  steps *down* the ladder), :class:`CorruptionFault` (never retried,
  never degraded through). The policy in
  :mod:`repro_torch.resilience.policy` dispatches on these types.
* **Counted, never silent.** Every injection lands in
  ``resilience.injected`` (site + kind labels), every site call in
  ``resilience.site_calls``.

**Sites fire per call, not per trace.** The reference's ``ops.kernel``,
``execution.resolve`` and ``distributed.remap`` sites sit in code that
``jax.jit`` traces, so they fire at trace time: once per mode over all
sweeps, and a degradation there sticks to the cached trace. The port
runs eagerly, so they fire on every call: per worker, per mode, per
sweep, and a degradation lasts for that one call. Site-call counts
therefore equal the reference's only within the first sweep at D=1;
after it the port's indices keep advancing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

from ..obs import counters as _obs

__all__ = [
    "SITES",
    "FAULT_KINDS",
    "InjectedFault",
    "TransientFault",
    "ResourceFault",
    "CorruptionFault",
    "FaultSpec",
    "FaultInjector",
    "active_injector",
    "fault_site",
    "inject",
    "seeded_schedule",
]

# The closed injection-site registry, equal to the reference's: one name
# per failure boundary. Keep sorted.
SITES = (
    "distributed.remap",     # core.distributed.device_remap — the exchange
    "execution.resolve",     # kernels.mttkrp.kernel — each wrapper's route
    "oocore.chunk",          # oocore.executor — per-chunk kernel launch
    "ops.kernel",            # kernels.mttkrp.ops.mttkrp_device_step dispatch
    "tune.table_load",       # tune.table.CalibrationTable.load
)
_SITE_SET = frozenset(SITES)


class InjectedFault(RuntimeError):
    """Base of all injected faults; carries the site and call index."""

    kind = "injected"

    def __init__(self, site: str, index: int, note: str = ""):
        self.site = site
        self.index = index
        super().__init__(
            f"injected {self.kind} fault at site {site!r} (call #{index})"
            + (f": {note}" if note else ""))


class TransientFault(InjectedFault):
    """Retry-able blip (interconnect hiccup, preempted DMA)."""

    kind = "transient"


class ResourceFault(InjectedFault):
    """Out of resource at this rung (shared memory, a failed build):
    retrying identically cannot succeed; step down the residency ladder."""

    kind = "resource"


class CorruptionFault(InjectedFault):
    """Bad bytes (truncated/garbled artifact) — never retried, never
    degraded through; the consumer discards the artifact or aborts."""

    kind = "corruption"


FAULT_KINDS = {
    "transient": TransientFault,
    "resource": ResourceFault,
    "corruption": CorruptionFault,
}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: the ``index``-th call to ``site`` raises ``kind``."""

    site: str
    index: int
    kind: str

    def __post_init__(self):
        if self.site not in _SITE_SET:
            raise ValueError(
                f"unknown fault site {self.site!r}: expected one of {SITES}")
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}: expected one of "
                f"{tuple(FAULT_KINDS)}")
        if self.index < 0:
            raise ValueError(f"fault index must be >= 0, got {self.index}")


# The kind each site defaults to in a seeded schedule — the failure
# mode that boundary realistically produces.
_DEFAULT_KIND = {
    "distributed.remap": "transient",
    "execution.resolve": "resource",
    "oocore.chunk": "transient",
    "ops.kernel": "resource",
    "tune.table_load": "corruption",
}


def seeded_schedule(seed: int, *, sites=SITES, per_site: int = 1,
                    horizon: int = 3,
                    kinds: dict | None = None) -> tuple[FaultSpec, ...]:
    """Deterministic schedule: ``per_site`` faults per site from ``seed``.

    Call indices are drawn without replacement from ``[0, horizon)`` by
    ``np.random.default_rng(seed)`` — bit-reproducible across hosts and
    runs, which is what lets a chaos run pin its counter totals.
    ``kinds`` overrides the per-site default fault kind.
    """
    import numpy as np

    kinds = dict(_DEFAULT_KIND, **(kinds or {}))
    rng = np.random.default_rng(seed)
    specs = []
    for site in sites:
        take = min(per_site, horizon)
        for i in sorted(rng.choice(horizon, size=take, replace=False)):
            specs.append(FaultSpec(site=site, index=int(i), kind=kinds[site]))
    return tuple(specs)


class FaultInjector:
    """Replays a fault schedule against the stack's site hooks.

    Thread-safe per-site call counters; each spec fires exactly once
    (the site's counter advances on every call, so a retried call gets
    a fresh index and passes). ``injected`` records what actually fired,
    for the chaos gate's injected-vs-handled accounting.
    """

    def __init__(self, specs: tuple[FaultSpec, ...] = ()):
        self._lock = threading.Lock()
        self._sched: dict[str, dict[int, str]] = {}
        for s in specs:
            if isinstance(s, (tuple, list)):
                s = FaultSpec(*s)
            dup = self._sched.setdefault(s.site, {}).setdefault(
                s.index, s.kind)
            if dup != s.kind:
                raise ValueError(
                    f"conflicting specs for {s.site!r} call #{s.index}: "
                    f"{dup} vs {s.kind}")
        self.specs = tuple(specs)
        self.calls: dict[str, int] = {}
        self.injected: list[FaultSpec] = []

    def on_call(self, site: str) -> None:
        with self._lock:
            i = self.calls.get(site, 0)
            self.calls[site] = i + 1
            kind = self._sched.get(site, {}).get(i)
        if kind is not None:
            spec = FaultSpec(site=site, index=i, kind=kind)
            self.injected.append(spec)
            _obs.add("resilience.injected", site=site, kind=kind)
            raise FAULT_KINDS[kind](site, i)

    def pending(self) -> tuple[FaultSpec, ...]:
        """Scheduled faults that have not fired (site not called enough)."""
        fired = set(self.injected)
        return tuple(FaultSpec(site, i, kind)
                     for site, by_idx in self._sched.items()
                     for i, kind in by_idx.items()
                     if FaultSpec(site, i, kind) not in fired)


_active: FaultInjector | None = None


def active_injector() -> FaultInjector | None:
    return _active


@contextlib.contextmanager
def inject(specs_or_injector):
    """Activate fault injection for the block; restores on exit.

    Accepts a :class:`FaultInjector` or an iterable of
    :class:`FaultSpec`. Yields the injector so callers can assert on
    ``injected`` / ``pending()`` afterwards. Nesting replaces the outer
    injector for the inner block (sites see one injector at a time).
    """
    global _active
    inj = (specs_or_injector if isinstance(specs_or_injector, FaultInjector)
           else FaultInjector(tuple(specs_or_injector)))
    previous = _active
    _active = inj
    try:
        yield inj
    finally:
        _active = previous


def fault_site(site: str) -> None:
    """The stack-side hook: count the call, raise if scheduled.

    A no-op (plus one counter bump) when no injector is active: the
    production path pays a dict update per host-level call (kernel
    dispatch, route decision, remap, chunk), never per nonzero.
    """
    if site not in _SITE_SET:
        raise ValueError(
            f"unknown fault site {site!r}: expected one of {SITES} — "
            "register new failure boundaries in "
            "repro_torch.resilience.faults.SITES")
    _obs.add("resilience.site_calls", site=site)
    if _active is not None:
        _active.on_call(site)
