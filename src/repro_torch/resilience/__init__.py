"""``repro_torch.resilience``: fault injection, graceful degradation, resume.

Port of ``repro/resilience``. One contract (**never a silent wrong
answer, never an uncounted fallback**), four pieces:

* :mod:`~repro_torch.resilience.faults`: the closed registry of the
  stack's failure boundaries (:data:`~repro_torch.resilience.faults.SITES`)
  with seeded fault injection for reproducible chaos runs;
* :mod:`~repro_torch.resilience.policy`: bounded retry with backoff for
  transient faults, and a counted walk *down* the residency ladder for
  resource faults;
* :mod:`~repro_torch.resilience.checkpoint`: resumable CP-ALS sweeps
  through the atomic ``repro_torch.checkpoint.CheckpointManager``;
* :mod:`~repro_torch.resilience.numerics`: the escalating-ridge/lstsq
  solve guard.

``python -m repro_torch.resilience [--device cpu|cuda]`` is the seeded
chaos smoke.
"""
from .checkpoint import make_manager, make_state, restore_state, save_state
from .faults import (
    SITES,
    CorruptionFault,
    FaultInjector,
    FaultSpec,
    InjectedFault,
    ResourceFault,
    TransientFault,
    fault_site,
    inject,
    seeded_schedule,
)
from .numerics import GUARD_LEVELS, guarded_solve
from .policy import (
    DEGRADATION_LADDER,
    ResilienceExhausted,
    RetryPolicy,
    get_policy,
    next_rung,
    use_policy,
)

__all__ = [
    "DEGRADATION_LADDER",
    "GUARD_LEVELS",
    "SITES",
    "CorruptionFault",
    "FaultInjector",
    "FaultSpec",
    "InjectedFault",
    "ResilienceExhausted",
    "ResourceFault",
    "RetryPolicy",
    "TransientFault",
    "fault_site",
    "get_policy",
    "guarded_solve",
    "inject",
    "make_manager",
    "make_state",
    "next_rung",
    "restore_state",
    "save_state",
    "seeded_schedule",
    "use_policy",
]
