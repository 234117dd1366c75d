"""Graceful-degradation retry policy: the residency ladder as a safety net.

Port of ``repro/resilience/policy.py``. ``oocore.planner.LADDER`` orders
the kernels for *speed* (B1 → B2 → B6 → B3 → B4 → B5: pick the first
rung that fits). This module walks the same ladder, followed by the
plain ``ref``, as a *fallback*: when a rung fails with a
:class:`~repro_torch.resilience.faults.ResourceFault`, the dispatch
steps one rung **down**. Every rung computes the same mode step from the
same inputs, the kernels bitwise on one aligned stream, so a step down
trades only speed. Transient faults get bounded retry with exponential
backoff. Corruption faults are never retried and never degraded through.

What differs from the reference: it first flips a failing compiled
Pallas call to the Pallas interpreter at the same rung
(``resilience.interpret_fallbacks``). The port has no interpreter, and a
CUDA tensor must not fall back to the CPU, so a resource fault steps
down at once. (On a CPU host the reference's interpreter is already in
use, so it steps down at once too: both packages take the same path.)

Only the typed injected faults are caught. A real CUDA error, a failed
``nvcc`` build or an out-of-memory error propagates: no kernel quietly
gives way to its plain version. Every decision is counted in the
``resilience.*`` namespace (``retries`` / ``degradations``) and logged.

This module imports nothing of the kernel stack (the rungs are string
literals, held equal to ``oocore.planner.LADDER + ("ref",)`` by the
tests), so ``ops.py`` can import it without a cycle; the stack reaches
the active policy through :func:`get_policy` / :func:`use_policy`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Callable

from ..obs import counters as _obs
from .faults import CorruptionFault, ResourceFault, TransientFault

__all__ = [
    "DEGRADATION_LADDER",
    "ResilienceExhausted",
    "RetryPolicy",
    "get_policy",
    "next_rung",
    "use_policy",
]

_LOG = logging.getLogger(__name__)

# The dispatch-level degradation ladder, fastest rung first: the
# reference's tuple, which is the port's oocore.planner.LADDER extended
# down to the plain reference.
DEGRADATION_LADDER = (
    "pallas_fused_gather",
    "pallas_fused_gather_tiled",
    "pallas_fused_gather_stream",
    "pallas_fused",
    "pallas_fused_tiled",
    "pallas",
    "ref",
)


def next_rung(backend: str) -> str | None:
    """The rung below ``backend`` (``None`` at or below the bottom, and
    for backends outside the ladder, such as the bf16 names)."""
    try:
        i = DEGRADATION_LADDER.index(backend)
    except ValueError:
        return None
    return DEGRADATION_LADDER[i + 1] if i + 1 < len(DEGRADATION_LADDER) \
        else None


class ResilienceExhausted(RuntimeError):
    """Retries and the degradation ladder are both spent: the fault was
    real and unrecoverable. Chained to the last underlying fault."""


@dataclasses.dataclass
class RetryPolicy:
    """Bounded retry + ladder degradation configuration.

    ``backoff_base_s=0`` (the default) disables sleeping, so chaos runs
    replay without wall-clock cost. ``sleep`` is injectable for tests.
    """

    max_retries: int = 3
    backoff_base_s: float = 0.0
    backoff_factor: float = 2.0
    sleep: Callable[[float], None] = time.sleep

    def _backoff(self, attempt: int) -> None:
        if self.backoff_base_s > 0:
            self.sleep(self.backoff_base_s
                       * self.backoff_factor ** (attempt - 1))

    def run(self, site: str, thunk: Callable):
        """Host-level bounded retry of ``thunk`` on transient faults.

        A driver phase (a mode's MTTKRP, a remap) or a chunk launch that
        raises :class:`TransientFault` is retried up to ``max_retries``
        times with backoff, each retry counted under
        ``resilience.retries{site=...}``. Resource and corruption faults
        propagate.
        """
        attempt = 0
        while True:
            try:
                return thunk()
            except TransientFault as e:
                attempt += 1
                _obs.add("resilience.retries", site=site)
                _LOG.warning("transient fault at %s (attempt %d/%d): %s",
                             site, attempt, self.max_retries, e)
                if attempt > self.max_retries:
                    raise ResilienceExhausted(
                        f"site {site!r}: {attempt} transient faults in a "
                        f"row exceeded max_retries={self.max_retries}"
                    ) from e
                self._backoff(attempt)

    def dispatch(self, call: Callable[[str], object], backend: str):
        """Degradation-aware kernel dispatch: retry or step down.

        ``call(backend)`` runs one concrete mode step. The walk:

        * :class:`TransientFault`: bounded retry at the same rung;
        * :class:`ResourceFault`: step one rung down the ladder (counted
          ``resilience.degradations{from,to}``);
        * :class:`CorruptionFault`: propagate at once;
        * ladder or retries exhausted: :class:`ResilienceExhausted`
          chained to the last fault.
        """
        current = backend
        retries = 0
        while True:
            try:
                return call(current)
            except CorruptionFault:
                raise
            except TransientFault as e:
                retries += 1
                _obs.add("resilience.retries", site="ops.kernel")
                if retries > self.max_retries:
                    raise ResilienceExhausted(
                        f"backend {current!r}: {retries} transient faults "
                        f"exceeded max_retries={self.max_retries}") from e
                self._backoff(retries)
            except ResourceFault as e:
                nxt = next_rung(current)
                if nxt is None:
                    raise ResilienceExhausted(
                        f"resource fault at the bottom of the degradation "
                        f"ladder (backend {current!r})") from e
                _obs.add("resilience.degradations", **{"from": current,
                                                       "to": nxt})
                _LOG.warning("resource fault at %s (%s); degrading to %s",
                             current, e, nxt)
                current = nxt


# ---------------------------------------------------------------------------
# The process-wide active policy: how the dispatch layer finds it
# ---------------------------------------------------------------------------

_policy: RetryPolicy | None = None


def get_policy() -> RetryPolicy | None:
    """The active policy, or ``None`` (the default: fail fast)."""
    return _policy


@contextlib.contextmanager
def use_policy(policy: RetryPolicy | None = None):
    """Activate a resilience policy for the block; restores on exit.

    ``None`` activates a default :class:`RetryPolicy`. While active,
    ``ops.mttkrp_device_step`` routes through :meth:`RetryPolicy.dispatch`
    and the oocore executor retries chunk launches; drivers
    (``cp_als_distributed(resilience=...)``) enter this scope for the
    whole decomposition.
    """
    global _policy
    scoped = RetryPolicy() if policy is None else policy
    previous = _policy
    _policy = scoped
    try:
        yield scoped
    finally:
        _policy = previous
