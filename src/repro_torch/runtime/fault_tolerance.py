"""Fault-tolerant training-loop runner + straggler monitoring.

Port of ``repro/runtime/fault_tolerance.py``, on the port's checkpoint
manager. The runner wraps a pure ``train_step`` with the operational loop
a long job needs:

* periodic atomic checkpoints + auto-resume (``CheckpointManager``);
* bounded retry on failed steps (an exception or a NaN loss: roll the
  state back to the last checkpointed one and replay the data);
* straggler detection: per-step wall-time EWMA; a step slower than
  ``threshold×`` the EWMA is logged;
* preemption: SIGTERM triggers a final checkpoint before exit.

Step times are host wall time: a ``train_step`` that launches CUDA work
must wait for it (``float(loss)`` does) before it returns.
"""
from __future__ import annotations

import signal
import time
from typing import Any, Callable, Iterator

from ..checkpoint import CheckpointManager
from ..obs import counters as _obs

__all__ = ["StragglerMonitor", "TrainLoopRunner"]


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, alpha: float = 0.1):
        self.threshold = threshold
        self.alpha = alpha
        self.ewma: float | None = None
        self.events: list[tuple[int, float, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        straggler = False
        if self.ewma is not None and dt > self.threshold * self.ewma:
            self.events.append((step, dt, self.ewma))
            straggler = True
        self.ewma = dt if self.ewma is None else \
            (1 - self.alpha) * self.ewma + self.alpha * dt
        return straggler


class TrainLoopRunner:
    def __init__(self, train_step: Callable, ckpt: CheckpointManager, *,
                 ckpt_every: int = 50, max_retries: int = 2,
                 log_every: int = 10, log_fn: Callable = print):
        self.train_step = train_step
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.log_every = log_every
        self.log = log_fn
        self.monitor = StragglerMonitor()
        self._preempted = False

    def _install_sigterm(self):
        def handler(signum, frame):
            self._preempted = True
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # non-main thread (tests)

    def resume_or(self, state_template, device=None):
        """Restore the latest checkpoint (numeric leaves as tensors on
        ``device``) or return the template as-is."""
        restored, step = self.ckpt.restore(state_template, device=device)
        if restored is None:
            return state_template, 0
        self.log(f"[runner] resumed from step {step}")
        return restored, int(step)

    def run(self, state, batches: Iterator, num_steps: int,
            start_step: int = 0) -> tuple[Any, list[dict]]:
        self._install_sigterm()
        history: list[dict] = []
        last_good = state
        retries = 0
        step = start_step
        it = iter(batches)
        while step < num_steps and not self._preempted:
            data_step, batch = next(it)
            assert data_step == step, (data_step, step)
            t0 = time.perf_counter()
            try:
                state, metrics = self.train_step(state, batch)
                loss = float(metrics["loss"])
                if loss != loss:           # NaN: treat as step failure
                    raise FloatingPointError(f"NaN loss at step {step}")
            except Exception as e:          # noqa: BLE001 — retry path
                retries += 1
                _obs.add("resilience.retries", site="train_step")
                self.log(f"[runner] step {step} failed ({e!r}); "
                         f"retry {retries}/{self.max_retries}")
                if retries > self.max_retries:
                    raise
                state = last_good            # roll back and replay
                it = iter(batches)           # caller passes resumable iter
                continue
            dt = time.perf_counter() - t0
            if self.monitor.observe(step, dt):
                self.log(f"[runner] straggler: step {step} took {dt:.3f}s "
                         f"(ewma {self.monitor.ewma:.3f}s)")
            history.append({"step": step, "loss": loss, "time_s": dt})
            if step % self.log_every == 0:
                self.log(f"[runner] step {step} loss {loss:.4f} "
                         f"{dt*1e3:.1f} ms")
            if self.ckpt_every and step and step % self.ckpt_every == 0:
                self.ckpt.save(step, state)
                _obs.add("resilience.checkpoint.saves")
                last_good = state
                retries = 0
            step += 1
        if self._preempted:
            self.log(f"[runner] SIGTERM — checkpointing step {step}")
            self.ckpt.save(step, state)
            _obs.add("resilience.checkpoint.saves")
        return state, history
