"""Fault-tolerant training-loop runner + straggler monitoring.

Port of ``repro/runtime/fault_tolerance.py``, on the port's checkpoint
manager. The runner wraps a ``train_step`` with the operational loop a
long job needs:

* periodic atomic checkpoints + auto-resume (``CheckpointManager``);
* bounded retry on failed steps (an exception or a NaN loss: roll the
  state back to the last checkpointed one and replay the data);
* straggler detection: per-step wall-time EWMA; a step slower than
  ``threshold×`` the EWMA is logged;
* preemption: SIGTERM triggers a final checkpoint before exit.

Step times are host wall time: a ``train_step`` that launches CUDA work
must wait for it (``float(loss)`` does) before it returns.

Rollback. The reference's step is functional, so its runner rolls back by
keeping a reference to the last checkpointed state. The port's train step
(``models.steps.make_train_step``) updates its state in place, and a step
that fails after its update began leaves that state changed. So a retry
re-materializes the state, as the reference's docstring puts it: from the
checkpoint this run saved last (``CheckpointManager.restore``); before its
first save, from the checkpoint ``resume_or`` restored it from, or else
from a host copy of the state the run started from. The values are copied
back into the state's own tensors; a leaf that is not a tensor is replaced
by the restored value.

The loop then goes back to the step after that state and replays the
batches it took since, which it keeps until its next checkpoint, so every
step is taken once in the result and ``batches`` may be a plain iterator. (The reference replays only the failed step, on the last good
state, and so drops the steps between that state and the failure.)
"""
from __future__ import annotations

import signal
import time
from typing import Any, Callable, Iterator

import torch

from ..checkpoint import CheckpointManager
from ..obs import counters as _obs

__all__ = ["StragglerMonitor", "TrainLoopRunner"]


def _host_copy(tree):
    """A copy of ``tree`` whose tensors live on the host, apart from the
    originals."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(x) for x in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _copy_into(dst, src):
    """``src``'s values written into ``dst``'s tensors in place; returns
    ``dst`` with each non-tensor leaf replaced by ``src``'s."""
    if isinstance(dst, dict):
        return {k: _copy_into(dst[k], src[k]) for k in dst}
    if isinstance(dst, (list, tuple)):
        return type(dst)(_copy_into(d, s) for d, s in zip(dst, src))
    if isinstance(dst, torch.Tensor):
        with torch.no_grad():
            dst.copy_(torch.as_tensor(src))
        return dst
    return src


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
        self._resumed = None             # (step, state) of resume_or

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
        self._resumed = (int(step), restored)
        return restored, int(step)

    def run(self, state, batches: Iterator, num_steps: int,
            start_step: int = 0) -> tuple[Any, list[dict]]:
        self._install_sigterm()
        history: list[dict] = []
        # The last good state: the checkpoint of ``saved_step`` or, when
        # that is None, ``start_copy``; the loop resumes at ``good_step``.
        resumed, self._resumed = self._resumed, None
        if resumed is not None and resumed[1] is state:
            saved_step, start_copy = resumed[0], None
        else:
            saved_step, start_copy = None, _host_copy(state)
        good_step = start_step
        taken: list = []                 # (step, batch) since good_step
        retries = 0
        step = start_step
        it = iter(batches)
        while step < num_steps and not self._preempted:
            if step - good_step < len(taken):
                data_step, batch = taken[step - good_step]
            else:
                data_step, batch = next(it)
                taken.append((data_step, batch))
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
                state = self._rollback(state, saved_step, start_copy)
                step = good_step             # replay what it took since
                history = [h for h in history if h["step"] < step]
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
                saved_step, start_copy = step, None
                good_step, taken = step + 1, []
                retries = 0
            step += 1
        if self._preempted:
            self.log(f"[runner] SIGTERM — checkpointing step {step}")
            self.ckpt.save(step, state)
            _obs.add("resilience.checkpoint.saves")
        return state, history

    def _rollback(self, state, saved_step, start_copy):
        """The state of the last good step, in ``state``'s tensors."""
        if saved_step is None:
            return _copy_into(state, start_copy)
        restored, _ = self.ckpt.restore(state, step=saved_step)
        return _copy_into(state, restored)
