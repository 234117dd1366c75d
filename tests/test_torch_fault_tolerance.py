"""Port parity: ``repro_torch.runtime.fault_tolerance`` on the port's
checkpoint manager, held as ``tests/test_fault_tolerance.py`` holds the
reference's runner:
  * EWMA straggler detection flags slow steps and keeps adapting, with
    the reference's monitor's events on the same step times;
  * a failing ``train_step`` (an exception or a NaN loss) is retried
    boundedly with rollback-and-replay, every retry counted under
    ``resilience.retries{site=train_step}``;
  * SIGTERM preemption triggers one final checkpoint before exit;
  * ``resume_or`` restores the newest checkpoint, numeric leaves as
    tensors on the device asked for.
"""
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.runtime.fault_tolerance import \
    StragglerMonitor as JStragglerMonitor  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.obs import counters as ocnt  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    StragglerMonitor,
    TrainLoopRunner,
)


# ---------------------------------------------------------------------------
# StragglerMonitor
# ---------------------------------------------------------------------------

def test_straggler_ewma_flags_slow_steps():
    mon = StragglerMonitor(threshold=2.0, alpha=0.5)
    assert mon.observe(0, 1.0) is False          # first sample: no baseline
    assert mon.ewma == 1.0
    assert mon.observe(1, 1.1) is False          # within threshold
    assert mon.observe(2, 5.0) is True           # > 2× the EWMA
    assert mon.events[0][0] == 2
    assert mon.events[0][1] == 5.0


def test_straggler_ewma_adapts():
    mon = StragglerMonitor(threshold=2.0, alpha=0.5)
    mon.observe(0, 1.0)
    mon.observe(1, 5.0)                          # straggler, but absorbed
    # EWMA rose to 3.0: the same 5.0 is no longer a straggler.
    assert mon.ewma == pytest.approx(3.0)
    assert mon.observe(2, 5.0) is False
    assert len(mon.events) == 1


def test_straggler_exact_threshold_is_not_flagged():
    mon = StragglerMonitor(threshold=2.0, alpha=0.1)
    mon.observe(0, 1.0)
    assert mon.observe(1, 2.0) is False          # dt == threshold·ewma


# ---------------------------------------------------------------------------
# TrainLoopRunner helpers
# ---------------------------------------------------------------------------

class ReplayBatches:
    """Resumable (step, batch) stream: ``iter()`` replays from the step
    the consumer is about to retry — the runner's rollback contract."""

    def __init__(self, n):
        self.n = n
        self.cursor = 0

    def __iter__(self):
        step = self.cursor
        while step < self.n:
            self.cursor = step
            yield step, {"x": float(step)}
            step += 1


def _runner(tmp_path, train_step, **kw):
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    kw.setdefault("log_fn", lambda *_: None)
    return TrainLoopRunner(train_step, ckpt, **kw)


def test_runner_happy_path_records_history(tmp_path):
    def step_fn(state, batch):
        return state + 1, {"loss": 1.0 / (state + 1)}

    runner = _runner(tmp_path, step_fn, ckpt_every=2)
    state, history = runner.run(0, ReplayBatches(5), 5)
    assert state == 5
    assert [h["step"] for h in history] == [0, 1, 2, 3, 4]
    # periodic checkpoints at steps 2 and 4
    assert runner.ckpt.all_steps() == [2, 4]


def test_runner_bounded_retry_replays_from_last_good(tmp_path):
    fail_at = {3: 2}                 # step 3 fails twice, then succeeds
    seen = []

    def step_fn(state, batch):
        step = int(batch["x"])
        seen.append(step)
        if fail_at.get(step, 0) > 0:
            fail_at[step] -= 1
            raise RuntimeError("transient interconnect blip")
        return state + 1, {"loss": 1.0}

    runner = _runner(tmp_path, step_fn, ckpt_every=2, max_retries=3)
    with ocnt.use_registry() as reg:
        state, history = runner.run(0, ReplayBatches(6), 6)
        assert reg.get("resilience.retries",
                       site="train_step") == 2
    assert state == 6
    assert len(history) == 6
    assert seen.count(3) == 3                    # two failures + success


def test_runner_nan_loss_is_a_step_failure(tmp_path):
    bad = {2: 1}

    def step_fn(state, batch):
        step = int(batch["x"])
        if bad.get(step, 0) > 0:
            bad[step] -= 1
            return state + 1, {"loss": float("nan")}
        return state + 1, {"loss": 0.5}

    runner = _runner(tmp_path, step_fn, max_retries=2)
    with ocnt.use_registry() as reg:
        state, history = runner.run(0, ReplayBatches(4), 4)
        assert reg.get("resilience.retries",
                       site="train_step") == 1
    assert all(np.isfinite(h["loss"]) for h in history)


def test_runner_retry_exhaustion_raises(tmp_path):
    def step_fn(state, batch):
        raise RuntimeError("permanently broken")

    runner = _runner(tmp_path, step_fn, max_retries=2)
    with ocnt.use_registry():
        with pytest.raises(RuntimeError, match="permanently broken"):
            runner.run(0, ReplayBatches(3), 3)


def test_runner_sigterm_takes_final_checkpoint(tmp_path):
    """Preemption mid-run: the handler sets the flag, the loop exits at
    the step boundary, and one final checkpoint lands."""
    def step_fn(state, batch):
        if int(batch["x"]) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return state + 1, {"loss": 1.0}

    prev = signal.getsignal(signal.SIGTERM)
    try:
        runner = _runner(tmp_path, step_fn, ckpt_every=100)
        with ocnt.use_registry() as reg:
            state, history = runner.run(0, ReplayBatches(50), 50)
            assert reg.get("resilience.checkpoint.saves") == 1
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert len(history) == 3                     # steps 0..2 then preempted
    assert runner.ckpt.latest_step() == 3
    restored, step = runner.ckpt.restore(0)
    assert (restored, step) == (3, 3)


def test_runner_resume_or_restores_latest(tmp_path):
    runner = _runner(tmp_path, lambda s, b: (s, {"loss": 1.0}))
    state, start = runner.resume_or(0)
    assert (state, start) == (0, 0)              # fresh directory
    runner.ckpt.save(7, 42)
    state, start = runner.resume_or(0)
    assert (int(np.asarray(state)), start) == (42, 7)
    template = {"w": torch.zeros(3), "tag": np.asarray("run")}
    runner.ckpt.save(9, {"w": torch.arange(3.0), "tag": np.asarray("run")})
    state, start = runner.resume_or(template, device="cpu")
    assert start == 9 and torch.equal(state["w"], torch.arange(3.0))
    assert str(state["tag"]) == "run"


@pytest.mark.parametrize("seed", range(4))
def test_straggler_events_equal_reference(seed):
    times = np.random.default_rng(seed).lognormal(0.0, 0.8, 60)
    mon, jmon = StragglerMonitor(threshold=2.0, alpha=0.2), \
        JStragglerMonitor(threshold=2.0, alpha=0.2)
    flags = [mon.observe(i, float(t)) for i, t in enumerate(times)]
    jflags = [jmon.observe(i, float(t)) for i, t in enumerate(times)]
    assert flags == jflags and mon.events == jmon.events


# ---------------------------------------------------------------------------
# Rollback under a train step that updates its state in place
# ---------------------------------------------------------------------------

def _inplace_step(fail):
    """A step that adds 1 to its state's tensors in place, then raises at
    the steps in ``fail`` (each once): the update has begun when it fails,
    as the port's train step's would."""
    seen = []

    def step_fn(state, batch):
        step = int(batch["x"])
        seen.append((step, float(state["w"][0])))
        state["w"] += 1
        state["n"]["c"] += 1
        if fail.pop(step, False):
            raise RuntimeError("device lost mid-update")
        return state, {"loss": 1.0}
    return step_fn, seen


@pytest.mark.parametrize("fail_at,ckpt_every,want_seen", [
    # before any checkpoint: the starting values, from step 0
    (1, 100, [0, 1, 0, 1, 2, 3, 4, 5, 6, 7]),
    # the newest checkpoint (step 4, after 5 updates), from step 5
    (6, 2, [0, 1, 2, 3, 4, 5, 6, 5, 6, 7]),
])
def test_runner_in_place_step_rolls_back_to_last_good(tmp_path, fail_at,
                                                      ckpt_every,
                                                      want_seen):
    step_fn, seen = _inplace_step({fail_at: True})
    runner = _runner(tmp_path, step_fn, ckpt_every=ckpt_every)
    state = {"w": torch.ones(3), "n": {"c": torch.zeros((), dtype=torch.int32)}}
    w, c = state["w"], state["n"]["c"]
    with ocnt.use_registry() as reg:
        out, history = runner.run(state, ReplayBatches(8), 8)
        assert reg.get("resilience.retries", site="train_step") == 1
    # The loop went back to the step after the last good state and
    # replayed from there; each step saw the values of an unbroken run.
    assert [step for step, _ in seen] == want_seen
    assert all(w0 == step + 1.0 for step, w0 in seen)
    assert [h["step"] for h in history] == list(range(8))
    assert out["w"] is w and out["n"]["c"] is c   # restored in place
    # Every step added one, once: the uninterrupted run's values.
    assert float(out["w"][0]) == 9.0 and int(out["n"]["c"]) == 8


def test_runner_in_place_rollback_replays_a_plain_iterator(tmp_path):
    """The runner keeps the batches it took since the last good state, so
    a generator that cannot restart is enough for a retry."""
    step_fn, seen = _inplace_step({3: True})
    runner = _runner(tmp_path, step_fn, ckpt_every=100)
    gen = ((s, {"x": float(s)}) for s in range(6))
    with ocnt.use_registry():
        out, history = runner.run({"w": torch.ones(1),
                                   "n": {"c": torch.zeros(())}}, gen, 6)
    assert [step for step, _ in seen] == [0, 1, 2, 3, 0, 1, 2, 3, 4, 5]
    assert [h["step"] for h in history] == list(range(6))
    assert float(out["w"][0]) == 7.0


def test_runner_rollback_after_resume_uses_the_restored_checkpoint(
        tmp_path, monkeypatch):
    """A run that ``resume_or`` restored rolls back to that checkpoint
    before its own first save, and takes no host copy of its state."""
    from repro_torch.runtime import fault_tolerance as ft
    step_fn, seen = _inplace_step({5: True})
    runner = _runner(tmp_path, step_fn, ckpt_every=100)
    runner.ckpt.save(3, {"w": torch.full((2,), 5.0),
                         "n": {"c": torch.tensor(4.0)}})
    template = {"w": torch.zeros(2), "n": {"c": torch.zeros(())}}
    state, step = runner.resume_or(template, device="cpu")
    assert step == 3
    monkeypatch.setattr(ft, "_host_copy", lambda tree: pytest.fail(
        "a resumed run copied its state to the host"))
    with ocnt.use_registry():
        out, history = runner.run(state, ((s, {"x": float(s)})
                                          for s in range(4, 8)), 8,
                                  start_step=4)
    assert [step for step, _ in seen] == [4, 5, 4, 5, 6, 7]
    assert all(w0 == step + 1.0 for step, w0 in seen)
    assert [h["step"] for h in history] == [4, 5, 6, 7]
    assert float(out["w"][0]) == 9.0 and float(out["n"]["c"]) == 8.0


def test_runner_nan_after_in_place_update_restores_start(tmp_path):
    bad = {0: True}

    def step_fn(state, batch):
        state["w"].mul_(2)
        nan = bad.pop(int(batch["x"]), False)
        return state, {"loss": float("nan") if nan else 1.0}

    runner = _runner(tmp_path, step_fn, ckpt_every=100)
    with ocnt.use_registry():
        out, history = runner.run({"w": torch.ones(2)}, ReplayBatches(2), 2)
    # Step 0's NaN attempt doubled w; the rollback restored 1, then both
    # steps doubled it again.
    assert torch.equal(out["w"], torch.full((2,), 4.0))
    assert len(history) == 2
