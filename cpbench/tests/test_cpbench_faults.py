"""A whole run of the harness on the CPU at a small size, past its look
for a card: sound, it comes out correct; with the timed path broken
underneath, or with the control (the reference in TF32) in the program's
place, it does not."""
from __future__ import annotations

import json
import sys
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "cpbench"))
sys.path.insert(0, str(ROOT / "src"))

import check  # noqa: E402
import control  # noqa: E402
import run  # noqa: E402
from repro_torch.core import cpals, distributed as dist  # noqa: E402

SEED = 2**31 + 21
# Limits for this size, between the sound run's readings (factor_rel
# ~1e-5) and the control's (~1e-3).
LIMITS = {"mttkrp_rel": 1e-4, "factor_rel": 1e-4, "lam_rel": 1e-4,
          "pad_nonzero": 0, "stream_mismatch": 0}


def _cell(**traffic):
    return {"name": "tiny", "chips": 1,
            "config": json.loads(
                (ROOT / "cpbench/tests/data/tiny.json").read_text()),
            "traffic": dict({"rank": 16, "backend": "auto", "blk": None,
                             "ordering": "none", "gather_dtype": "float32"},
                            **traffic),
            "limits": LIMITS}


def _judge():
    # seconds=0: the window holds one sweep, the third of the run.
    record, nums = run.drive(_cell(), SEED, 0.0, False, "cpu")
    assert len(record["sweep_s"]) == 1
    return check.judge(nums, LIMITS)


def test_sound_run_is_correct():
    ok, checks = _judge()
    assert ok, checks


def test_record_holds_the_windows_counters():
    # The port's counters emitted in the window (one sweep here), for a
    # metric reader to take per sweep.
    record, _ = run.drive(_cell(), SEED, 0.0, False, "cpu")
    rungs = sum(v for k, v in record["counters"].items()
                if k.startswith("dispatch.backend{"))
    assert rungs == 3 * len(record["sweep_s"])   # one a mode a sweep
    assert set(record["setup_parts"]) == {"start_s", "tensor_s", "flycoo_s",
                                          "runtime_s", "state_s",
                                          "warmup_s"}


@pytest.mark.parametrize("loaded", ["jax", "jaxlib", "flax", "repro"])
def test_no_result_once_a_metric_reader_loads_jax(monkeypatch, loaded):
    # The look at ``sys.modules`` comes after every metric is read, so a
    # reader that loads JAX or the JAX package leaves no result.
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = dict(_cell(), name=bench["workloads"][0]["name"])
    record, nums = run.drive(cell, SEED, 0.0, False, "cpu")
    assert run.result(bench, cell, record, nums, False, {}) is not None

    def reader(name, rec):
        monkeypatch.setitem(sys.modules, loaded, types.ModuleType(loaded))
        return 1.0
    monkeypatch.setattr(run, "read_metric", reader)
    assert run.result(bench, cell, record, nums, False, {}) is None


def _state_unchanged(real):
    def sweep(stream, factors, *a, **kw):
        return real(stream, factors, *a, **kw)._replace(factors=list(factors))
    return sweep


def _half_batch(real):
    def local_mttkrp(idx, val, mask, *a, **kw):
        live = int(mask.sum())
        keep = torch.arange(mask.shape[1]) < live // 2
        return real(idx, torch.where(keep, 2.0 * val, 0.0), mask & keep,
                    *a, **kw)
    return local_mttkrp


def _no_exchange(real):
    def device_remap(idx, val, mask, *a, **kw):
        return idx, val, mask, torch.zeros(idx.shape[0], dtype=torch.int64)
    return device_remap


def _answer_altered(real):
    def local_mttkrp(*a, **kw):
        out = real(*a, **kw).clone()
        out[0, 3, 5] += 1e-3 * float(out.abs().max())
        return out
    return local_mttkrp


@pytest.mark.parametrize("module, name, fault", [
    (cpals, "als_sweep", _state_unchanged),
    (dist, "local_mttkrp", _half_batch),
    (dist, "device_remap", _no_exchange),
    (dist, "local_mttkrp", _answer_altered),
], ids=["state_unchanged", "half_batch", "exchange_left_out",
        "answer_altered"])
def test_fault_makes_the_run_incorrect(monkeypatch, module, name, fault):
    monkeypatch.setattr(module, name, fault(getattr(module, name)))
    ok, checks = _judge()
    assert not ok, checks


def test_control_in_the_programs_place_is_incorrect(monkeypatch):
    monkeypatch.setattr(cpals, "als_sweep", control.tf32_sweep)
    ok, checks = _judge()
    assert not ok, checks
    assert checks["stream_mismatch"]["value"] == 0
    assert checks["factor_rel"]["value"] > 3 * LIMITS["factor_rel"]
