"""The harness on the card at a small size: the port's CUDA kernels come
out correct, and the traced window's reduction finds device time in both
wrapped layers. Skips without a card."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "cpbench"))

import check  # noqa: E402
import run  # noqa: E402

LIMITS = {"mttkrp_rel": 1e-4, "factor_rel": 1e-4, "lam_rel": 1e-4,
          "pad_nonzero": 0, "stream_mismatch": 0}


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


@pytest.mark.gpu
@pytest.mark.parametrize("blk", [None, 64])
def test_small_run_on_the_card(cuda, blk):
    cell = {"name": "tiny", "chips": 1,
            "config": json.loads(
                (ROOT / "cpbench/tests/data/tiny.json").read_text()),
            "traffic": {"rank": 16, "backend": "auto", "blk": blk,
                        "ordering": "none", "gather_dtype": "float32"},
            "limits": LIMITS}
    record, nums = run.drive(cell, 2**31 + 3, 0.5, True, cuda)
    ok, checks = check.judge(nums, LIMITS)
    assert ok, checks
    tr = record["trace"]
    assert tr["sweeps"] == len(record["sweep_s"])
    assert tr["layer_device_s"]["mttkrp"] > 0
    assert tr["layer_device_s"]["remap"] > 0
    assert 0 < tr["busy_s"] <= tr["window_s"]
