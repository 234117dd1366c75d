"""BENCHMARK.json against the benchmark contract's form, and every file a
cell, configuration or metric names found where the harness looks."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
HERE = ROOT / "cpbench"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
LIMITS = ("mttkrp_rel", "factor_rel", "lam_rel", "pad_nonzero",
          "stream_mismatch")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "cpbench/run.py"]
    assert BENCH["paths"] == ["cpbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # A full check of 24 cells fits the driver's 43200 s.
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.fullmatch(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert _line(entry[key]), key
    if "unit" in entry:
        assert UNIT.fullmatch(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")


def test_names_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", BENCH["end_to_end"],
                         ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source",
                           "workloads"}
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    if metric["name"] == "setup_s":
        assert metric["bound"] == 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metric(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    path = HERE / "metrics" / f"{metric['name']}.py"
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)
    for name in metric.get("workloads", ()):
        assert name in CELLS


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("cpbench/configs/")
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert len(data["shape"]) >= 2 and data["nnz"] <= data["draws"]
    assert config["name"] in {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert files.count(config["file"]) == 1


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4)
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    assert set(traffic) == {"rank", "backend", "blk", "ordering",
                            "gather_dtype"}
    limits = json.loads(
        (HERE / "workloads" / f"{cell['name']}.json").read_text())["limits"]
    assert set(LIMITS) <= set(limits) <= set(LIMITS) | {"fit_gap"}
    assert limits["pad_nonzero"] == 0 and limits["stream_mismatch"] == 0
    reported = [m for m in METRICS
                if "workloads" not in m or cell["name"] in m["workloads"]]
    e2e = {m["name"] for m in reported if m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(m in BENCH["per_layer"] for m in reported)


def test_four_chip_cells_at_most_a_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
