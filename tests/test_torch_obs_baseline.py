"""Port parity: the counted baseline gate (``repro_torch.obs.baseline``)
and the ``python -m repro_torch.obs`` CLI.

* ``collect(device="cpu")`` equals the committed port baseline
  (``bench_torch/obs/BASELINE_counters.json``) key for key; the same
  file is what ``chip_smoke.py`` holds a collection on the card to.
* The pieces of the pinned workload, with the out-of-core step at the
  reference's geometry, equal the reference's committed
  ``experiments/obs/BASELINE_counters.json`` (read, never written) on
  ``oocore.*``, ``reorder.*``, ``remap.*`` and ``cpals.sweeps``. The keys
  that differ by design are listed in :data:`BY_DESIGN`, with the reason.
* ``diff`` and ``run_gate`` catch a perturbed baseline, and the CLI
  round-trips, as ``tests/test_obs.py`` holds the reference's.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.obs import baseline as jbaseline  # noqa: E402
from repro_torch.obs import __main__ as obs_main  # noqa: E402
from repro_torch.obs import baseline as obaseline  # noqa: E402
from repro_torch.obs import counters as ocnt  # noqa: E402
from repro_torch.obs import tracer as otr  # noqa: E402
from repro_torch.oocore.executor import mttkrp_out_of_core  # noqa: E402

JAX_GEOMETRY = dict(frow_tile=128, rank_slab=128, rank_multiple=128)
# Counted names whose value is the reference's, at its geometry.
EQUAL_PREFIXES = ("oocore.chunks", "oocore.dma.", "oocore.mode_steps",
                  "reorder.", "remap.", "cpals.sweeps")
# Counted names that differ by design, and why.
BY_DESIGN = {
    "dispatch.backend": "counted per call (4 workers x 4 modes x 2 sweeps "
                        "= 32), the reference's per jit trace (4)",
    "planner.plans": "per call, as dispatch.backend",
    "planner.vmem.plan_bytes": "the reference's one VMEM budget",
    "planner.smem.plan_bytes": "the Hopper ladder's shared-memory budget",
    "planner.l2.plan_bytes": "the Hopper ladder's L2 budget",
    "resilience.site_calls": "fault sites fire per call, the reference's "
                             "ops.kernel / execution.resolve / "
                             "distributed.remap per jit trace",
}


@pytest.fixture(scope="module")
def cpu_baseline():
    return obaseline.collect(device="cpu")


def test_collect_on_cpu_equals_committed_port_baseline(cpu_baseline):
    committed = obaseline.load_baseline()
    assert obaseline.diff(cpu_baseline, committed) == []
    assert cpu_baseline["meta"]["workload"] == jbaseline.WORKLOAD
    assert committed["meta"]["device"] == "cpu"


def _reference_geometry_counters(cpu_baseline):
    """The workload's counted keys with the out-of-core step run at the
    reference's geometry (the CP-ALS part is geometry-free)."""
    args, kw = obaseline.oocore_case("cpu")
    with ocnt.use_registry() as reg:
        for ordering in obaseline.WORKLOAD["oocore"]["orderings"]:
            mttkrp_out_of_core(*args, ordering=ordering, **JAX_GEOMETRY,
                               **kw)
    oo = {k: int(v) for k, v in reg.snapshot().items()
          if obaseline._is_counted(k)}
    rest = {k: v for k, v in cpu_baseline["counters"].items()
            if not k.startswith(("oocore.", "reorder.",
                                 "resilience.site_calls{site=oocore.",
                                 "resilience.site_calls{site=execution."))}
    return {**rest, **oo}


def test_pieces_at_reference_geometry_equal_reference_baseline(
        cpu_baseline):
    ref = jbaseline.load_baseline()["counters"]
    ours = _reference_geometry_counters(cpu_baseline)
    pick = lambda c: {k: v for k, v in c.items()  # noqa: E731
                      if k.startswith(EQUAL_PREFIXES)}
    assert pick(ours) == pick(ref)
    assert pick(ref), "the reference baseline lost its counted keys"
    # Every other key, in either package, is a documented difference.
    other = {ocnt.split_key(k)[0] for k in set(ours) | set(ref)
             if not k.startswith(EQUAL_PREFIXES)}
    assert other == set(BY_DESIGN)


def test_by_design_counts_are_the_per_call_multiples(cpu_baseline):
    c = cpu_baseline["counters"]
    ref = jbaseline.load_baseline()["counters"]
    w = obaseline.WORKLOAD
    calls = w["num_workers"] * 4 * w["iters"]      # workers x modes x sweeps
    key = "dispatch.backend{backend=pallas_fused_gather,source=static}"
    assert ref[key] == 4 and c[key] == calls
    assert c["planner.plans"] == calls
    assert c["resilience.site_calls{site=ops.kernel}"] == calls
    assert c["resilience.site_calls{site=distributed.remap}"] \
        == 4 * w["iters"]
    # every kernel-wrapper call: B1 per mode step + B6 per chunk
    assert c["resilience.site_calls{site=execution.resolve}"] \
        == calls + c["oocore.chunks"]
    assert c["resilience.site_calls{site=oocore.chunk}"] \
        == ref["resilience.site_calls{site=oocore.chunk}"] \
        == c["oocore.chunks"]


def test_counted_filter_excludes_timed():
    assert obaseline._is_counted("oocore.dma.scheduled_bytes")
    assert obaseline._is_counted(
        "dispatch.backend{backend=pallas_fused_gather,source=static}")
    assert obaseline._is_counted("planner.l2.plan_bytes{backend=pallas}")
    assert not obaseline._is_counted("oocore.mode_step_s{backend=x}")
    assert not obaseline._is_counted("ops.step_s{backend=auto}")
    assert not obaseline._is_counted("ops.step.model_bytes{backend=auto}")
    assert not obaseline._is_counted("cpals.phase_s{mode=0,phase=solve}")


def test_baseline_artifact_is_committed_and_sane():
    base = obaseline.load_baseline()
    assert base["meta"]["schema"] == 1
    counters = base["counters"]
    for key, v in counters.items():
        assert obaseline._is_counted(key), f"timed key {key}"
        assert isinstance(v, int) and v >= 0
    names = {ocnt.split_key(k)[0] for k in counters}
    for want in ("cpals.sweeps", "dispatch.backend", "planner.plans",
                 "planner.smem.plan_bytes", "planner.l2.plan_bytes",
                 "oocore.dma.scheduled_bytes", "remap.a2a.bytes",
                 "reorder.perms", "resilience.site_calls"):
        assert want in names, f"baseline missing {want}"


def test_collect_trace_has_the_phase_and_oocore_spans(cpu_baseline):
    tracer = otr.Tracer()
    again = obaseline.collect(tracer=tracer, device="cpu")
    assert again["counters"] == cpu_baseline["counters"]
    names = {r.name for r in tracer.records}
    assert {"sweep", "mode", "mttkrp", "solve", "remap", "oocore.mode_step",
            "oocore.chunk", "oocore.baseline"} <= names


def test_baseline_diff_catches_perturbations():
    base = {"counters": {
        "dispatch.backend{backend=pallas_fused_gather,source=static}": 32,
        "oocore.dma.scheduled_bytes": 9166848,
    }}
    assert obaseline.diff(base, base) == []
    cur = json.loads(json.dumps(base))
    cur["counters"]["oocore.dma.scheduled_bytes"] += 1
    msgs = obaseline.diff(cur, base)
    assert len(msgs) == 1 and "oocore.dma.scheduled_bytes" in msgs[0]
    cur2 = {"counters": {
        "dispatch.backend{backend=pallas_fused_gather_stream,"
        "source=static}": 32,
        "oocore.dma.scheduled_bytes": 9166848,
    }}
    msgs2 = obaseline.diff(cur2, base)
    assert any(m.startswith("missing:") for m in msgs2)
    assert any(m.startswith("new:") for m in msgs2)


def test_run_gate_reports_failure_on_perturbed_baseline(tmp_path,
                                                        monkeypatch):
    current = {"meta": {"schema": 1},
               "counters": {"planner.plans": 32, "oocore.chunks": 36}}
    monkeypatch.setattr(obaseline, "collect",
                        lambda tracer=None, device=None: current)
    path = str(tmp_path / "BASELINE_counters.json")
    status, msgs = obaseline.run_gate(path=path, device="cpu")
    assert status == 1 and any("no baseline" in m for m in msgs)
    status, msgs = obaseline.run_gate(path=path, update=True, device="cpu")
    assert status == 0
    status, msgs = obaseline.run_gate(path=path, device="cpu")
    assert status == 0
    perturbed = {"meta": {"schema": 1},
                 "counters": {"planner.plans": 33, "oocore.chunks": 36}}
    monkeypatch.setattr(obaseline, "collect",
                        lambda tracer=None, device=None: perturbed)
    status, msgs = obaseline.run_gate(path=path, device="cpu")
    assert status == 1
    assert any("planner.plans" in m for m in msgs)


def test_run_gate_on_cpu_against_a_perturbed_copy(tmp_path, cpu_baseline):
    base = json.loads(json.dumps(obaseline.load_baseline()))
    base["counters"]["oocore.chunks"] += 1
    path = str(tmp_path / "perturbed.json")
    obaseline.write_baseline(base, path)
    status, msgs = obaseline.run_gate(path=path, device="cpu")
    assert status == 1
    assert any("changed: oocore.chunks" in m for m in msgs)


# ---------------------------------------------------------------------------
# `python -m repro_torch.obs` CLI paths (report | export | validate |
# baseline)
# ---------------------------------------------------------------------------

def _cli_collect(tracer=None, device=None):
    """Tiny stand-in for the instrumented workload: real spans, fixed
    counters."""
    tracer = tracer if tracer is not None else otr.Tracer()
    with tracer.span("sweep", sweep=0):
        with tracer.span("mode", mode=0):
            with tracer.span("mttkrp"):
                pass
    return {"counters": {"planner.plans": 32, "oocore.chunks": 36}}


def test_cli_report_prints_tree_and_counters(monkeypatch, capsys):
    monkeypatch.setattr(obaseline, "collect", _cli_collect)
    assert obs_main.main(["report", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for needle in ("sweep", "mode", "mttkrp", "counters:",
                   "planner.plans = 32", "oocore.chunks = 36"):
        assert needle in out, needle


def test_cli_export_then_validate_round_trip(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(obaseline, "collect", _cli_collect)
    out_path = str(tmp_path / "trace.json")
    assert obs_main.main(["export", "--out", out_path, "--device",
                          "cpu"]) == 0
    wrote = capsys.readouterr().out
    assert "wrote" in wrote and "3 spans" in wrote
    written = wrote.split()[1].rstrip(":")
    assert obs_main.main(
        ["validate", written, "--expect", "sweep,mode,mttkrp"]) == 0
    assert "trace valid" in capsys.readouterr().out


def test_cli_export_real_run_validates_with_the_seven_spans(tmp_path,
                                                            capsys):
    out_path = str(tmp_path / "trace.json")
    assert obs_main.main(["export", "--out", out_path, "--device",
                          "cpu"]) == 0
    written = capsys.readouterr().out.split()[1].rstrip(":")
    assert obs_main.main(
        ["validate", written, "--expect",
         "sweep,mode,mttkrp,solve,remap,oocore.mode_step,oocore.chunk"]) == 0
    trace = json.load(open(written))
    assert trace["otherData"]["exporter"] == "repro_torch.obs"


def test_cli_validate_rejects_corrupt_and_missing_names(tmp_path,
                                                        monkeypatch,
                                                        capsys):
    monkeypatch.setattr(obaseline, "collect", _cli_collect)
    out_path = str(tmp_path / "trace.json")
    assert obs_main.main(["export", "--out", out_path, "--device",
                          "cpu"]) == 0
    written = capsys.readouterr().out.split()[1].rstrip(":")
    assert obs_main.main(
        ["validate", written, "--expect", "oocore.mode_step"]) == 1
    assert "FAIL" in capsys.readouterr().out
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "X"}]}))
    assert obs_main.main(["validate", str(bad)]) == 1


def test_cli_baseline_update_check_perturb(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(obaseline, "collect", _cli_collect)
    path = str(tmp_path / "BASELINE_counters.json")
    assert obs_main.main(["baseline", "--update-baseline", "--path", path,
                          "--device", "cpu"]) == 0
    assert os.path.exists(path)
    assert obs_main.main(["baseline", "--path", path, "--device",
                          "cpu"]) == 0
    perturbed = {"counters": {"planner.plans": 33, "oocore.chunks": 36}}
    monkeypatch.setattr(obaseline, "collect",
                        lambda tracer=None, device=None: perturbed)
    assert obs_main.main(["baseline", "--path", path, "--device",
                          "cpu"]) == 1
    assert "planner.plans" in capsys.readouterr().out


def test_cli_default_device_is_cuda(monkeypatch):
    # No --device: the entry point asks for CUDA, and says so on a host
    # without it instead of running on the CPU.
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default would run there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        obs_main.main(["baseline", "--path", os.devnull])
