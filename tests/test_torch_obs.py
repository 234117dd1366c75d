"""Port parity: ``repro_torch.obs`` (counter registry, span tracer)
against the reference's ``repro.obs``.

The counter keys and the Chrome-trace schema are shared contracts:
``counter_key`` / ``split_key`` equal the reference's on labelled
samples, a port trace passes both packages' ``validate_chrome_trace``,
and the port's closed namespace holds exactly the reference names this
slice emits. The tracer's own invariants (nesting, counter deltas,
export, the no-op default) are held as ``tests/test_obs.py`` holds the
reference's.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.obs import counters as jcnt  # noqa: E402
from repro.obs import tracer as jtr  # noqa: E402
from repro_torch.obs import counters as ocnt  # noqa: E402
from repro_torch.obs import tracer as otr  # noqa: E402

LABELLED = [
    ("resilience.retries", {"site": "ops.kernel"}),
    ("resilience.degradations", {"from": "pallas_fused_gather",
                                 "to": "pallas_fused_gather_tiled"}),
    ("resilience.injected", {"site": "distributed.remap",
                             "kind": "transient"}),
    ("cpals.phase_s", {"phase": "mttkrp", "mode": 2}),
    ("resilience.solve.guards", {"level": "ridge", "mode": 0}),
    ("cpals.sweeps", None),
    ("resilience.checkpoint.saves", {}),
]


@pytest.mark.parametrize("name, labels", LABELLED)
def test_counter_key_and_split_key_equal_reference(name, labels):
    key = ocnt.counter_key(name, labels)
    assert key == jcnt.counter_key(name, labels)
    assert ocnt.split_key(key) == jcnt.split_key(key)
    base, got = ocnt.split_key(key)
    assert base == name
    assert got == {k: str(v) for k, v in (labels or {}).items()}


def test_namespace_is_the_reference_subset_this_slice_emits():
    # The reference's names less the layers the port lacks, with the one
    # VMEM plan budget translated into the Hopper ladder's two
    # (tests/test_torch_obs_sites.py names each exclusion).
    assert list(ocnt.NAMESPACES) == sorted(set(ocnt.NAMESPACES))
    own = {"planner.smem.plan_bytes", "planner.l2.plan_bytes"}
    assert set(ocnt.NAMESPACES) - own <= set(jcnt.NAMESPACES)
    assert {n for n in ocnt.NAMESPACES
            if n.startswith(("cpals.", "resilience."))} == {
        n for n in jcnt.NAMESPACES
        if n.startswith(("cpals.", "resilience."))} - {
        "resilience.interpret_fallbacks"}


def test_registry_add_get_total_reset_and_rejects_unknown():
    reg = ocnt.CounterRegistry()
    reg.add("resilience.retries", 3, site="a")
    reg.add("resilience.retries", 2, site="b")
    reg.add("cpals.sweeps")
    assert reg.get("resilience.retries", site="a") == 3
    assert reg.total("resilience.") == 5
    assert reg.total("cpals.") == 1
    snap = reg.snapshot()
    assert list(snap) == sorted(snap)
    reg.reset()
    assert len(reg) == 0 and snap["cpals.sweeps"] == 1
    with pytest.raises(ValueError, match="NAMESPACES"):
        reg.add("serve.tokens", 1)   # the LM scaffolding: not ported


def test_use_registry_scopes_and_restores():
    before = ocnt.get_registry()
    with ocnt.use_registry() as reg:
        assert ocnt.get_registry() is reg
        ocnt.add("cpals.sweeps")
        assert reg.get("cpals.sweeps") == 1
    assert ocnt.get_registry() is before


def test_spans_nest_and_record():
    tracer = otr.Tracer()
    with tracer.span("sweep", sweep=0):
        with tracer.span("mode", mode=2):
            with tracer.span("mttkrp"):
                pass
        with tracer.span("mode", mode=3):
            pass
    assert tracer.open_spans == 0
    assert [r.name for r in tracer.records] == ["mttkrp", "mode", "mode",
                                                "sweep"]
    by_sid = {r.sid: r for r in tracer.records}
    for r in tracer.records:
        if r.name == "mode":
            assert by_sid[r.parent].name == "sweep" and r.depth == 1
        if r.name == "mttkrp":
            assert by_sid[r.parent].name == "mode" and r.depth == 2
        assert r.t1 >= r.t0


def test_span_closes_on_exception_and_counter_deltas():
    with ocnt.use_registry():
        tracer = otr.Tracer()
        with pytest.raises(RuntimeError, match="boom"):
            with tracer.span("outer"):
                ocnt.add("cpals.sweeps")
                with tracer.span("inner"):
                    ocnt.add("resilience.retries", 4, site="x")
                    raise RuntimeError("boom")
        inner, outer = tracer.records
        assert inner.counters == {"resilience.retries{site=x}": 4}
        assert outer.counters == {"cpals.sweeps": 1,
                                  "resilience.retries{site=x}": 4}
        assert outer.self_counters == {"cpals.sweeps": 1}


def test_export_with_open_span_raises():
    tracer = otr.Tracer()
    cm = tracer.span("dangling")
    cm.__enter__()
    with pytest.raises(RuntimeError, match="open span"):
        tracer.chrome_trace()
    with pytest.raises(RuntimeError, match="open span"):
        tracer.reset()
    cm.__exit__(None, None, None)
    tracer.chrome_trace()
    with pytest.raises(RuntimeError, match="no open span"):
        tracer._exit()


def test_chrome_trace_round_trip_validates_in_both_packages(tmp_path):
    tracer = otr.Tracer()
    with tracer.span("sweep", sweep=0):
        with tracer.span("mode", mode=1):
            pass
    path = tracer.write_chrome_trace(str(tmp_path / "t.json"),
                                     meta={"k": "v"})
    again = tracer.write_chrome_trace(str(tmp_path / "t.json"))
    assert again != path and again.endswith("t-2.json")   # no clobbering
    with open(path) as f:
        trace = json.load(f)
    for validate in (otr.validate_chrome_trace, jtr.validate_chrome_trace):
        assert validate(trace, expect_names=["sweep", "mode"]) == []
    assert trace["otherData"]["k"] == "v"
    ev = {e["name"]: e for e in trace["traceEvents"]}
    assert ev["mode"]["args"]["mode"] == 1
    assert ev["mode"]["ts"] >= ev["sweep"]["ts"]


def test_validator_rejects_bad_traces():
    assert otr.validate_chrome_trace([]) != []
    assert otr.validate_chrome_trace({"traceEvents": [{}]}) != []
    overlap = {"traceEvents": [
        dict(name="a", cat="c", ph="X", ts=0.0, dur=10.0, pid=1, tid=0,
             args={}),
        dict(name="b", cat="c", ph="X", ts=5.0, dur=10.0, pid=1, tid=0,
             args={}),
    ]}
    assert any("overlaps" in e for e in otr.validate_chrome_trace(overlap))
    assert any("sweep" in e for e in otr.validate_chrome_trace(
        {"traceEvents": []}, expect_names=["sweep"]))


@pytest.mark.parametrize("name", ["a;b", "x{y}", "tab\there", "", 7])
def test_sanitize_span_name_equal_reference(name):
    assert otr.sanitize_span_name(name) == jtr.sanitize_span_name(name)


def test_null_tracer_is_inert_and_use_tracer_scopes():
    assert otr.get_tracer() is otr.NULL
    with ocnt.use_registry() as reg:
        with otr.NULL.span("sweep", sweep=0):
            with otr.NULL.span("mode"):
                pass
        assert otr.NULL.records == () and len(reg) == 0
    with otr.use_tracer() as tracer:
        assert otr.get_tracer() is tracer and tracer.enabled
    assert otr.get_tracer() is otr.NULL
    otr.set_tracer(None)
    assert otr.get_tracer() is otr.NULL


@pytest.mark.parametrize("seed", range(8))
def test_span_nesting_under_random_interleavings(seed):
    """Seeded push/pop programs keep the forest consistent (parents,
    depths, containment) and export a valid Chrome trace."""
    program = np.random.default_rng(seed).integers(0, 4, 40)
    tracer = otr.Tracer(attach_counters=False)
    stack = []
    for op in program:
        if op == 0 and len(stack) < 6:
            cm = tracer.span(f"s{len(tracer.records)}_{len(stack)}")
            cm.__enter__()
            stack.append(cm)
        elif stack:
            stack.pop().__exit__(None, None, None)
    while stack:
        stack.pop().__exit__(None, None, None)
    by_sid = {r.sid: r for r in tracer.records}
    for r in tracer.records:
        if r.parent != -1:
            p = by_sid[r.parent]
            assert r.depth == p.depth + 1
            assert p.t0 <= r.t0 and r.t1 <= p.t1
    assert otr.validate_chrome_trace(tracer.chrome_trace()) == []
    assert jtr.validate_chrome_trace(tracer.chrome_trace()) == []
