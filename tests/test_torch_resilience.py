"""Port parity: ``repro_torch.resilience`` (fault sites, degradation
policy) and the stepped CP-ALS driver against the reference.

* the closed registries equal the reference's (``SITES``,
  ``DEGRADATION_LADDER``, ``next_rung``), and ``seeded_schedule`` gives
  the same schedule for seeds 0..20;
* injector and policy semantics as ``tests/test_resilience.py`` holds the
  reference's, except that a resource fault steps down at once (the port
  has no interpreter to flip to);
* the stepped ``cp_als_distributed`` at D=1 and D=4 (``LocalWorkers``)
  against the reference's stepped driver (D=4 on its forced 4-device CPU
  mesh, in a subprocess): fits within 1e-5, factors within 1e-4, on the
  well-conditioned inputs of ``tests/test_torch_distributed.py``;
* at D=1 a fault schedule inside sweep 0 leaves the port's
  ``resilience.*`` counters (``site_calls`` aside: the port's sites fire
  per call, the reference's per trace) equal to the reference's, key
  for key;
* the chaos smoke ``python -m repro_torch.resilience --device cpu``.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import resilience as jres  # noqa: E402
from repro.core import cpals as jcpals  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.core import flycoo as jfly  # noqa: E402
from repro.core import tensors as jten  # noqa: E402
from repro.obs import counters as jcnt  # noqa: E402
from repro.obs import tracer as jtr  # noqa: E402
from repro_torch import resilience as tres  # noqa: E402
from repro_torch.core import cpals as tcpals  # noqa: E402
from repro_torch.core import flycoo as tfly  # noqa: E402
from repro_torch.core import tensors as ttens  # noqa: E402
from repro_torch.core.workers import LocalWorkers  # noqa: E402
from repro_torch.kernels.mttkrp import ops as tops  # noqa: E402
from repro_torch.obs import counters as tcnt  # noqa: E402
from repro_torch.obs import tracer as ttr  # noqa: E402
from repro_torch.oocore import planner as tplanner  # noqa: E402
from repro_torch.resilience import (  # noqa: E402
    CorruptionFault,
    FaultInjector,
    FaultSpec,
    ResilienceExhausted,
    ResourceFault,
    RetryPolicy,
    TransientFault,
    fault_site,
    inject,
)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANK, SWEEPS = 8, 3
FIT_TOL = 1e-5
FAC_TOL = dict(rtol=1e-4, atol=1e-5)
# The well-conditioned cases of tests/test_torch_distributed.py.
CASES = {
    "m4": (dict(shape=(9, 8, 7, 6), nnz=400, seed=2),
           dict(m_bounds=(2, 8), g_bounds=(8, 64), cache_bytes=1 << 20)),
    "u3": (dict(shape=(30, 20, 10), nnz=500, seed=3),
           dict(m_bounds=(2, 8), g_bounds=(8, 64), cache_bytes=1 << 20)),
}
SCHEDULE = [("ops.kernel", 1, "transient"), ("ops.kernel", 2, "resource"),
            ("distributed.remap", 0, "transient")]


# ---------------------------------------------------------------------------
# Registries and schedules: equal to the reference's
# ---------------------------------------------------------------------------

def test_sites_ladder_and_next_rung_equal_reference():
    assert tres.SITES == jres.SITES
    assert tres.DEGRADATION_LADDER == jres.DEGRADATION_LADDER
    assert tres.DEGRADATION_LADDER == tplanner.LADDER + ("ref",)
    for rung in tres.DEGRADATION_LADDER:
        assert rung in tops.BACKENDS, rung
    for b in tres.DEGRADATION_LADDER + ("auto", "pallas_fused_bf16",
                                        "segsum", "nope"):
        assert tres.next_rung(b) == jres.next_rung(b), b


@pytest.mark.parametrize("seed", range(21))
def test_seeded_schedule_equals_reference(seed):
    for per_site, horizon in ((1, 3), (2, 5), (3, 3)):
        got = tres.seeded_schedule(seed, per_site=per_site, horizon=horizon)
        want = jres.seeded_schedule(seed, per_site=per_site, horizon=horizon)
        assert [(s.site, s.index, s.kind) for s in got] == \
            [(s.site, s.index, s.kind) for s in want]


@pytest.mark.parametrize("bad", [
    dict(site="nope.site", index=0, kind="transient"),
    dict(site="ops.kernel", index=0, kind="nope"),
    dict(site="ops.kernel", index=-1, kind="transient"),
])
def test_fault_spec_validation(bad):
    with pytest.raises(ValueError):
        FaultSpec(**bad)
    with pytest.raises(ValueError, match="unknown fault site"):
        fault_site("not.a.site")


# ---------------------------------------------------------------------------
# Injector mechanics (tests/test_resilience.py:112-160)
# ---------------------------------------------------------------------------

def test_injector_fires_on_index_match():
    with tcnt.use_registry() as reg:
        with inject([FaultSpec("ops.kernel", 1, "transient")]) as inj:
            fault_site("ops.kernel")
            with pytest.raises(TransientFault):
                fault_site("ops.kernel")
            fault_site("ops.kernel")
            assert inj.calls["ops.kernel"] == 3
            assert [s.index for s in inj.injected] == [1]
            assert inj.pending() == ()
        assert reg.get("resilience.injected",
                       site="ops.kernel", kind="transient") == 1
        assert reg.get("resilience.site_calls", site="ops.kernel") == 3


def test_injector_pending_conflicts_nesting_and_noop():
    with inject([FaultSpec("oocore.chunk", 4, "transient")]) as inj:
        fault_site("oocore.chunk")
    assert inj.pending() == (FaultSpec("oocore.chunk", 4, "transient"),)
    with pytest.raises(ValueError, match="conflicting"):
        FaultInjector((FaultSpec("ops.kernel", 0, "transient"),
                       FaultSpec("ops.kernel", 0, "resource")))
    from repro_torch.resilience.faults import active_injector
    with inject([]) as outer:
        with inject([]) as inner:
            assert active_injector() is inner
        assert active_injector() is outer
    assert active_injector() is None
    with tcnt.use_registry() as reg:
        fault_site("execution.resolve")
        assert reg.get("resilience.site_calls",
                       site="execution.resolve") == 1
        assert reg.total("resilience.injected") == 0


# ---------------------------------------------------------------------------
# Retry policy
# ---------------------------------------------------------------------------

def test_run_retries_transient_counts_and_exhausts():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise TransientFault("oocore.chunk", calls["n"] - 1)
        return "ok"

    with tcnt.use_registry() as reg:
        assert RetryPolicy(max_retries=3).run("oocore.chunk", flaky) == "ok"
        assert reg.get("resilience.retries", site="oocore.chunk") == 2

    def always():
        raise TransientFault("oocore.chunk", 0)

    def res():
        raise ResourceFault("oocore.chunk", 0)

    with tcnt.use_registry():
        with pytest.raises(ResilienceExhausted):
            RetryPolicy(max_retries=2).run("oocore.chunk", always)
        with pytest.raises(ResourceFault):
            RetryPolicy().run("oocore.chunk", res)


def test_backoff_is_exponential():
    slept = []
    pol = RetryPolicy(max_retries=3, backoff_base_s=0.5, backoff_factor=2.0,
                      sleep=slept.append)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 3:
            raise TransientFault("oocore.chunk", 0)
        return 1

    with tcnt.use_registry():
        pol.run("oocore.chunk", flaky)
    assert slept == [0.5, 1.0, 2.0]


def _scripted(script):
    """A fake ``call(backend)``: pops the next scripted action."""
    log = []

    def call(backend):
        log.append(backend)
        action = script.pop(0) if script else "ok"
        if action == "ok":
            return ("done", backend)
        raise action

    return call, log


def test_dispatch_transient_retries_same_rung():
    call, log = _scripted([TransientFault("ops.kernel", 0), "ok"])
    with tcnt.use_registry() as reg:
        assert RetryPolicy().dispatch(call, "pallas_fused") == \
            ("done", "pallas_fused")
    assert log == ["pallas_fused"] * 2
    assert reg.get("resilience.retries", site="ops.kernel") == 1


def test_dispatch_resource_steps_down_with_no_flip():
    call, log = _scripted([ResourceFault("ops.kernel", 0), "ok"])
    with tcnt.use_registry() as reg:
        out = RetryPolicy().dispatch(call, "pallas_fused_gather")
    assert out == ("done", "pallas_fused_gather_tiled")
    assert log == ["pallas_fused_gather", "pallas_fused_gather_tiled"]
    assert reg.snapshot() == {
        "resilience.degradations{from=pallas_fused_gather,"
        "to=pallas_fused_gather_tiled}": 1}
    # The reference steps down the same way once it interprets (always,
    # on a CPU host).
    jlog = []

    def jcall(b, interpret):
        jlog.append(b)
        if len(jlog) == 1:
            raise jres.ResourceFault("ops.kernel", 0)
        return ("done", b)

    with jcnt.use_registry() as jreg:
        jres.RetryPolicy().dispatch(jcall, "pallas_fused_gather", True)
    assert jlog == log and jreg.snapshot() == reg.snapshot()


def test_dispatch_corruption_propagates_and_floor_exhausts():
    call, log = _scripted([CorruptionFault("ops.kernel", 0)])
    with tcnt.use_registry() as reg:
        with pytest.raises(CorruptionFault):
            RetryPolicy().dispatch(call, "pallas_fused")
    assert len(log) == 1 and len(reg) == 0
    call, log = _scripted([ResourceFault("ops.kernel", i) for i in range(20)])
    with tcnt.use_registry() as reg:
        with pytest.raises(ResilienceExhausted):
            RetryPolicy().dispatch(call, "pallas")
    assert log == ["pallas", "ref"]
    assert reg.get("resilience.degradations",
                   **{"from": "pallas", "to": "ref"}) == 1
    call, log = _scripted([TransientFault("ops.kernel", i) for i in range(9)])
    with tcnt.use_registry():
        with pytest.raises(ResilienceExhausted):
            RetryPolicy(max_retries=2).dispatch(call, "pallas")
    assert log == ["pallas"] * 3


def test_use_policy_scoping():
    from repro_torch.resilience import get_policy, use_policy
    assert get_policy() is None
    with use_policy() as pol:
        assert get_policy() is pol
        custom = RetryPolicy(max_retries=1)
        with use_policy(custom):
            assert get_policy() is custom
        assert get_policy() is pol
    assert get_policy() is None


def test_real_errors_are_not_caught():
    """Only the typed injected faults are handled: any other error of a
    mode step propagates from the first rung, uncounted."""
    call, log = _scripted([RuntimeError("CUDA error: out of memory")])
    with tcnt.use_registry() as reg:
        with pytest.raises(RuntimeError, match="out of memory"):
            RetryPolicy().dispatch(call, "pallas_fused_gather")
    assert log == ["pallas_fused_gather"] and len(reg) == 0


# ---------------------------------------------------------------------------
# The fault sites in the port's modules
# ---------------------------------------------------------------------------

def _ft(name, D):
    tkw, fkw = CASES[name]
    return tfly.build_flycoo(ttens.random_sparse_tensor(**tkw), D, **fkw)


def _ft_ref(name, D):
    tkw, fkw = CASES[name]
    return jfly.build_flycoo(jten.random_sparse_tensor(**tkw), D, **fkw)


def test_site_calls_per_call_at_d4():
    """Sites fire per call: per worker and mode for ``ops.kernel`` and
    ``execution.resolve`` (one kernel wrapper per mode step), per mode for
    the remap, in every sweep."""
    ft = _ft("u3", 4)
    with tcnt.use_registry() as reg:
        tcpals.cp_als_distributed(ft, RANK, workers=LocalWorkers(4, "cpu"),
                                  iters=2, tol=0.0,
                                  backend="pallas_fused_gather",
                                  resilience=RetryPolicy())
    calls = {k: v for k, v in reg.snapshot().items()
             if k.startswith("resilience.site_calls")}
    assert calls == {
        "resilience.site_calls{site=distributed.remap}": 2 * 3,
        "resilience.site_calls{site=execution.resolve}": 2 * 3 * 4,
        "resilience.site_calls{site=ops.kernel}": 2 * 3 * 4}


def test_ref_rung_runs_no_kernel_wrapper():
    """``ref`` (the ladder's floor) runs the plain ``index_add_`` and
    reaches no kernel wrapper's route decision."""
    ft = _ft("u3", 1)
    with tcnt.use_registry() as reg:
        tcpals.cp_als_distributed(ft, RANK, device="cpu", iters=1,
                                  backend="ref", resilience=RetryPolicy())
    assert reg.get("resilience.site_calls", site="execution.resolve") == 0
    assert reg.get("resilience.site_calls", site="ops.kernel") == 3


def test_counter_snapshot_equals_reference_at_d1():
    """D=1, B1, 2 sweeps, the schedule inside sweep 0: the port's
    ``resilience.*`` counters equal the reference's key for key."""
    def strip(snap):
        return {k: v for k, v in snap.items()
                if k.startswith("resilience.") and "site_calls" not in k}

    ft, fj = _ft("u3", 1), _ft_ref("u3", 1)
    with tcnt.use_registry() as reg, inject(SCHEDULE) as inj:
        port = tcpals.cp_als_distributed(
            ft, RANK, device="cpu", iters=2, tol=0.0,
            backend="pallas_fused_gather", resilience=RetryPolicy())
    assert inj.pending() == ()
    mesh = Mesh(np.array(jax.devices()[:1]), (jdist.AXIS,))
    jax.clear_caches()   # fresh traces: the reference's sites fire again
    with jcnt.use_registry() as jreg, jres.inject(SCHEDULE) as jinj:
        ref = jcpals.cp_als_distributed(
            fj, RANK, mesh, iters=2, tol=0.0, backend="pallas_fused_gather",
            resilience=jres.RetryPolicy())
    assert jinj.pending() == ()
    assert strip(reg.snapshot()) == strip(jreg.snapshot())
    assert strip(reg.snapshot()) == {
        "resilience.degradations{from=pallas_fused_gather,"
        "to=pallas_fused_gather_tiled}": 1,
        "resilience.injected{kind=resource,site=ops.kernel}": 1,
        "resilience.injected{kind=transient,site=distributed.remap}": 1,
        "resilience.injected{kind=transient,site=ops.kernel}": 1,
        "resilience.retries{site=distributed.remap}": 1,
        "resilience.retries{site=ops.kernel}": 1}
    assert np.max(np.abs(np.subtract(port.fits, ref.fits))) <= FIT_TOL


@pytest.mark.parametrize("D", [1, 4])
def test_chaos_fits_allclose_and_every_fault_handled(D):
    ft = _ft("u3", D)
    kw = dict(workers=LocalWorkers(D, "cpu"), iters=3, tol=0.0,
              backend="auto", resilience=RetryPolicy())
    clean = tcpals.cp_als_distributed(ft, RANK, **kw)
    specs = SCHEDULE + [("execution.resolve", 5, "resource")]
    with tcnt.use_registry() as reg, inject(specs) as inj:
        chaos = tcpals.cp_als_distributed(ft, RANK, **kw)
    assert inj.pending() == ()
    injected = reg.total("resilience.injected")
    handled = reg.total("resilience.retries") \
        + reg.total("resilience.degradations")
    assert injected == handled == len(specs)
    np.testing.assert_allclose(chaos.fits, clean.fits, rtol=1e-4, atol=1e-5)


def test_oocore_chunk_site_replays_bitwise():
    from repro_torch.oocore.executor import mttkrp_out_of_core
    rng = np.random.default_rng(0)
    t = ttens.random_sparse_tensor((400, 40, 300), 600, seed=3)
    order = np.argsort(t.indices[:, 0], kind="stable")
    idx, val = t.indices[order].astype(np.int32), t.values[order]
    factors = [rng.standard_normal((d, 16)).astype(np.float32)
               for d in t.shape]
    kw = dict(mode=0, rows_cap=400, blk=32, tile_rows=8,
              max_chunk_bytes=2000, device="cpu")
    valid = np.ones(len(val), bool)
    clean, stats = mttkrp_out_of_core(idx, val, valid, factors, **kw)
    assert stats.chunks >= 5
    with tcnt.use_registry() as reg, tres.use_policy(), \
            inject([("oocore.chunk", 2, "transient")]) as inj:
        again, _ = mttkrp_out_of_core(idx, val, valid, factors, **kw)
    assert inj.pending() == ()
    assert reg.get("resilience.retries", site="oocore.chunk") == 1
    assert torch.equal(clean, again)
    with inject([("oocore.chunk", 1, "transient")]):
        with pytest.raises(TransientFault):   # no policy: fail fast
            mttkrp_out_of_core(idx, val, valid, factors, **kw)


# ---------------------------------------------------------------------------
# The stepped driver against the reference's
# ---------------------------------------------------------------------------

def test_default_path_runs_als_sweep_and_counts_sweeps(monkeypatch):
    ft = _ft("u3", 1)
    called = []
    monkeypatch.setattr(tcpals, "_cp_als_distributed_stepped",
                        lambda *a, **k: called.append(1))
    with tcnt.use_registry() as reg:
        res = tcpals.cp_als_distributed(ft, RANK, device="cpu", iters=2,
                                        tol=0.0, backend="auto")
    assert not called and len(res.fits) == 2
    assert reg.get("cpals.sweeps", driver="distributed") == 2
    assert reg.get("cpals.sweep_s", driver="distributed") > 0
    assert reg.get("resilience.site_calls", site="ops.kernel") == 6


@pytest.mark.parametrize("name", sorted(CASES))
def test_stepped_d1_matches_reference_stepped(name):
    ft, fj = _ft(name, 1), _ft_ref(name, 1)
    tracer = ttr.Tracer()
    port = tcpals.cp_als_distributed(ft, RANK, device="cpu", iters=SWEEPS,
                                     tol=0.0, backend="pallas_fused_gather",
                                     tracer=tracer)
    mesh = Mesh(np.array(jax.devices()[:1]), (jdist.AXIS,))
    ref = jcpals.cp_als_distributed(fj, RANK, mesh, iters=SWEEPS, tol=0.0,
                                    backend="pallas_fused_gather",
                                    tracer=jtr.Tracer())
    assert np.max(np.abs(np.subtract(port.fits, ref.fits))) <= FIT_TOL
    for a, b in zip(port.factors, ref.factors):
        np.testing.assert_allclose(a, b, **FAC_TOL)
    np.testing.assert_allclose(port.lam, ref.lam, **FAC_TOL)
    trace = tracer.chrome_trace()
    names = ("sweep", "mode", "mttkrp", "solve", "remap")
    assert ttr.validate_chrome_trace(trace, expect_names=names) == []
    assert jtr.validate_chrome_trace(trace, expect_names=names) == []
    assert sum(r.name == "mode" for r in tracer.records) == \
        SWEEPS * ft.nmodes


def test_stepped_equals_als_sweep_path():
    """The stepped driver's solve on the full matrix equals the owned-rows
    solve of ``als_sweep``, at D=1 and D=4 (fp32 reduction order of the
    column norms aside)."""
    for D in (1, 4):
        ft = _ft("m4", D)
        kw = dict(workers=LocalWorkers(D, "cpu"), iters=SWEEPS, tol=0.0,
                  backend="segsum")
        plain = tcpals.cp_als_distributed(ft, RANK, **kw)
        stepped = tcpals.cp_als_distributed(ft, RANK, tracer=ttr.Tracer(),
                                            **kw)
        assert np.max(np.abs(np.subtract(plain.fits, stepped.fits))) <= 1e-6
        for a, b in zip(plain.factors, stepped.factors):
            np.testing.assert_allclose(a, b, **FAC_TOL)


MESH_REF = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
from jax.sharding import Mesh
from repro.core import cpals, distributed as dist, flycoo, tensors
from repro.obs.tracer import Tracer
cases, RANK, SWEEPS = json.loads(sys.argv[2])
mesh = Mesh(np.array(jax.devices()[:4]), (dist.AXIS,))
out = {}
for name, (tkw, fkw) in cases.items():
    ft = flycoo.build_flycoo(tensors.random_sparse_tensor(**tkw), 4, **fkw)
    res = cpals.cp_als_distributed(ft, RANK, mesh, iters=SWEEPS, tol=0.0,
                                   backend="segsum", tracer=Tracer())
    out[name + "_fits"] = np.asarray(res.fits)
    out[name + "_lam"] = res.lam
    for n, a in enumerate(res.factors):
        out[name + f"_factor{n}"] = a
np.savez(sys.argv[1], **out)
print("REFERENCE-OK")
"""


@pytest.fixture(scope="module")
def mesh_ref(tmp_path_factory):
    """The reference's stepped driver on its 4-device CPU mesh, once."""
    path = tmp_path_factory.mktemp("stepped_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", MESH_REF, str(path),
         json.dumps([CASES, RANK, SWEEPS])],
        env=env, capture_output=True, text=True, timeout=600)
    assert "REFERENCE-OK" in out.stdout, out.stdout + out.stderr
    with np.load(path) as z:
        return dict(z)


@pytest.mark.parametrize("name", sorted(CASES))
def test_stepped_d4_matches_reference_mesh(mesh_ref, name):
    ft = _ft(name, 4)
    port = tcpals.cp_als_distributed(ft, RANK, workers=LocalWorkers(4, "cpu"),
                                     iters=SWEEPS, tol=0.0, backend="segsum",
                                     tracer=ttr.Tracer())
    assert np.max(np.abs(port.fits - mesh_ref[name + "_fits"])) <= FIT_TOL
    for n, a in enumerate(port.factors):
        np.testing.assert_allclose(a, mesh_ref[name + f"_factor{n}"],
                                   **FAC_TOL)
    np.testing.assert_allclose(port.lam, mesh_ref[name + "_lam"], **FAC_TOL)


def test_chaos_smoke_cli_returns_zero():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.resilience", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "chaos smoke passed" in proc.stdout
