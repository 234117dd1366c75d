"""repro_torch.tune against repro.tune: tables, cost model, dispatch and
tuned runtimes, and the tuned CP-ALS run as a whole.

The first half mirrors ``tests/test_tune.py`` case for case where the
contract carries over (stub timings: deterministic seconds per backend x
configuration, so the production table/model/dispatch paths run without
timing noise). The second half holds the port against the reference:
stub tables entry for entry, ``make_case`` arrays, the cost model's
answers, per-mode plans and the table-driven dispatch where both
packages' residency planners accept every candidate, and
``cp_als_distributed(table=)`` on a one-device mesh (fits at 1e-5,
factors at 1e-4, the tolerances of ``tests/test_torch_cpals.py``).
"""
import dataclasses
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro import tune as jtune  # noqa: E402
from repro.core import cpals as jcpals  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.core import flycoo as jfly  # noqa: E402
from repro.core import tensors as jten  # noqa: E402
from repro.kernels.mttkrp import ops as jops  # noqa: E402
from repro.oocore import planner as jplanner  # noqa: E402
from repro.tune import cli as jcli  # noqa: E402
from repro.tune import microbench as jmb  # noqa: E402
from repro.tune import table as jtable  # noqa: E402
from repro_torch import tune  # noqa: E402
from repro_torch.core import cpals as tcpals  # noqa: E402
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.core import flycoo as tfly  # noqa: E402
from repro_torch.core import tensors as tten  # noqa: E402
from repro_torch.core.remap import remap_capacities  # noqa: E402
from repro_torch.kernels.mttkrp import ops as kops  # noqa: E402
from repro_torch.obs import counters as ocnt  # noqa: E402
from repro_torch.obs import tracer as otr  # noqa: E402
from repro_torch.oocore import planner  # noqa: E402
from repro_torch.resilience import faults as tfaults  # noqa: E402
from repro_torch.tune import cli as tcli  # noqa: E402
from repro_torch.tune import microbench as tmb  # noqa: E402
from repro_torch.tune.microbench import BACKENDS, GridPoint  # noqa: E402
from repro_torch.tune.table import (SCHEMA_VERSION,  # noqa: E402
                                    CalibrationTable, SchemaVersionError)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAC_TOL = dict(rtol=1e-4, atol=1e-5)
FIT_TOL = 1e-5

fake_measure = tune.stub_measure


@pytest.fixture()
def table():
    return tune.calibrate(measure=fake_measure, quick=True, device="cpu")


def _table_with_ranks(ranks, timings_fn, *, pkg=tune, nmodes=3, blk=32,
                      tile_rows=8):
    entries = [pkg.CalibrationEntry(nmodes=nmodes, rank=r, blk=blk,
                                    tile_rows=tile_rows, density=1.0,
                                    timings_s=timings_fn(r))
               for r in ranks]
    return pkg.CalibrationTable(entries=entries)


def _small_ft(seed=3, D=4):
    t = tten.random_sparse_tensor((40, 30, 20), 400, seed=seed,
                                  distribution="powerlaw")
    return t, tfly.build_flycoo(t, D, m_bounds=(4, 16), g_bounds=(8, 64),
                                cache_bytes=1 << 20)


def _small_pair(seed=3, D=4):
    _, ft = _small_ft(seed, D)
    tj = jten.random_sparse_tensor((40, 30, 20), 400, seed=seed,
                                   distribution="powerlaw")
    fj = jfly.build_flycoo(tj, D, m_bounds=(4, 16), g_bounds=(8, 64),
                           cache_bytes=1 << 20)
    return ft, fj


# ---------------------------------------------------------------------------
# Table serialization and the registry
# ---------------------------------------------------------------------------

def test_json_round_trip(table, tmp_path):
    path = table.save(str(tmp_path / "t.json"))
    loaded = tune.load_table(path)
    assert loaded.schema_version == SCHEMA_VERSION
    assert loaded.entries == table.entries
    assert loaded.meta == table.meta
    for key in table.shape_keys():
        n, r, b, t = key
        kw = dict(nmodes=n, rank=r, blk=b, tile_rows=t)
        assert loaded.best_backend(**kw) == table.best_backend(**kw)


def test_schema_version_rejected(table, tmp_path):
    path = table.save(str(tmp_path / "t.json"))
    obj = json.load(open(path))
    # The reference's versions 1-4 too: a table of the JAX package timed
    # other kernels.
    for bad in ("torch-2", 0, None, 1, 2, 3, 4):
        obj["schema_version"] = bad
        json.dump(obj, open(path, "w"))
        with pytest.raises(SchemaVersionError, match="schema_version"):
            tune.load_table(path)


def test_neither_package_loads_the_others_tables(table, tmp_path):
    fixtures = sorted(glob.glob(os.path.join(
        REPO, "experiments", "tune", "fixtures", "*.json")))
    assert fixtures
    for path in fixtures:
        jtune.load_table(path)                       # the reference's own
        with pytest.raises(SchemaVersionError):
            tune.load_table(path)
    ours = table.save(str(tmp_path / "port.json"))
    with pytest.raises(jtable.SchemaVersionError):
        jtune.load_table(ours)
    # The reference's fresh table is refused as well, and neither registry
    # serves the other package's file.
    jt = jtune.calibrate(measure=jtune.stub_measure, quick=True)
    jt.save(str(tmp_path / "ref.json"))
    with pytest.raises(SchemaVersionError):
        tune.load_table(str(tmp_path / "ref.json"))
    os.remove(ours)
    assert tune.find_table(str(tmp_path), match_host=False) is None


def test_find_table_skips_foreign_host(table, tmp_path):
    """A table timed on another machine, or another card or power limit,
    must not steer this host."""
    for foreign_meta in (dict(machine="aarch64-x"),
                         dict(device_type="cuda",
                              device_name="NVIDIA H100 80GB HBM3",
                              power_limit="700.00 W"),
                         dict(power_limit="350.00 W")):
        d = tmp_path / str(len(list(tmp_path.iterdir())))
        foreign = CalibrationTable(entries=list(table.entries),
                                   meta=dict(table.meta, **foreign_meta))
        foreign.save(str(d / "foreign.json"))
        assert tune.find_table(str(d), device="cpu") is None
        got = tune.find_table(str(d), match_host=False)
        assert got is not None and got.entries == table.entries
        table.save(str(d / "local.json"))                # matching host
        assert tune.find_table(str(d), device="cpu") is not None


def test_host_meta_records_the_device(table):
    meta = table.meta
    assert meta["device_type"] == "cpu"
    assert meta["torch"] == torch.__version__
    assert "jax_backend" not in meta
    assert tune.table._matches_host(meta, "cpu")


def test_find_table_never_serves_stub_tables(table, tmp_path):
    stub = CalibrationTable(entries=list(table.entries),
                            meta=dict(table.meta, stub=True))
    path = stub.save(str(tmp_path / "stubbed.json"))
    assert tune.find_table(str(tmp_path), device="cpu") is None
    assert tune.find_table(str(tmp_path), match_host=False) is None
    assert tune.load_table(path).entries == table.entries
    table.save(str(tmp_path / "real.json"))
    found = tune.find_table(str(tmp_path), device="cpu")
    assert found is not None and not found.meta.get("stub")


def test_model_cache_invalidated_on_entry_change():
    t = _table_with_ranks((16,), lambda r: {"pallas": 0.5, "ref": 0.1})
    kw = dict(nmodes=3, rank=16, blk=32, tile_rows=8)
    assert t.best_backend(**kw) == "ref"
    t.entries.append(tune.CalibrationEntry(
        nmodes=3, rank=16, blk=32, tile_rows=8, density=4.0,
        timings_s={"pallas": 0.01, "ref": 0.9}))
    assert t.best_backend(**kw) == "pallas"


def test_find_table_registry(table, tmp_path):
    assert tune.find_table(str(tmp_path / "missing")) is None
    (tmp_path / "a_corrupt.json").write_text("{not json")
    bad = table.save(str(tmp_path / "b_wrongschema.json"))
    obj = json.load(open(bad))
    obj["schema_version"] = 999
    json.dump(obj, open(bad, "w"))
    good = table.save(str(tmp_path / "c_good.json"))
    # The two bad tables are the newest: the registry reads them first.
    os.utime(good, (1000, 1000))
    for p in (tmp_path / "a_corrupt.json", bad):
        os.utime(p, (2000, 2000))
    with ocnt.use_registry() as reg:
        found = tune.find_table(str(tmp_path), device="cpu")
    assert found is not None and found.entries == table.entries
    # What was skipped on the way is counted, as in the reference.
    assert reg.get("resilience.table_fallbacks", reason="unloadable") == 2
    assert reg.get("resilience.site_calls", site="tune.table_load") == 3


def test_injected_corruption_is_skipped_and_counted(table, tmp_path):
    table.save(str(tmp_path / "t.json"))
    spec = tfaults.FaultSpec("tune.table_load", 0, "corruption")
    with ocnt.use_registry() as reg, tfaults.inject([spec]) as inj:
        assert tune.find_table(str(tmp_path), device="cpu") is None
        assert tune.find_table(str(tmp_path), device="cpu") is not None
    assert inj.pending() == ()
    assert reg.get("resilience.table_fallbacks", reason="corrupt") == 1
    assert reg.get("resilience.site_calls", site="tune.table_load") == 2


# ---------------------------------------------------------------------------
# Cost model: interpolation
# ---------------------------------------------------------------------------

def test_interpolation_at_off_grid_rank():
    t = _table_with_ranks(
        (16, 64), lambda r: {"pallas": 0.01 * np.log2(r),
                             "ref": 0.08 - 0.01 * np.log2(r)})
    m = t.model
    assert m.predict("pallas", nmodes=3, rank=32, blk=32,
                     tile_rows=8) == pytest.approx(0.05)
    assert t.best_backend(nmodes=3, rank=16, blk=32, tile_rows=8) == "pallas"
    assert t.best_backend(nmodes=3, rank=64, blk=32, tile_rows=8) == "ref"
    assert m.predict("pallas", nmodes=3, rank=1024, blk=32,
                     tile_rows=8) == pytest.approx(0.06)


def test_off_grid_shape_resolves_to_nearest_group():
    t = _table_with_ranks((16,), lambda r: {"pallas": 0.5, "ref": 0.1})
    assert t.best_backend(nmodes=3, rank=16, blk=512, tile_rows=128) == "ref"
    assert t.best_backend(nmodes=5, rank=16, blk=512, tile_rows=128) == "ref"


# ---------------------------------------------------------------------------
# Dispatch wiring: select_backend(table=...)
# ---------------------------------------------------------------------------

def test_select_backend_matches_measured_argmin_on_grid(table):
    for key in table.shape_keys():
        n, r, b, t = key
        agg = {bk: float(np.median([e.timings_s[bk] for e in table.entries
                                    if e.shape_key == key]))
               for bk in BACKENDS}
        want = min(sorted(kops.AUTO_BACKENDS), key=lambda bk: (agg[bk], bk))
        with ocnt.use_registry() as reg:
            got = kops.select_backend("auto", nmodes=n, rank=r, blk=b,
                                      tile_rows=t, table=table,
                                      factor_rows=tune.key_factor_rows(
                                          table, key))
        assert got == want, (key, got, want)
        assert reg.snapshot() == {
            f"dispatch.backend{{backend={got},source=table}}": 1}


def test_select_backend_without_table_is_static(table):
    """No table (or an unanswerable one) gives the static ladder's choice
    and its count, bit for bit."""
    empty = CalibrationTable(entries=[])
    for nmodes in (2, 3, 4, 5):
        for rank in (4, 16, 64, 256, 2048, 8192):
            for blk in (64, 512):
                for frows in (None, 4000, 10**7):
                    kw = dict(nmodes=nmodes, rank=rank, blk=blk, tile_rows=8,
                              factor_rows=frows)
                    with ocnt.use_registry() as r0:
                        static = kops.select_backend("auto", **kw)
                    assert static == planner.plan_residency(**kw).backend
                    with ocnt.use_registry() as r1:
                        assert kops.select_backend("auto", table=empty,
                                                   **kw) == static
                    assert r0.snapshot() == r1.snapshot()


def test_select_backend_table_never_returns_segsum_or_bf16(table):
    for key in table.shape_keys():
        n, r, b, t = key
        for frows in (None, tune.key_factor_rows(table, key)):
            got = kops.select_backend("auto", nmodes=n, rank=r, blk=b,
                                      tile_rows=t, table=table,
                                      factor_rows=frows)
            assert got in kops.AUTO_BACKENDS
            assert got != "segsum" and not got.endswith("_bf16")


def test_explicit_backend_ignores_table(table):
    for bk in kops.BACKENDS:
        with ocnt.use_registry() as reg:
            assert kops.select_backend(bk, nmodes=3, rank=16,
                                       table=table) == bk
        assert reg.get("dispatch.backend", backend=bk,
                       source="explicit") == 1


def test_below_grid_rank_answers_from_the_clamped_knot(table):
    """The port keeps no MIN_MXU_RANK guard (its ladder has no ``ref``
    rung to protect; a rank below 16 pads to 16): a rank below the grid
    answers with the lowest knot's times, where the reference keeps
    ``ref``."""
    for rank in (1, 2, 4, 7, 15):
        kw = dict(nmodes=3, rank=rank, blk=64, tile_rows=8)
        assert not table.covers(**kw)
        got = kops.select_backend("auto", table=table, **kw)
        assert got == kops.select_backend(
            "auto", table=table, **dict(kw, rank=16))
        assert got == table.best_backend(allowed=kops.AUTO_BACKENDS, **kw)
        assert jops.select_backend("auto", table=jtune.calibrate(
            measure=jtune.stub_measure), nmodes=3, rank=min(rank, 7),
            blk=32, tile_rows=8) == "ref"
    _, ft = _small_ft()
    low = tune.plan_modes(table, ft, 4)
    at16 = tune.plan_modes(table, ft, 16)
    assert low is not None
    assert [p.backend for p in low] == [p.backend for p in at16]


def test_table_cannot_pick_infeasible_fused():
    """Shared-memory fit is a hard constraint: a table that loves B3 far
    beyond its grid does not pick a CTA that exceeds the budget; the
    static ladder answers."""
    t = _table_with_ranks(
        (16, 256), lambda r: {"pallas_fused": 0.001, "pallas": 1.0,
                              "ref": 1.0})
    kw = dict(nmodes=5, rank=8192, blk=512, tile_rows=8)
    assert not planner.backend_fits("pallas_fused", **kw)
    with ocnt.use_registry() as reg:
        got = kops.select_backend("auto", table=t, **kw)
    assert got == kops.select_backend("auto", **kw)
    assert reg.get("dispatch.backend", backend=got, source="static") == 1
    entries = [tune.CalibrationEntry(nmodes=3, rank=r, blk=512, tile_rows=8,
                                     density=1.0,
                                     timings_s={"pallas_fused": 0.001,
                                                "pallas": 1.0})
               for r in (16, 256)]
    _, ft = _small_ft()
    assert not planner.backend_fits("pallas_fused", nmodes=3, rank=4096,
                                    blk=512, tile_rows=8)
    plans = tune.plan_modes(CalibrationTable(entries=entries), ft, 4096)
    assert plans is not None
    assert all(p.backend == "pallas" for p in plans)


# ---------------------------------------------------------------------------
# Runtime wiring: bucket_caps + mode plans
# ---------------------------------------------------------------------------

def test_prepare_runtime_per_transition_caps():
    _, ft = _small_ft()
    rt, _ = dist.prepare_runtime(ft, rank=8, tile_rows=8)
    caps = remap_capacities(ft)
    assert rt.bucket_caps == tuple(caps)
    assert rt.bucket_cap == max(caps)
    for n in range(ft.nmodes):
        assert rt.bucket_cap_for(n) == caps[n] <= rt.bucket_cap


def test_prepare_runtime_uniform_cap_escape_hatch():
    ft, fj = _small_pair()
    with ocnt.use_registry() as reg:
        rt, packed = dist.prepare_runtime(ft, rank=8, tile_rows=8,
                                          uniform_cap=True)
    assert rt.bucket_caps is None
    for n in range(ft.nmodes):
        assert rt.bucket_cap_for(n) == rt.bucket_cap
    rj, packed_j = jdist.prepare_runtime(fj, rank=8, tile_rows=8,
                                         uniform_cap=True)
    assert (rt.bucket_cap, rt.bucket_caps) == (rj.bucket_cap, rj.bucket_caps)
    for a, b in zip(packed, packed_j):
        np.testing.assert_array_equal(a, b)
    # The exchange is counted at the uniform capacity, as the reference
    # counts it.
    from repro.obs import counters as jcnt
    jreg = jcnt.CounterRegistry()
    jcnt.record_remap_exchange(remap_capacities(ft), ft.params.num_workers,
                               ft.nmodes, uniform_cap=True, registry=jreg)
    assert reg.snapshot() == jreg.snapshot()
    # Every remap of a sweep then runs at that capacity and drops nothing.
    res = tcpals.cp_als_distributed(ft, 8, device="cpu", iters=1)
    from repro_torch.core.workers import LocalWorkers
    wk = LocalWorkers(ft.params.num_workers, "cpu")
    stream, factors, lam, x2 = tcpals.device_state(ft, rt, packed, seed=0,
                                                   workers=wk)
    sweep = tcpals.als_sweep(stream, factors, lam, x2, rt, workers=wk,
                             sweep0=True, backend="segsum")
    assert abs(float(sweep.fit) - res.fits[0]) <= FIT_TOL


def test_runtime_back_compat_construction():
    rt = dist.DynasorRuntime(
        num_workers=1, nmodes=3, rank=8, rows_cap=(8, 8, 8),
        i_pad=(8, 8, 8), nnz_cap=8, bucket_cap=8, shape=(8, 8, 8))
    assert rt.mode_plans is None
    assert rt.bucket_cap_for(2) == 8
    assert rt.plan_for(1, "pallas") == dist.ModePlan(
        "pallas", 512, 8, rank_slabs=planner.rung_slabs("pallas", 8))
    # Slabs and windows follow the resolved backend, in the port's geometry.
    wide = dataclasses.replace(rt, rank=256, i_pad=(800, 900, 1000))
    p = wide.plan_for(0, "pallas_fused_gather_tiled")
    assert p.rank_slabs == 256 // 128 and p.window_tiles == ()
    p = wide.plan_for(0, kops.STREAM_BACKEND)
    assert p.rank_slabs == 256 // 16
    assert p.window_tiles == tuple(planner.stream_window_tiles(512, r)
                                   for r in (900, 1000))
    assert wide.plan_for(0, "auto").rank_slabs == 1


def test_prepare_runtime_with_table_builds_plans(table):
    _, ft = _small_ft()
    rt, (idx, val, mask) = dist.prepare_runtime(ft, rank=16, table=table)
    assert rt.mode_plans is not None and len(rt.mode_plans) == ft.nmodes
    for n, plan in enumerate(rt.mode_plans):
        assert plan.backend in BACKENDS
        assert (plan.blk, plan.tile_rows) in {(64, 8), (512, 8)}
        assert rt.rows_cap[n] % plan.tile_rows == 0
        assert rt.plan_for(n, "auto") == plan
        assert rt.plan_for(n, "segsum").backend == "segsum"
        assert rt.plan_for(n, "segsum").blk == plan.blk
    assert idx.shape[0] == ft.params.num_workers


def test_plan_modes_unanswerable_returns_none():
    _, ft = _small_ft()
    assert tune.plan_modes(CalibrationTable(entries=[]), ft, 16) is None
    rt, _ = dist.prepare_runtime(ft, rank=16,
                                 table=CalibrationTable(entries=[]))
    assert rt.mode_plans is None


def test_plan_modes_geometry_is_the_ports():
    """``rank_slabs`` and ``window_tiles`` come from the port's geometry,
    as ``plan_residency`` derives them."""
    _, ft = _small_ft(D=1)
    for backend in ("pallas_fused_gather_tiled", kops.STREAM_BACKEND,
                    "pallas", "pallas_fused_gather"):
        t = _table_with_ranks((16, 256), lambda r, b=backend: {b: 0.001,
                                                              "ref": 1.0},
                              blk=64)
        plans = tune.plan_modes(t, ft, 256)
        for n, p in enumerate(plans):
            assert p.backend == backend
            frows = tuple(ft.modes[w].rows_cap for w in range(3) if w != n)
            res = planner.plan_residency(nmodes=3, rank=256, blk=64,
                                         tile_rows=8, factor_rows=frows,
                                         smem_budget=10**9, l2_budget=10**12)
            assert p.rank_slabs == planner.rung_slabs(backend, 256)
            if backend == res.backend:
                assert p.rank_slabs == res.rank_slabs
            want_w = (tuple(planner.stream_window_tiles(64, r)
                            for r in frows)
                      if backend == kops.STREAM_BACKEND else ())
            assert p.window_tiles == want_w


# ---------------------------------------------------------------------------
# Every mode step reads its configuration from the plan
# ---------------------------------------------------------------------------

def _kernel_table(backend="pallas_fused_gather", blk=32):
    return _table_with_ranks((8, 16), lambda r: {backend: 0.001,
                                                 "segsum": 0.5, "ref": 0.5},
                             blk=blk)


@pytest.mark.parametrize("driver", ["als_sweep", "stepped", "resilience",
                                    "checkpoint"])
def test_every_mode_step_goes_through_the_plan(driver, monkeypatch,
                                               tmp_path):
    _, ft = _small_ft(D=2)
    table = _kernel_table(blk=32)
    rt, _ = dist.prepare_runtime(ft, 8, table=table)
    assert rt.blk != 32 and all(p.blk == 32 for p in rt.mode_plans)
    seen = []
    real = kops.mttkrp_device_step

    def spy(*a, **kw):
        seen.append((kw["blk"], kw["tile_rows"], kw["backend"],
                     kw["rows_cap"]))
        return real(*a, **kw)

    monkeypatch.setattr(kops, "mttkrp_device_step", spy)
    kw = dict(device="cpu", iters=2, tol=0.0, backend="auto", table=table)
    if driver == "stepped":
        kw["tracer"] = otr.Tracer()
    elif driver == "resilience":
        from repro_torch.resilience import RetryPolicy
        kw["resilience"] = RetryPolicy()
    elif driver == "checkpoint":
        kw["checkpoint_dir"] = str(tmp_path)
    res = tcpals.cp_als_distributed(ft, 8, **kw)
    assert np.all(np.isfinite(res.fits))
    # 2 sweeps x 3 modes x 2 workers, each on its plan.
    assert len(seen) == 2 * 3 * 2
    for blk, tile_rows, backend, rows_cap in seen:
        assert (blk, tile_rows, backend) == (32, 8, "pallas_fused_gather")
        assert rows_cap in rt.rows_cap


def test_tuned_checkpoint_resume_is_exact(tmp_path):
    _, ft = _small_ft(D=2)
    table = _kernel_table(blk=32)
    kw = dict(device="cpu", tol=0.0, backend="auto", table=table)
    tcpals.cp_als_distributed(ft, 8, iters=2,
                              checkpoint_dir=str(tmp_path / "a"), **kw)
    resumed = tcpals.cp_als_distributed(
        ft, 8, iters=3, checkpoint_dir=str(tmp_path / "a"), **kw)
    full = tcpals.cp_als_distributed(ft, 8, iters=3,
                                     checkpoint_dir=str(tmp_path / "b"), **kw)
    assert resumed.fits == full.fits
    for a, b in zip(resumed.factors, full.factors):
        np.testing.assert_array_equal(a, b)


def test_no_table_is_bit_identical_with_identical_counts():
    _, ft = _small_ft(D=2)
    runs = []
    for extra in ({}, dict(table=None),
                  dict(table=CalibrationTable(entries=[]))):
        with ocnt.use_registry() as reg:
            res = tcpals.cp_als_distributed(ft, 8, device="cpu", iters=2,
                                            tol=0.0, backend="auto", **extra)
        runs.append((res, {k: v for k, v in reg.snapshot().items()
                           if not ocnt.split_key(k)[0].endswith("_s")}))
    (r0, c0), *rest = runs
    for r, c in rest:
        assert r.fits == r0.fits
        for a, b in zip(r.factors, r0.factors):
            np.testing.assert_array_equal(a, b)
        assert c == c0


def test_plan_equal_to_static_is_bitwise_the_static_run():
    """A table whose plans are the static configuration (B1 at the
    runtime's blk and tile) gives the static run bit for bit."""
    _, ft = _small_ft(D=1)
    rt0, _ = dist.prepare_runtime(ft, 8)
    table = _kernel_table(blk=rt0.blk)
    rt, _ = dist.prepare_runtime(ft, 8, table=table)
    static = [rt0.plan_for(n, kops.select_backend(
        "auto", nmodes=3, rank=8, blk=rt0.blk, tile_rows=8,
        factor_rows=tuple(rt0.i_pad[w] for w in range(3) if w != n)))
        for n in range(3)]
    assert list(rt.mode_plans) == static
    a = tcpals.cp_als_distributed(ft, 8, device="cpu", iters=2, tol=0.0,
                                  backend="auto")
    b = tcpals.cp_als_distributed(ft, 8, device="cpu", iters=2, tol=0.0,
                                  backend="auto", table=table)
    assert a.fits == b.fits
    for x, y in zip(a.factors, b.factors):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# Calibration itself: spans, counters, a real (plain-version) run
# ---------------------------------------------------------------------------

def test_calibrate_spans_and_counters():
    grid = [GridPoint(3, 16, 32, 8, 0.5), GridPoint(4, 16, 32, 8, 2.0)]
    tracer = otr.Tracer()
    with ocnt.use_registry() as reg, otr.use_tracer(tracer):
        t = tune.calibrate(grid=grid, measure=fake_measure, device="cpu")
    from repro.obs import counters as jcnt
    from repro.obs import tracer as jtr
    jreg, jtracer = jcnt.CounterRegistry(), jtr.Tracer()
    with jcnt.use_registry(jreg), jtr.use_tracer(jtracer):
        jtune.calibrate(grid=[jmb.GridPoint(*dataclass_tuple(p))
                              for p in grid], measure=jtune.stub_measure)
    # The reference's host_meta also resolves its execution policy, which
    # the port has no counterpart of: compare the tune.* counters.
    assert reg.snapshot() == {k: v for k, v in jreg.snapshot().items()
                              if k.startswith("tune.")}
    assert [(r.name, r.depth) for r in tracer.records] == \
        [(r.name, r.depth) for r in jtracer.records]
    assert t.meta["obs"]["spans"] == len(tracer.records)
    assert reg.get("tune.points") == 2


def dataclass_tuple(p):
    return (p.nmodes, p.rank, p.blk, p.tile_rows, p.density)


def test_real_calibration_on_the_cpu_times_the_plain_versions():
    grid = [GridPoint(3, 16, 32, 8, 0.5)]
    t = tune.calibrate(grid=grid, device="cpu", iters=1, warmup=0)
    (e,) = t.entries
    assert set(e.timings_s) == set(BACKENDS)
    assert all(s > 0 for s in e.timings_s.values())
    (case,) = t.meta["obs"]["cases"]
    lay = tmb.case_layout(grid[0], tmb.make_case(grid[0], device="cpu"))
    assert case["nnz"] == lay["nnz"] == 64
    assert case["trailing_blocks"] == lay["trailing_blocks"]
    assert 0 < lay["live_tiles"] <= lay["num_tiles"] == 4


def test_case_layout_counts_the_static_streams_trailing_padding():
    for point in (GridPoint(3, 16, 64, 8, 0.5), GridPoint(4, 16, 512, 8, 2.0),
                  GridPoint(3, 16, 32, 8, 4.0)):
        case = tmb.make_case(point, device="cpu",
                             num_tiles=tmb.case_num_tiles(point, 5000))
        idx, val, valid, factors, rows_cap = case
        lay = tmb.case_layout(point, case)
        slot, tob = kops.build_block_layout(
            idx[:, 0], valid, rows_cap=rows_cap, blk=point.blk,
            tile_rows=point.tile_rows)
        assert lay["blocks"] == tob.shape[0]
        # The trailing blocks are those past the last slot that holds a
        # nonzero, all clipped onto the last tile.
        last = int(slot.max()) // point.blk
        assert lay["trailing_blocks"] == tob.shape[0] - 1 - last
        assert (tob[last + 1:] == rows_cap // point.tile_rows - 1).all()
        assert lay["nnz"] == idx.shape[0] >= 5000 * 0.9
        tiles = idx[:, 0].long() // point.tile_rows
        assert lay["busiest_tile_nnz"] == int(torch.bincount(tiles).max())


@pytest.mark.parametrize("quick", [True, False])
def test_card_grid_keeps_every_backend_feasible(quick):
    """On the card every case's factors fit every rung at every key of
    both grids, so each backend launches and each measured argmin is a
    choice the dispatch may follow."""
    for p in tmb.default_grid(quick=quick):
        for b in BACKENDS:
            assert planner.backend_fits(
                b, nmodes=p.nmodes, rank=p.rank, blk=p.blk,
                tile_rows=p.tile_rows,
                factor_rows=tmb.case_factor_rows(p, tmb.CARD_SIDE_DIM)), \
                (p, b)


def test_default_grid_covers_the_ports_keys():
    keys = {(p.nmodes, p.rank, p.blk, p.tile_rows, p.density)
            for p in tmb.default_grid(quick=True)}
    assert keys == {(n, r, b, 8, d) for n in (3, 4) for r in (16, 256)
                    for b in (64, 512) for d in (0.5, 2.0)}
    assert len(tmb.default_grid(quick=False)) > len(keys)


# ---------------------------------------------------------------------------
# Held against repro.tune
# ---------------------------------------------------------------------------

def _ref_grid(quick):
    return [GridPoint(*dataclass_tuple(p))
            for p in jmb.default_grid(quick=quick)]


@pytest.mark.parametrize("quick", [True, False])
def test_stub_tables_equal_the_reference_entry_for_entry(quick):
    got = tune.calibrate(grid=_ref_grid(quick), measure=fake_measure,
                         device="cpu")
    want = jtune.calibrate(quick=quick, measure=jtune.stub_measure)
    assert len(got.entries) == len(want.entries)
    for g, w, p in zip(got.entries, want.entries, _ref_grid(quick)):
        assert (g.nmodes, g.rank, g.blk, g.tile_rows, g.density,
                g.timings_s, g.factor_rows) == \
            (w.nmodes, w.rank, w.blk, w.tile_rows, w.density,
             w.timings_s, w.factor_rows)
        # The window is counted in the port's 8-row factor tiles; at the
        # reference's 128 it is the reference's.
        assert g.stream_window_tiles == tmb.case_stream_window_tiles(p)
        assert planner.stream_window_tiles(p.blk, 64, 128) == \
            w.stream_window_tiles
    assert got.shape_keys() == want.shape_keys()
    for key in got.shape_keys():
        assert tune.aggregate_timings(got, key) == \
            jtable.aggregate_timings(want, key)
        assert tune.measured_best(tune.aggregate_timings(got, key)) == \
            jtable.measured_best(jtable.aggregate_timings(want, key))


@pytest.mark.parametrize("point", [(3, 16, 32, 8, 0.5), (4, 128, 32, 8, 2.0),
                                   (5, 64, 128, 16, 0.25), (3, 8, 16, 4, 4.0)],
                         ids=str)
@pytest.mark.parametrize("seed", [0, 3])
def test_make_case_equals_the_reference(point, seed):
    got = tmb.make_case(GridPoint(*point), seed=seed, device="cpu")
    want = jmb.make_case(jmb.GridPoint(*point), seed=seed)
    idx, val, valid, factors, rows_cap = got
    assert rows_cap == want[4]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(val.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want[2]))
    for a, b in zip(factors, want[3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tmb.case_factor_rows(GridPoint(*point)) == \
        jmb.case_factor_rows(jmb.GridPoint(*point))


def _random_tables(seed):
    """The same random entries in both packages: two shapes, three ranks,
    two densities, and backends left unmeasured at random."""
    rng = np.random.default_rng(seed)
    port, ref = [], []
    for n in (3, 4):
        for blk in (32, 128):
            for r in (16, 64, 256):
                for d in (0.5, 2.0):
                    timings = {b: float(rng.random()) for b in BACKENDS
                               if rng.random() < 0.8}
                    kw = dict(nmodes=n, rank=r, blk=blk, tile_rows=8,
                              density=d, timings_s=timings,
                              factor_rows=(n - 1) * 64)
                    port.append(tune.CalibrationEntry(**kw))
                    ref.append(jtune.CalibrationEntry(**kw))
    return (tune.CalibrationTable(entries=port),
            jtune.CalibrationTable(entries=ref))


@pytest.mark.parametrize("seed", range(3))
def test_cost_model_answers_as_the_reference(seed):
    pt, jt = _random_tables(seed)
    pm, jm = pt.model, jt.model
    assert pm.backends == jm.backends
    for n in (2, 3, 4, 5):
        assert pm.shape_candidates(n) == jm.shape_candidates(n)
        for rank in (4, 16, 40, 100, 256, 1024):
            for blk in (16, 32, 64, 128, 512):
                for tile_rows in (4, 8, 16):
                    kw = dict(nmodes=n, rank=rank, blk=blk,
                              tile_rows=tile_rows)
                    assert pm.covers(**kw) == jm.covers(**kw)
                    for density in (None, 0.1, 1.0, 3.0):
                        for b in BACKENDS:
                            assert pm.predict(b, density=density, **kw) == \
                                jm.predict(b, density=density, **kw)
                        for allowed in (None, kops.AUTO_BACKENDS):
                            assert pm.best_backend(
                                allowed=allowed, density=density, **kw) == \
                                jm.best_backend(allowed=allowed,
                                                density=density, **kw)


def _all_fit(nmodes, rank, blk, tile_rows, factor_rows, backends):
    """Both packages' residency planners accept every candidate."""
    return all(
        planner.backend_fits(b, nmodes=nmodes, rank=rank, blk=blk,
                             tile_rows=tile_rows, factor_rows=factor_rows)
        and jplanner.backend_fits(b, nmodes=nmodes, rank=rank, blk=blk,
                                  tile_rows=tile_rows,
                                  factor_rows=factor_rows)
        for b in backends)


@pytest.mark.parametrize("seed", range(3))
def test_select_backend_table_path_equals_the_reference(seed):
    pt, jt = _random_tables(seed)
    stubs = (tune.calibrate(grid=_ref_grid(True), measure=fake_measure,
                            device="cpu"),
             jtune.calibrate(quick=True, measure=jtune.stub_measure))
    compared = 0
    for port, ref in ((pt, jt), stubs):
        for n in (3, 4):
            for rank in (8, 16, 40, 128, 256):
                for blk in (32, 64, 128):
                    for tile_rows in (8, 16):
                        frows = (n - 1) * 64
                        if not _all_fit(n, rank, blk, tile_rows, frows,
                                        kops.AUTO_BACKENDS):
                            continue
                        kw = dict(nmodes=n, rank=rank, blk=blk,
                                  tile_rows=tile_rows, factor_rows=frows)
                        if port.best_backend(
                                nmodes=n, rank=rank, blk=blk,
                                tile_rows=tile_rows,
                                allowed=kops.AUTO_BACKENDS) is None:
                            continue
                        assert kops.select_backend(
                            "auto", table=port, **kw) == \
                            jops.select_backend("auto", table=ref, **kw)
                        compared += 1
    assert compared >= 80


@pytest.mark.parametrize("D", [1, 4])
@pytest.mark.parametrize("which", ["stub", "random0", "random1", "kernel"])
def test_plan_modes_equal_the_reference(D, which):
    ft, fj = _small_pair(D=D)
    if which == "stub":
        port = tune.calibrate(grid=_ref_grid(True), measure=fake_measure,
                              device="cpu")
        ref = jtune.calibrate(quick=True, measure=jtune.stub_measure)
    elif which == "kernel":
        port = _kernel_table("pallas_fused", blk=32)
        ref = _table_with_ranks((8, 16), lambda r: {"pallas_fused": 0.001,
                                                    "segsum": 0.5,
                                                    "ref": 0.5},
                                pkg=jtune, blk=32)
    else:
        port, ref = _random_tables(int(which[-1]))
    for rank in (8, 16, 64):
        for n in range(3):
            frows = tuple(D * ft.modes[w].rows_cap for w in range(3)
                          if w != n)
            for blk, tile_rows in port.model.shape_candidates(3):
                assert _all_fit(3, rank, blk, tile_rows, frows,
                                port.model.backends), (rank, n, blk)
        got = tune.plan_modes(port, ft, rank, ordering="tile")
        want = jtune.plan_modes(ref, fj, rank, ordering="tile")
        assert [(p.backend, p.blk, p.tile_rows, p.ordering) for p in got] \
            == [(p.backend, p.blk, p.tile_rows, p.ordering) for p in want]
        rt, packed = dist.prepare_runtime(ft, rank, table=port)
        rj, packed_j = jdist.prepare_runtime(fj, rank, table=ref)
        assert rt.rows_cap == rj.rows_cap and rt.i_pad == rj.i_pad
        for a, b in zip(packed, packed_j):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The slice as a whole: tuned CP-ALS against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cp_tensors():
    t = tten.random_sparse_tensor((40, 30, 20), 2000, seed=0)
    tj = jten.random_sparse_tensor((40, 30, 20), 2000, seed=0)
    return tfly.build_flycoo(t, 1), jfly.build_flycoo(tj, 1)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]), (jdist.AXIS,))


@pytest.mark.parametrize("which", ["stub", "kernel"])
def test_tuned_cp_als_matches_jax(cp_tensors, mesh, which):
    ft, fj = cp_tensors
    rank = 8
    if which == "stub":
        port = tune.calibrate(grid=_ref_grid(True), measure=fake_measure,
                              device="cpu")
        ref = jtune.calibrate(quick=True, measure=jtune.stub_measure)
    else:
        port = _kernel_table("pallas_fused_gather", blk=32)
        ref = _table_with_ranks(
            (8, 16), lambda r: {"pallas_fused_gather": 0.001,
                                "segsum": 0.5, "ref": 0.5},
            pkg=jtune, blk=32)
    rt, _ = dist.prepare_runtime(ft, rank, table=port)
    rj, _ = jdist.prepare_runtime(fj, rank, table=ref)
    assert [(p.backend, p.blk, p.tile_rows) for p in rt.mode_plans] == \
        [(p.backend, p.blk, p.tile_rows) for p in rj.mode_plans]
    want_backend = "segsum" if which == "stub" else "pallas_fused_gather"
    assert {p.backend for p in rt.mode_plans} == {want_backend}
    got = tcpals.cp_als_distributed(ft, rank, device="cpu", iters=3,
                                    tol=0.0, backend="auto", table=port)
    want = jcpals.cp_als_distributed(fj, rank, mesh, iters=3, tol=0.0,
                                     backend="auto", table=ref)
    assert got.iters == want.iters == 3
    np.testing.assert_allclose(got.fits, want.fits, rtol=0, atol=FIT_TOL)
    for a, b in zip(got.factors, want.factors):
        np.testing.assert_allclose(a, b, **FAC_TOL)


# ---------------------------------------------------------------------------
# The CLI: the reference's exit codes
# ---------------------------------------------------------------------------

def test_cli_exit_codes_equal_the_reference(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    t_out, j_out = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    got = [tcli.main(["show", "--device", "cpu"]),
           tcli.main(["check", "--device", "cpu"]),
           tcli.main(["calibrate", "--stub", "--device", "cpu",
                      "--out", t_out]),
           tcli.main(["show", "--table", t_out, "--device", "cpu"]),
           tcli.main(["check", "--table", t_out, "--device", "cpu"])]
    want = [jcli.main(["show"]), jcli.main(["check"]),
            jcli.main(["calibrate", "--stub", "--out", j_out]),
            jcli.main(["show", "--table", j_out]),
            jcli.main(["check", "--table", j_out])]
    assert got == want == [1, 1, 0, 0, 0]
    out = capsys.readouterr().out
    assert "8/8 dispatch keys consistent" in out
    # An inconsistent key fails check with 1, as the reference's does.
    bad = tune.load_table(t_out)
    bad.entries = [e if e.shape_key != bad.shape_keys()[0] else
                   tune.CalibrationEntry(**dict(
                       e.to_json(), timings_s=dict(e.timings_s,
                                                   pallas_fused_gather=-1.0)))
                   for e in bad.entries]
    # Make the measured best infeasible for the dispatch: no factor rows.
    bad.entries = [tune.CalibrationEntry(**dict(e.to_json(),
                                                factor_rows=None))
                   for e in bad.entries]
    bad.save(str(tmp_path / "bad.json"))
    assert tcli.main(["check", "--table", str(tmp_path / "bad.json"),
                      "--device", "cpu"]) == 1


def test_module_entry_point_calibrate_show_check(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = str(tmp_path / "t.json")
    for args in (["calibrate", "--stub", "--device", "cpu", "--out", out],
                 ["show", "--table", out, "--device", "cpu"],
                 ["check", "--table", out, "--device", "cpu"]):
        proc = subprocess.run([sys.executable, "-m", "repro_torch.tune"]
                              + args, env=env, capture_output=True,
                              text=True, timeout=120, cwd=str(tmp_path))
        assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "dispatch keys consistent" in proc.stdout
    assert tune.load_table(out).meta["stub"] is True
