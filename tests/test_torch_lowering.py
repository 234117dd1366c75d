"""Port parity: the compile-validation tier ``repro_torch.kernels.mttkrp.
lowering`` against ``repro.kernels.mttkrp.lowering``.

* the geometry grids are the reference's, field for field, and the
  stream window at ``frow_tile=128`` is the reference's;
* step (a), ``compiled_geometry_ok``, equals ``oocore.planner.
  backend_fits`` at ``kernel.SMEM_LIMIT_BYTES`` and an L2 budget no
  factor reaches, for every backend at every geometry of the full grid;
* refused geometries and a missing ``nvcc`` come back as failing rows,
  never as exceptions, and a missing ``nvcc`` is named;
* the ``ptxas -v`` parser and the mapping of a backend to its kernel
  instantiation, on a fixed sample of ``ptxas`` output;
* the CLI's exit codes.

Building needs ``nvcc``: that part runs on the card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py``'s ``[lowering]``).
"""
import dataclasses
import os
import shutil
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels.mttkrp import lowering as jlow  # noqa: E402
from repro_torch.kernels.mttkrp import build as tbuild  # noqa: E402
from repro_torch.kernels.mttkrp import kernel as tk  # noqa: E402
from repro_torch.kernels.mttkrp import lowering as tlow  # noqa: E402
from repro_torch.kernels.mttkrp import ops as tops  # noqa: E402
from repro_torch.oocore import planner as tp  # noqa: E402



def _has_nvcc() -> bool:
    return (shutil.which("nvcc") is not None
            or os.path.exists("/usr/local/cuda/bin/nvcc"))

KERNEL_BACKENDS = tuple(b for b in tops.BACKENDS if b != "ref")


@pytest.mark.parametrize("grid", ["SMOKE_GEOMETRIES", "FULL_GEOMETRIES"])
def test_geometries_equal_reference(grid):
    mine, ref = getattr(tlow, grid), getattr(jlow, grid)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.rows_cap == b.rows_cap and a.label() == b.label()


@pytest.mark.parametrize("geom", jlow.FULL_GEOMETRIES,
                         ids=lambda g: g.label())
def test_window_tiles_at_reference_tile_equal_reference(geom):
    mine = tlow.Geometry(**dataclasses.asdict(geom))
    assert mine.window_tiles(frow_tile=128) == geom.window_tiles
    assert mine.window_tiles() == tp.stream_window_tiles(
        geom.blk, geom.factor_rows, tk.FACTOR_ROW_TILE)


@pytest.mark.parametrize("backend", tops.BACKENDS)
@pytest.mark.parametrize("geom", tlow.FULL_GEOMETRIES,
                         ids=lambda g: g.label())
def test_geometry_verdict_equals_backend_fits(backend, geom):
    ok, why = tlow.compiled_geometry_ok(geom, backend)
    fits = tp.backend_fits(
        backend, nmodes=geom.nmodes, rank=geom.rank, blk=geom.blk,
        tile_rows=geom.tile_rows,
        factor_rows=(geom.factor_rows,) * (geom.nmodes - 1),
        smem_budget=tk.SMEM_LIMIT_BYTES, l2_budget=2**62)
    assert ok == fits, why
    assert ok or " B of shared memory" in why


@pytest.mark.parametrize("backend", tops.BACKENDS)
def test_every_smoke_point_is_legal(backend):
    for geom in tlow.SMOKE_GEOMETRIES:
        assert tlow.compiled_geometry_ok(geom, backend) == (True, "")


def test_refused_full_points_are_the_wide_rank_ones():
    refused = {(b, g.label()) for b in tops.BACKENDS
               for g in tlow.FULL_GEOMETRIES
               if not tlow.compiled_geometry_ok(g, b)[0]}
    wide = tlow.FULL_GEOMETRIES[5].label()
    assert refused == {(b, wide) for b in (
        "pallas_fused", "pallas_fused_bf16", "pallas_fused_gather",
        "pallas_fused_gather_bf16")}


@pytest.mark.parametrize("backend", KERNEL_BACKENDS)
@pytest.mark.parametrize("change, match", [
    (dict(blk=30), "multiple of 4"),
    (dict(nmodes=6), "input modes"),
])
def test_illegal_geometry_is_a_failing_row(backend, change, match):
    geom = dataclasses.replace(tlow.SMOKE_GEOMETRIES[0], **change)
    res = tlow.lower_backend(backend, geom)
    assert not res.ok and not res.launchable and not res.sm90a
    assert match in res.error
    assert tlow.failed([res]) == []
    assert res.row()["lowered_ok"] is False


def test_ref_passes_on_step_a_alone():
    res = tlow.lower_backend("ref", tlow.SMOKE_GEOMETRIES[0])
    assert res.ok and not res.sm90a and res.plan is None
    assert tlow.launch_plan("ref", tlow.SMOKE_GEOMETRIES[0]) is None


@pytest.mark.parametrize("backend", KERNEL_BACKENDS)
def test_without_nvcc_a_kernel_point_fails_naming_nvcc(backend):
    if _has_nvcc():
        pytest.skip("nvcc is installed: the build runs")
    res = tlow.lower_backend(backend, tlow.SMOKE_GEOMETRIES[0])
    assert res.launchable and not res.ok and not res.sm90a
    assert "nvcc" in res.error
    assert res.plan is None


LAUNCHABLE = [(b, g) for g in tlow.FULL_GEOMETRIES for b in KERNEL_BACKENDS
              if tlow.compiled_geometry_ok(g, b)[0]]


@pytest.mark.parametrize("backend, geom", LAUNCHABLE,
                         ids=[f"{g.label()}-{b}" for b, g in LAUNCHABLE])
def test_launch_plan_matches_the_wrappers(backend, geom):
    plan = tlow.launch_plan(backend, geom)
    assert tlow.check_plan(plan, tk.SMEM_LIMIT_BYTES) == ""
    k, rpad = geom.nmodes - 1, tk.padded_rank(geom.rank)
    slabs = tp.rung_slabs(backend.replace("_bf16", ""), geom.rank)
    if backend in ("pallas_fused", "pallas_fused_tiled",
                   "pallas_fused_bf16"):
        assert plan.grid == (geom.num_tiles * slabs, 1)
    else:
        assert plan.grid == (geom.num_tiles, slabs)
    if backend == tops.STREAM_BACKEND:
        stages, mappers = tk.stream_ring(k, rpad, geom.blk, geom.tile_rows,
                                         geom.window_tiles())
        assert stages >= 1
        assert plan.smem == tk.gather_stream_smem_bytes(
            k, rpad, geom.blk, geom.tile_rows, geom.window_tiles(),
            stages=stages, mappers=mappers)
    elif backend in ("pallas_fused_gather", "pallas_fused_gather_bf16"):
        assert plan.smem == tk.gather_smem_bytes(k, rpad, geom.tile_rows)
        # bf16 at a wide slab: a lane per 8 columns (16-byte row loads).
        lanes = min(32, rpad // 8) if backend.endswith("_bf16") \
            and rpad >= tk.BF16_VEC_MIN_SLAB else tk._lanes(rpad)
        assert plan.block == tk._groups(geom.tile_rows) * lanes
    elif backend == "pallas":
        assert plan.smem == tk.segment_smem_bytes(rpad, geom.tile_rows)


def test_plan_over_the_limit_is_named():
    plan = tlow.LaunchPlan((4, 1), 256, tk.SMEM_LIMIT_BYTES + 1)
    assert "shared memory" in tlow.check_plan(plan, tk.SMEM_LIMIT_BYTES)
    assert "threads" in tlow.check_plan(tlow.LaunchPlan((4, 1), 2048, 0),
                                        tk.SMEM_LIMIT_BYTES)
    assert "grid" in tlow.check_plan(tlow.LaunchPlan((4, 70000), 32, 0),
                                     tk.SMEM_LIMIT_BYTES)


# A fixed sample in the format of ``nvcc -Xptxas -v`` (CUDA 12.8, the
# kernels' names as the card's build mangles them: an anonymous namespace
# named after the source): two instantiations of a template kernel, one
# of them spilling, and a kernel with static shared memory.
PTXAS_SAMPLE = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__16e657f1_16_gather_mttkrp_cu_d01103e820gather_mttkrp_kernelILi3EfEEvPKfPKiS4_S4_N13mttkrp_common9FactorSetIT0_EEPfiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__16e657f1_16_gather_mttkrp_cu_d01103e820gather_mttkrp_kernelILi3EfEEvPKfPKiS4_S4_N13mttkrp_common9FactorSetIT0_EEPfiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 440 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__16e657f1_16_gather_mttkrp_cu_d01103e820gather_mttkrp_kernelILi3E13__nv_bfloat16EEvPKfPKiS5_S5_N13mttkrp_common9FactorSetIT0_EEPfiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__16e657f1_16_gather_mttkrp_cu_d01103e820gather_mttkrp_kernelILi3E13__nv_bfloat16EEvPKfPKiS5_S5_N13mttkrp_common9FactorSetIT0_EEPfiiiiii
    24 bytes stack frame, 16 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 440 bytes cmem[0]
ptxas info    : Function properties for _ZN14mttkrp_common12add_productsEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__5a8d34c4_15_fused_mttkrp_cu_aaa3fcf425segment_accumulate_kernelEPKfPKiS3_Pfiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__5a8d34c4_15_fused_mttkrp_cu_aaa3fcf425segment_accumulate_kernelEPKfPKiS3_Pfiiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, 1024 bytes smem, 400 bytes cmem[0]
"""
G3 = "_ZN49_GLOBAL__N__16e657f1_16_gather_mttkrp_cu_d01103e820gather_mttkrp_kernelILi3EfEEvPKfPKiS4_S4_N13mttkrp_common9FactorSetIT0_EEPfiiiiii"
G3B = ("_ZN49_GLOBAL__N__16e657f1_16_gather_mttkrp_cu_d01103e820gather_mttkrp_"
       "kernelILi3E13__nv_bfloat16EEvPKfPKiS5_S5_N13mttkrp_common9FactorSetIT0_"
       "EEPfiiiiii")
SEG = "_ZN48_GLOBAL__N__5a8d34c4_15_fused_mttkrp_cu_aaa3fcf425segment_accumulate_kernelEPKfPKiS3_Pfiiiiiii"


def test_ptxas_report_parser():
    got = tlow.parse_ptxas_report(PTXAS_SAMPLE)
    assert set(got) == {G3, G3B, SEG}
    assert got[G3] == dict(arch="sm_90a", registers=40, static_smem=0,
                           stack=0, spill_stores=0, spill_loads=0)
    assert got[G3B] == dict(arch="sm_90a", registers=255, static_smem=0,
                            stack=24, spill_stores=16, spill_loads=8)
    assert got[SEG]["registers"] == 32 and got[SEG]["static_smem"] == 1024
    rows = tlow.kernel_resources({"gather_mttkrp": PTXAS_SAMPLE})
    assert {r["kernel"] for r in rows} == {G3, G3B, SEG}
    assert all(r["library"] == "gather_mttkrp" for r in rows)


def test_kernel_labels():
    assert tlow.kernel_label(G3) == "gather_mttkrp_kernel<3, float>"
    assert tlow.kernel_label(G3B) == "gather_mttkrp_kernel<3, bf16>"
    assert tlow.kernel_label(SEG) == "segment_accumulate_kernel"
    stream = ("_ZN56_GLOBAL__N__95db2e96_23_gather_stream_mttkrp_cu_f601c53c27"
              "gather_stream_mttkrp_kernelILi4EfEEvPKf")
    assert tlow.kernel_label(stream) == "gather_stream_mttkrp_kernel<4, float>"
    assert tlow.kernel_label("_Z3foov") == "_Z3foov"


def test_instantiation_of_a_backend():
    assert tlow._instantiation("gather_mttkrp_kernel", 3, 4, G3)
    assert not tlow._instantiation("gather_mttkrp_kernel", 3, 2, G3)
    assert tlow._instantiation("gather_mttkrp_kernel", 3, 2, G3B)
    assert not tlow._instantiation("gather_mttkrp_kernel", 2, 4, G3)
    assert not tlow._instantiation("gather_stream_mttkrp_kernel", 3, 4, G3)
    assert tlow._instantiation("segment_accumulate_kernel", 3, 4, SEG)


def _fake_build(monkeypatch, tmp_path, *, drop_k=None):
    """``build.build()`` answering with a report of every kernel
    instantiation (less ``drop_k`` input modes) and libraries that export
    every launch function; nothing is compiled."""
    names = {"gather_mttkrp": ["gather_mttkrp_kernel",
                               "gather_mttkrp_vec_kernel",
                               "gather_mttkrp_narrow_kernel"],
             "gather_stream_mttkrp": ["gather_stream_mttkrp_kernel"],
             "fused_mttkrp": ["fused_mttkrp_kernel",
                              "segment_accumulate_kernel"]}
    built = {}
    for lib, kernels in names.items():
        lines = []
        for kern in kernels:
            for k in range(1, tk.MAX_IN_MODES + 1):
                if k == drop_k:
                    continue
                for elem in ("f", "13__nv_bfloat16"):
                    name = f"_Z{len(kern)}{kern}ILi{k}E{elem}EEvPKf"
                    if kern == "segment_accumulate_kernel":
                        name = f"_Z{len(kern)}{kern}PKf"
                    lines += [f"ptxas info    : Compiling entry function "
                              f"'{name}' for 'sm_90a'",
                              f"ptxas info    : Function properties for "
                              f"{name}",
                              "    0 bytes stack frame, 0 bytes spill "
                              "stores, 0 bytes spill loads",
                              "ptxas info    : Used 64 registers, 400 bytes "
                              "cmem[0]"]
        built[lib] = (tmp_path / f"{lib}.so", "\n".join(lines))
    monkeypatch.setattr(tlow._build, "build", lambda: built)
    exports = {fn for fns in tbuild._LAUNCH_ARGTYPES.values() for fn in fns}
    monkeypatch.setattr(tlow.ctypes, "CDLL", lambda path: types.SimpleNamespace(
        **{fn: object() for fn in exports}))


def test_bf16_wide_slab_points_check_the_vec_kernel(monkeypatch, tmp_path):
    """B1 on bf16 factors at a slab of BF16_VEC_MIN_SLAB or more launches
    gather_mttkrp_vec_kernel: that point is checked against its ptxas
    entry (a build without it fails there, not at a narrow slab)."""
    _fake_build(monkeypatch, tmp_path)
    lib, report = tlow._build.build()["gather_mttkrp"]
    kept = "\n".join(line for line in report.splitlines()
                     if "gather_mttkrp_vec_kernel" not in line)
    built = dict(tlow._build.build(), gather_mttkrp=(lib, kept))
    monkeypatch.setattr(tlow._build, "build", lambda: built)
    wide, narrow = tlow.Geometry(nmodes=3, rank=128, blk=128, tile_rows=8,
                                 factor_rows=64), \
        tlow.Geometry(nmodes=3, rank=16, blk=128, tile_rows=8,
                      factor_rows=64)
    res = tlow.lower_backend("pallas_fused_gather_bf16", wide)
    assert not res.ok and "gather_mttkrp_vec_kernel" in res.error
    assert tlow.lower_backend("pallas_fused_gather_bf16", narrow).ok
    assert tlow.lower_backend("pallas_fused_gather", wide).ok
    assert tlow.kernel_label(
        "_Z24gather_mttkrp_vec_kernelILi2E13__nv_bfloat16EEvPKf") \
        == "gather_mttkrp_vec_kernel<2, bf16>"


def test_cli_exit_codes(monkeypatch, tmp_path, capsys):
    if not _has_nvcc():
        assert tlow.main([]) == 1
        assert "FAIL" in capsys.readouterr().out
    _fake_build(monkeypatch, tmp_path)
    assert tlow.main(["--full"]) == 0
    out = capsys.readouterr().out
    assert "59/63" in out and "4 refused" in out and "0 failed" in out
    assert out.count("n/a ") == 4 and "FAIL" not in out
    _fake_build(monkeypatch, tmp_path, drop_k=3)
    assert tlow.main([]) == 1
    assert "ptxas compiled no" in capsys.readouterr().out


def test_rows_carry_the_ptxas_resources(monkeypatch, tmp_path):
    _fake_build(monkeypatch, tmp_path)
    res = tlow.lower_backend("pallas_fused_gather", tlow.SMOKE_GEOMETRIES[0])
    assert res.ok and res.sm90a and res.registers == 64
    assert res.spill_bytes == 0 and res.static_smem == 0
    row = res.row()
    assert row["grid"] == [4, 1] and row["smem"] == res.plan.smem


@pytest.mark.parametrize("backend", ["pallas_fused_gather_tiled",
                                     "pallas_fused_tiled"])
@pytest.mark.parametrize("rank", [16, 128, 129, 200, 256, 300, 512])
def test_rung_slabs_count_the_slabs_the_mode_step_runs(backend, rank):
    """``planner.rung_slabs`` for B2/B4 at a rank whose 16-padded width is
    not a multiple of ``RANK_SLAB``: ``mttkrp_device_step`` pads the rank
    to whole slabs (R=200 runs 256 columns, two slabs); the planner
    counted one (208 // 128). Found by the lowering tier's launch plans."""
    slab = tops.tiled_rank_slab(rank)
    runs = tk.padded_rank(rank, slab) // slab
    assert tp.rung_slabs(backend, rank) == runs
    geom = tlow.Geometry(nmodes=3, rank=rank, blk=128, tile_rows=8)
    assert tlow.launch_plan(backend, geom).grid[
        0 if backend == "pallas_fused_tiled" else 1] % runs == 0


def test_build_keeps_the_ptxas_report_beside_the_library(monkeypatch,
                                                         tmp_path):
    """A cached library answers with the report of the build that made it
    (a stand-in compiler writes an empty library and one ptxas line)."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nout=""\nwhile [ $# -gt 0 ]; do\n'
                    '  [ "$1" = "-o" ] && out="$2"\n  shift\ndone\n'
                    ': > "$out"\necho "ptxas info    : Used 7 registers"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(tbuild, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "kernels")
    first = tbuild.build()
    monkeypatch.setattr(tbuild, "nvcc_path", lambda: pytest.fail(
        "a cached library was built again"))
    second = tbuild.build()
    assert set(first) == set(tbuild.SOURCES)
    for name, (path, report) in first.items():
        assert "Used 7 registers" in report
        assert second[name] == (path, report)
        assert path.with_suffix(".ptxas.txt").read_text() == report
