"""The last tile's walk cut at its last live block (S1), and the narrow
bf16 gather kernel's geometry.

CPU-only: the tile starts B1, B2 and B6 get (``kernel._cut_tile_starts``)
and the plain live end (``kernel.live_end_plain``, what
``live_end_kernel`` in ``csrc/mttkrp_common.cuh`` writes on the card) held
exactly against a numpy reckoning on the aligned streams of every ordering
at several ``blk`` / ``tile_rows``, with padding blocks inside runs; the
narrow kernel's shared memory against the layout
``csrc/gather_mttkrp.cu`` describes; the residency ladder's choices at the
default budgets over the tested geometries; the compile-validation tier's
plan for the narrow kernel. The kernels run in ``tests/test_torch_gpu.py``.
"""
import itertools
import re
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.mttkrp import build as tbuild  # noqa: E402
from repro_torch.kernels.mttkrp import kernel as tk  # noqa: E402
from repro_torch.kernels.mttkrp import lowering as tlow  # noqa: E402
from repro_torch.kernels.mttkrp import ops as tops  # noqa: E402
from repro_torch.oocore import planner  # noqa: E402
from repro_torch.reorder import ORDERINGS  # noqa: E402

CSRC = Path(tk.__file__).resolve().parent / "csrc"


def _cu_int(name: str) -> int:
    text = (CSRC / "gather_mttkrp.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _numpy_cut(vals, tob, num_tiles: int, blk: int):
    """``(starts, live_end)`` by numpy: each tile's first block, the end of
    the last run, and one past the last block of the last tile's run that
    holds a nonzero (0 when none does)."""
    tob = np.asarray(tob)
    starts = np.array([np.searchsorted(tob, t, side="left")
                       for t in range(num_tiles + 1)])
    b0, b1 = starts[-2], starts[-1]
    run = np.asarray(vals)[b0 * blk:b1 * blk].reshape(-1, blk)
    live = np.flatnonzero((run != 0).any(1))
    return starts, (b0 + live[-1] + 1 if live.size else 0)


def _stream(rng, cap, rows, frows, invalid):
    idx = np.stack([np.sort(rng.integers(0, rows, cap))]
                   + [rng.integers(0, f, cap) for f in frows], 1)
    val = rng.standard_normal(cap).astype(np.float32)
    val[rng.random(cap) < 0.1] = 0.0          # explicit zeros inside runs
    valid = np.arange(cap) < cap - invalid
    return (torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(val),
            torch.from_numpy(valid))


@pytest.mark.parametrize("ordering", ORDERINGS)
@pytest.mark.parametrize("blk,tile_rows", [(4, 8), (64, 8), (16, 2),
                                           (128, 16), (8, 1)])
def test_cut_equals_numpy_on_aligned_streams(ordering, blk, tile_rows):
    """On the aligned stream of every ordering the tile starts are
    searchsorted's, element 0 is 0 until the launch writes the live end,
    and the plain live end (and ``live_tile_starts`` on the CPU) equals
    numpy's. Zeroing the run's tail after a chosen slot, and whole blocks
    inside the run, moves it exactly as numpy says."""
    rng = np.random.default_rng(blk * 7 + tile_rows)
    rows = 24 * tile_rows
    idx, val, valid = _stream(rng, 3000, rows, (90, 70), invalid=11)
    factors = [torch.zeros(rows, 16), torch.randn(90, 16),
               torch.randn(70, 16)]
    vals, _, _, _, tob = tops.gather_operands(
        idx, val, valid, factors, mode=0, rows_cap=rows, row_offset=0,
        blk=blk, tile_rows=tile_rows, slab=16, ordering=ordering)
    num_tiles = rows // tile_rows
    kw = dict(rows_cap=rows, blk=blk, tile_rows=tile_rows)
    cut = tk._cut_tile_starts(tob, num_tiles)
    starts, _ = _numpy_cut(vals.numpy(), tob.numpy(), num_tiles, blk)
    assert cut.dtype == torch.int32 and cut.shape == (num_tiles + 2,)
    assert int(cut[0]) == 0
    assert cut[1:].tolist() == starts.tolist()
    assert torch.equal(cut[1:], tk._tile_starts(tob, num_tiles))
    # Not cut (for measurement): element 0 is the stream's block count,
    # which no live end lowers, so the last tile walks its whole run.
    uncut = tk._cut_tile_starts(tob, num_tiles, cut=False)
    assert int(uncut[0]) == tob.numel() and torch.equal(uncut[1:], cut[1:])
    b0, b1 = int(starts[-2]), int(starts[-1])
    # The aligned stream's clipped blocks: the cut is below the run's end.
    assert b1 - b0 > 1
    variants = [vals]
    for tail in (0, 1, blk - 1, blk, 3 * blk + 1):
        v = vals.clone()
        v[b0 * blk + tail:] = 0.0
        variants.append(v)
    v = vals.clone()
    v[b0 * blk:(b0 + 2) * blk] = 0.0          # padding blocks inside runs
    v[(b0 + 3) * blk:(b0 + 5) * blk] = 0.0
    variants.append(v)
    for v in variants:
        _, want = _numpy_cut(v.numpy(), tob.numpy(), num_tiles, blk)
        assert tk.live_end_plain(v, tob, **kw) == want
        got = tk.live_tile_starts(v, tob, **kw)
        assert int(got[0]) == want and got[1:].tolist() == starts.tolist()
        # The walk [b0, max(b0, cut)) never drops a live slot.
        live = np.flatnonzero(v.numpy()[b0 * blk:b1 * blk])
        end = (max(b0, want) - b0) * blk
        assert live.size == 0 or live[-1] < end <= live[-1] + blk


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("slab", [16, 32, 48])
@pytest.mark.parametrize("tile_rows", [1, 8, 16, 128])
def test_narrow_gather_smem_bytes_equal_the_cu_layout(k, slab, tile_rows):
    """bf16 B1/B2 below BF16_VEC_MIN_SLAB (gather_mttkrp_narrow_kernel):
    groups x tile_rows group rows of slab floats (the rows are swizzled,
    not padded) and nothing else: the rows in flight are held in
    registers (two batches of kNarrowUnroll / K slots) and the stream is
    read into registers, not staged; the float32 count is unchanged."""
    text = (CSRC / "gather_mttkrp.cu").read_text()
    assert _cu_int("kNarrowUnroll") == tk.NARROW_UNROLL
    assert "const int part_floats = tile_rows * groups * slab;" in text
    assert "const size_t partials = (size_t)groups * tile_rows * slab * " \
        "sizeof(float);" in text
    assert "return LAUNCH(gather_mttkrp_narrow_kernel, partials);" in text
    want = 4 * tk._groups(tile_rows) * tile_rows * slab
    for rank, rank_slab in ((slab, None), (2 * slab, slab)):
        got = tk.gather_smem_bytes(k, rank, tile_rows, rank_slab=rank_slab,
                                   gather_itemsize=2)
        assert got == want
        assert got < tk.gather_smem_bytes(k, rank, tile_rows,
                                          rank_slab=rank_slab)
    # 16-byte partial rows: every group row starts on 16 bytes.
    assert slab % 4 == 0
    assert tk._gather_lanes(slab, 2) * 8 == slab


def _swizzle(g, lanes):
    """narrow_swizzle in gather_mttkrp.cu."""
    return (g >> 1) & 1 if lanes == 2 else g & 1 if lanes == 4 else 0


@pytest.mark.parametrize("slab", [16, 32])
def test_narrow_partial_rows_spread_a_phase_over_the_banks(slab):
    """The 8 lanes one shared-memory phase serves for a 16-byte add (4
    groups of 2 lanes at slab 16, 2 of 4 at slab 32) touch 8 distinct
    groups of 4 banks, whatever each group's row: the row stride is
    groups x slab, a multiple of 32 floats, group g's row starts g x slab
    floats in, and a lane's two float4s sit in the halves
    narrow_swizzle(g) and 1 - narrow_swizzle(g) of it. The swizzle is
    undone by the reduction's column map (each column once per group)."""
    text = (CSRC / "gather_mttkrp.cu").read_text()
    assert "return lanes == 2 ? (g >> 1) & 1 : lanes == 4 ? g & 1 : 0;" \
        in text
    rowf, lanes, groups = slab, slab // 8, 16
    assert (groups * rowf) % 32 == 0
    for half in (0, 1):                       # the lane's two float4s
        for first in range(0, 32, 8):         # thread of the phase's start
            quads = set()
            for thread in range(first, first + 8):
                g, lane = divmod(thread, lanes)
                q = (half ^ _swizzle(g, lanes)) * lanes + lane
                quads.add((g * rowf + 4 * q) // 4 % 8)
            assert len(quads) == 8
    for g in range(groups):
        cols = sorted(((c // 4 % 2) ^ _swizzle(g, lanes)) * lanes * 4
                      + c // 8 * 4 + c % 4 for c in range(slab))
        assert cols == list(range(slab))


# Geometries the tests hold the ladder's choices at (test_torch_dispatch,
# test_torch_bf16, chip_smoke's [auto] grid and the nell-2 stand-in).
LADDER_GEOMETRIES = list(itertools.product(
    (3, 4), (16, 32, 48, 256, 1024), (64, 128, 512), (8, 16),
    (None, (50, 60), (4000, 4000), (12104, 28800), 40_000,
     (2_000_000, 3_000_000))))


def _fp32_gather_count(k, rank_padded, tile_rows, rank_slab=None,
                       gather_itemsize=4):
    """gather_smem_bytes before the narrow kernel: the float32 count at
    either itemsize."""
    return _REAL_COUNT(k, rank_padded, tile_rows, rank_slab=rank_slab)


_REAL_COUNT = tk.gather_smem_bytes


@pytest.mark.parametrize("gi", [4, 2])
def test_ladder_choices_unchanged_by_the_narrow_count(monkeypatch, gi):
    """At the default budgets the rung the ladder takes on every tested
    geometry is the one it took when it asked the float32 count of a
    bf16 gather CTA; the narrow kernel's smaller count moves no choice.
    (Only a budget between the two counts could, toward B1.)"""
    def plans():
        out = {}
        for nmodes, rank, blk, tr, frows in LADDER_GEOMETRIES:
            if isinstance(frows, tuple) and len(frows) != nmodes - 1:
                frows = sum(frows)
            out[(nmodes, rank, blk, tr, frows)] = planner.plan_residency(
                nmodes=nmodes, rank=rank, blk=blk, tile_rows=tr,
                factor_rows=frows, gather_itemsize=gi).backend
        return out
    now = plans()
    monkeypatch.setattr(tk, "gather_smem_bytes", _fp32_gather_count)
    assert plans() == now
    if gi == 2:
        # The nell-2 stand-in's bf16 main path: B1 at R=16.
        assert now[(3, 16, 512, 8, 40_000)] == "pallas_fused_gather"


def test_lowering_plans_and_checks_the_narrow_kernel(monkeypatch, tmp_path):
    """B1 on bf16 factors at a narrow slab launches
    gather_mttkrp_narrow_kernel: the launch plan gives it slab / 8 lanes a
    group and its own shared memory, and that point is checked against
    the kernel's ptxas entry (a build without it fails naming it, and the
    float32 and wide-slab points do not)."""
    geom = tlow.Geometry(nmodes=3, rank=16, blk=128, tile_rows=8,
                         factor_rows=64)
    plan = tlow.launch_plan("pallas_fused_gather_bf16", geom)
    assert plan.block == tk._groups(8) * 2
    assert plan.smem == tk.gather_smem_bytes(2, 16, 8, gather_itemsize=2)
    assert plan.smem < tlow.launch_plan("pallas_fused_gather", geom).smem
    names = ("gather_mttkrp_kernel", "gather_mttkrp_vec_kernel")
    lines = []
    for kern, k, elem in itertools.product(names, range(1, 5),
                                           ("f", "13__nv_bfloat16")):
        name = f"_Z{len(kern)}{kern}ILi{k}E{elem}EEvPKf"
        lines += [f"ptxas info    : Compiling entry function '{name}' for "
                  "'sm_90a'", f"ptxas info    : Function properties for "
                  f"{name}", "    0 bytes stack frame, 0 bytes spill "
                  "stores, 0 bytes spill loads",
                  "ptxas info    : Used 64 registers, 400 bytes cmem[0]"]
    built = {"gather_mttkrp": (tmp_path / "gather_mttkrp.so",
                               "\n".join(lines))}
    monkeypatch.setattr(tlow._build, "build", lambda: built)
    exports = {fn for fns in tbuild._LAUNCH_ARGTYPES.values() for fn in fns}
    monkeypatch.setattr(tlow.ctypes, "CDLL", lambda path:
                        types.SimpleNamespace(**{fn: object()
                                                 for fn in exports}))
    res = tlow.lower_backend("pallas_fused_gather_bf16", geom)
    assert not res.ok and "gather_mttkrp_narrow_kernel" in res.error
    assert tlow.lower_backend("pallas_fused_gather", geom).ok
    wide = tlow.Geometry(nmodes=3, rank=128, blk=128, tile_rows=8,
                         factor_rows=64)
    assert tlow.lower_backend("pallas_fused_gather_bf16", wide).ok
    assert tlow.kernel_label(
        "_Z27gather_mttkrp_narrow_kernelILi2E13__nv_bfloat16EEvPKf") \
        == "gather_mttkrp_narrow_kernel<2, bf16>"
    assert "gather_mttkrp_live_end_launch" in exports
    # The first bf16 kernel, the yardstick chip_smoke.py times, is built
    # from bench_torch/gather_mttkrp_designs.cu, not exported by the port.
    assert "gather_mttkrp_bf16_column_launch" not in exports


def _ablation():
    """``bench_torch/kernel_ablation.py`` as a module (it imports the port
    and defines its variants; nothing is built on import)."""
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "bench_torch" \
        / "kernel_ablation.py"
    spec = importlib.util.spec_from_file_location("kernel_ablation", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ABLATION = _ablation()


@pytest.mark.parametrize("name", sorted(ABLATION.VARIANTS))
def test_ablation_edits_apply_once(name):
    """Every variant's text edits still apply, each to exactly one place of
    its source (the port's, or a design kept as source text under
    bench_torch/), so the ablation builds what its name says. The narrow
    kernel's alternatives edit bench_torch/gather_mttkrp_designs.cu; the
    port's source holds none of their switches."""
    lib, src, pairs, *hdr = ABLATION.VARIANTS[name]
    text = ABLATION.edit(src, pairs)
    assert '#include "mttkrp_common.cuh"' in text
    ABLATION.edit("mttkrp_common.cuh", hdr[0] if hdr else [])
    port = (CSRC / "gather_mttkrp.cu").read_text()
    if any("kNarrow" in old and "kNarrowUnroll" not in old
           for old, _ in pairs):
        assert src == ABLATION.DESIGNS
    for switch in ("kNarrowStaged", "kNarrowRing", "kNarrowSwizzle",
                   "kNarrowPipelined", "kNarrowCarveout", "kColumn"):
        assert switch not in port
