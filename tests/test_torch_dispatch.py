"""The port's residency ladder: what ``auto`` resolves to.

``oocore.planner.plan_residency`` and ``ops.select_backend`` are static
arithmetic on the kernels' shared-memory counts and the factors' L2
bytes (no card needed). The ladder is the reference's rung order with
Hopper budgets; these tests hold its rules: first fit wins, monotone in
both budgets, the gather rungs need the factor sizes, explicit names pass
through (the bf16 names too, which fold into ``gather_itemsize=2`` in the
planner, as in the reference), ``auto`` never yields a bf16 name.
"""
import itertools

import pytest

pytest.importorskip("torch")

from repro.kernels.mttkrp import ops as jops  # noqa: E402
from repro.oocore import planner as jplanner  # noqa: E402
from repro_torch.kernels.mttkrp import kernel as tk  # noqa: E402
from repro_torch.kernels.mttkrp import ops as tops  # noqa: E402
from repro_torch.oocore import planner  # noqa: E402

LADDER = planner.LADDER
# nell-2 (FROSTT, paper Table II) at D=1: each mode's padded rows, and the
# input modes' rows for each output mode.
NELL2_IPAD = (12104, 9200, 28800)
NELL2_INPUT_ROWS = tuple(
    tuple(r for w, r in enumerate(NELL2_IPAD) if w != n) for n in range(3))
RANKS = (1, 16, 48, 128, 256, 416, 512, 1024)
BLKS = (32, 64, 128, 512)
FACTOR_ROWS = (None, (50, 60), (4000, 4000), (12104, 28800), 40_000,
               (2_000_000, 3_000_000))
SMEM_BUDGETS = (0, 20_000, 40_000, 60_000, 100_000, 160_000,
                tk.SMEM_LIMIT_BYTES, 10**9)
L2_BUDGETS = (0, 10**5, 10**6, 10**7, tk.L2_BUDGET_BYTES, 10**8, 10**10)


def _rung(**kw):
    return LADDER.index(planner.plan_residency(**kw).backend)


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("factor_rows", FACTOR_ROWS, ids=str)
def test_monotone_in_both_budgets(rank, factor_rows):
    """A larger smem_budget or l2_budget never moves the choice down the
    ladder."""
    for blk in BLKS:
        kw = dict(nmodes=3, rank=rank, blk=blk, tile_rows=8,
                  factor_rows=factor_rows)
        grid = {(s, l2): _rung(smem_budget=s, l2_budget=l2, **kw)
                for s, l2 in itertools.product(SMEM_BUDGETS, L2_BUDGETS)}
        for (s, l2), r in grid.items():
            for s2 in SMEM_BUDGETS:
                if s2 >= s:
                    assert grid[(s2, l2)] <= r, (blk, s, s2, l2)
            for l2b in L2_BUDGETS:
                if l2b >= l2:
                    assert grid[(s, l2b)] <= r, (blk, s, l2, l2b)


# One configuration per rung: (rank, blk, factor_rows, budgets).
RUNG_CASES = {
    "pallas_fused_gather": (16, 512, (12104, 28800), {}),
    "pallas_fused_gather_tiled": (256, 512, (9200, 28800), {}),
    "pallas_fused_gather_stream": (16, 64, (2_000_000, 3_000_000), {}),
    "pallas_fused": (16, 512, (2_000_000, 3_000_000), {}),
    "pallas_fused_tiled": (512, 512, (2_000_000, 3_000_000), {}),
    "pallas": (16, 512, None, {"smem_budget": 20_000}),
}


@pytest.mark.parametrize("backend", LADDER)
def test_each_rung_is_reached(backend):
    rank, blk, frows, budgets = RUNG_CASES[backend]
    plan = planner.plan_residency(nmodes=3, rank=rank, blk=blk, tile_rows=8,
                                  factor_rows=frows, **budgets)
    assert plan.backend == backend
    assert plan.fits
    assert tops.select_backend("auto", nmodes=3, rank=rank, blk=blk,
                               tile_rows=8, factor_rows=frows,
                               **budgets) == backend
    if backend in LADDER[:3]:
        assert len(plan.factors) == 2
        covered = [sum(b - a for a, b in f.tile_spans()) for f in plan.factors]
        assert covered == list(frows)
    else:
        assert plan.factors == ()


def test_plan_records_the_choice():
    plan = planner.plan_residency(nmodes=3, rank=256, blk=512, tile_rows=8,
                                  factor_rows=(9200, 28800))
    assert plan.backend == "pallas_fused_gather_tiled"
    assert plan.rank_slabs == 2
    assert plan.l2_bytes == (9200 + 28800) * 128 * 4 <= plan.l2_budget
    assert plan.smem_bytes == tk.gather_smem_bytes(2, 256, 8, rank_slab=128)
    assert [f.policy for f in plan.factors] == ["slab", "slab"]
    stream = planner.plan_residency(nmodes=3, rank=16, blk=64, tile_rows=8,
                                    factor_rows=(2_000_000, 3_000_000))
    assert stream.streams and stream.window_tiles == (64, 64)
    assert stream.smem_bytes == tk.gather_stream_smem_bytes(2, 16, 64, 8,
                                                            (64, 64))
    assert [f.policy for f in stream.factors] == ["stream", "stream"]


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("blk", BLKS)
def test_factor_rows_none_skips_the_gather_rungs(rank, blk):
    plan = planner.plan_residency(nmodes=3, rank=rank, blk=blk, tile_rows=8)
    assert plan.backend in LADDER[3:]
    for budgets in ({}, {"l2_budget": 10**12}):
        assert tops.select_backend("auto", nmodes=3, rank=rank, blk=blk,
                                   tile_rows=8, **budgets) in LADDER[3:]
    for b in LADDER[:3]:
        assert not planner.backend_fits(b, nmodes=3, rank=rank, blk=blk,
                                        tile_rows=8)


@pytest.mark.parametrize("backend", tops.BACKENDS)
def test_explicit_names_pass_through(backend):
    for budgets in ({}, {"smem_budget": 0, "l2_budget": 0}):
        assert tops.select_backend(backend, nmodes=3, rank=16,
                                   factor_rows=None, **budgets) == backend


@pytest.mark.parametrize("backend", ["pallas_fused_bf16",
                                     "pallas_fused_gather_bf16"])
def test_bf16_names_are_not_ported(backend):
    """The bf16 names are the reference's and the port's: they pass
    through ``select_backend``, stay out of ``AUTO_BACKENDS``, and the
    planner sizes them at 2 bytes per factor element, equal to its base
    rung at ``gather_itemsize=2``, in the port as in the reference."""
    assert backend in jops.BACKENDS and backend in tops.BACKENDS
    assert backend not in tops.AUTO_BACKENDS
    assert tops.select_backend(backend, nmodes=3, rank=16) == backend
    base = backend[:-len("_bf16")]
    for rank, frows in itertools.product((16, 256, 1024), FACTOR_ROWS):
        for s, l2 in itertools.product(SMEM_BUDGETS, L2_BUDGETS):
            kw = dict(nmodes=3, rank=rank, blk=512, tile_rows=8,
                      factor_rows=frows, smem_budget=s, l2_budget=l2)
            assert planner.backend_fits(backend, **kw) \
                == planner.backend_fits(base, gather_itemsize=2, **kw)
        jkw = dict(nmodes=3, rank=rank, blk=512, tile_rows=128,
                   factor_rows=frows)
        assert jops.select_backend(backend, nmodes=3, rank=rank) == backend
        assert jplanner.backend_fits(backend, **jkw) \
            == jplanner.backend_fits(base, gather_itemsize=2, **jkw)


@pytest.mark.parametrize("backend", ["nope", "segsum", "AUTO"])
def test_unknown_names_raise_value_error(backend):
    with pytest.raises(ValueError):
        tops.select_backend(backend, nmodes=3, rank=16)


class _Table:
    """A duck-typed calibration table that always answers ``choice``."""

    def __init__(self, choice):
        self.choice = choice

    def best_backend(self, *, allowed, **kw):
        assert tuple(allowed) == tops.AUTO_BACKENDS
        return self.choice


def test_table_path_answers_where_the_ladder_accepts():
    """A table's answer is taken where the residency planner accepts it
    (counted ``source=table``); an answer it rejects, or none, falls
    through to the static ladder; explicit names ignore the table."""
    from repro_torch.obs import counters as ocnt
    kw = dict(nmodes=3, rank=16, blk=512, tile_rows=8,
              factor_rows=NELL2_INPUT_ROWS[0])
    with ocnt.use_registry() as reg:
        assert tops.select_backend("auto", table=_Table("pallas"),
                                   **kw) == "pallas"
        # B1 with no factor sizes cannot be certified: static (B3).
        nofit = dict(kw, factor_rows=None)
        assert tops.select_backend("auto", table=_Table(
            "pallas_fused_gather"), **nofit) == "pallas_fused"
        assert tops.select_backend("auto", table=_Table(None),
                                   **kw) == "pallas_fused_gather"
        assert tops.select_backend("pallas_fused_tiled",
                                   table=_Table("pallas"),
                                   **kw) == "pallas_fused_tiled"
    assert reg.snapshot() == {
        "dispatch.backend{backend=pallas,source=table}": 1,
        "dispatch.backend{backend=pallas_fused,source=static}": 1,
        "dispatch.backend{backend=pallas_fused_gather,source=static}": 1,
        "dispatch.backend{backend=pallas_fused_tiled,source=explicit}": 1,
        "planner.l2.plan_bytes{backend=pallas_fused}": 0,
        "planner.l2.plan_bytes{backend=pallas_fused_gather}":
            sum(NELL2_INPUT_ROWS[0]) * 16 * 4,
        "planner.plans": 2,
        "planner.smem.plan_bytes{backend=pallas_fused}":
            tk.fused_smem_bytes(2, 16, 8),
        "planner.smem.plan_bytes{backend=pallas_fused_gather}":
            tk.gather_smem_bytes(2, 16, 8),
    }


def test_auto_never_yields_bf16_and_stays_in_the_reference_set():
    assert set(tops.AUTO_BACKENDS) == set(jops.AUTO_BACKENDS)
    seen = set()
    for rank, blk, frows, s, l2 in itertools.product(
            RANKS, BLKS, FACTOR_ROWS, SMEM_BUDGETS, L2_BUDGETS):
        b = tops.select_backend("auto", nmodes=4, rank=rank, blk=blk,
                                tile_rows=8, smem_budget=s, l2_budget=l2,
                                factor_rows=None if frows is None else
                                (frows if isinstance(frows, int) else
                                 frows + (100,)))
        assert not b.endswith("_bf16")
        seen.add(b)
    assert seen == set(LADDER)


@pytest.mark.parametrize("rank,want", [
    (16, ("pallas_fused_gather",) * 3),
    (256, ("pallas_fused_gather_tiled", "pallas_fused_gather_tiled",
           "pallas_fused_gather")),
])
@pytest.mark.parametrize("blk", [64, 512])
def test_nell2_resolutions(rank, want, blk):
    """The nell-2 stand-in at the default budgets: B1 everywhere at R=16
    (factors <= 2.6 MB); at R=256, B2 for modes 0 and 1 (38,000 and
    40,904 input rows; one 128-column slab <= 20 MiB) and B1 for mode 2
    (21,304 rows, 20.8 MiB)."""
    got = tuple(tops.select_backend("auto", nmodes=3, rank=rank, blk=blk,
                                    tile_rows=8, factor_rows=frows)
                for frows in NELL2_INPUT_ROWS)
    assert got == want


def test_predicates_delegate_to_the_ladder():
    assert tops.gather_fits(3, 16, 512, 8, (12104, 28800))
    assert not tops.gather_fits(3, 256, 512, 8, (9200, 28800))
    assert tops.gather_fits(3, 256, 512, 8, (9200, 28800), tiled=True)
    assert tops.fused_fits_smem(3, 256, 512, 8)
    assert not tops.fused_fits_smem(3, 512, 512, 8)
    assert tops.fused_fits_smem(3, 512, 512, 8, tiled=True)
    assert tops.gather_stream_fits_smem(3, 16, 64, 8, (10**6, 10**6))
    assert not tops.gather_stream_fits_smem(3, 16, 512, 8, (10**6, 10**6))
    for b in ("ref", "segsum", "pallas"):
        assert planner.backend_fits(b, nmodes=3, rank=4096, blk=512,
                                    tile_rows=8, smem_budget=0, l2_budget=0)
