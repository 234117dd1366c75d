"""Geometry of the redesigned gather (B1, B2), stream (B6) and fused (B3,
B4) kernels.

CPU-only arithmetic: the stream kernel's ring (stages and mapper warps)
and the fused kernels' ring (stages and slots per stage) against the
shared-memory budget, the shared-memory byte counts against the layouts
that ``csrc/gather_mttkrp.cu``, ``csrc/gather_stream_mttkrp.cu`` and
``csrc/fused_mttkrp.cu`` describe, the fused kernels' partition of a run
into ring stages, the residency ladder's choices, and the wrappers'
alignment check for the kernels' 16-byte and bulk copies. The kernels
themselves run in ``tests/test_torch_gpu.py``.
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.mttkrp import kernel as tk  # noqa: E402
from repro_torch.oocore import planner  # noqa: E402

CSRC = Path(tk.__file__).resolve().parent / "csrc"
# (K, padded rank, blk, windows) of every B6 launch chip_smoke.py makes:
# the random streams (blk 128) and the nell-2 stand-in (blk 64, Morton,
# and at blk 128 and frow_tile 4 / 2).
SMOKE_STREAMS = [
    (2, 16, 128, (128, 128)), (2, 64, 128, (128, 128)),
    (3, 16, 128, (127, 128, 128)), (3, 64, 128, (128, 128, 128)),
    (2, 16, 64, (64, 61)), (2, 16, 64, (64, 62)), (2, 16, 64, (60, 62)),
    (2, 16, 128, (122, 112)), (2, 16, 128, (121, 112)),
    (2, 16, 128, (96, 112)), (2, 16, 64, (64, 64)),
]
BUDGETS = [60_000, 100_000, 150_000, 200_000, tk.SMEM_LIMIT_BYTES,
           400_000, 10**6]


def _round4(n):
    return (n + 3) // 4 * 4


def _stream_layout(k, rank, blk, tile_rows, windows, frow, slab, stages,
                   mappers, itemsize=4):
    """The byte count the .cu note lays out, summed independently
    (``itemsize``: bytes of a factor element, 4 or 2 for bf16)."""
    slab = min(rank, slab)
    groups = tk._groups(tile_rows)
    wsum = sum(windows)
    partials = groups * tile_rows * slab * 4
    window = wsum * frow * slab * itemsize
    slot = ((2 + k) * blk + _round4(wsum) + _round4(wsum + 1)) * 4
    slots = stages + mappers + 1
    barriers = 8 * (2 * stages + 3 * slots)
    return partials + stages * window + slots * slot + barriers


def _cu_int(source, name):
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("k,rank,blk,windows", SMOKE_STREAMS)
@pytest.mark.parametrize("stages", [1, 2, 3])
@pytest.mark.parametrize("mappers", [1, 4, 8])
def test_stream_smem_bytes_equal_the_cu_layout(k, rank, blk, windows,
                                               stages, mappers):
    assert tk.gather_stream_smem_bytes(
        k, rank, blk, 8, windows, stages=stages, mappers=mappers) \
        == _stream_layout(k, rank, blk, 8, windows, tk.FACTOR_ROW_TILE,
                          tk.STREAM_RANK_SLAB, stages, mappers)


def test_stream_cu_layout_matches_the_formula():
    """The .cu computes the same slot and slot count the wrapper does."""
    text = (CSRC / "gather_stream_mttkrp.cu").read_text()
    assert "return (2 + k) * blk + round4(wsum) + round4(wsum + 1);" in text
    assert "return stages + mappers + 1;" in text
    assert "(2 * (size_t)stages + 3 * (size_t)meta_slots(stages, mappers))" \
        in text


@pytest.mark.parametrize("k,rank,blk,windows", SMOKE_STREAMS)
@pytest.mark.parametrize("stages", [1, 3, 5])
@pytest.mark.parametrize("mappers", [1, 8])
def test_stream_smem_bytes_bf16_equal_the_cu_layout(k, rank, blk, windows,
                                                    stages, mappers):
    """bf16 windows: half the window bytes; partial tiles, meta slots and
    mbarriers as at fp32, and every part a multiple of 16 bytes, so the
    meta slots and mbarriers after the windows stay aligned."""
    got = tk.gather_stream_smem_bytes(k, rank, blk, 8, windows,
                                      stages=stages, mappers=mappers,
                                      gather_itemsize=2)
    assert got == _stream_layout(k, rank, blk, 8, windows,
                                 tk.FACTOR_ROW_TILE, tk.STREAM_RANK_SLAB,
                                 stages, mappers, itemsize=2)
    f32 = tk.gather_stream_smem_bytes(k, rank, blk, 8, windows,
                                      stages=stages, mappers=mappers)
    slab = min(rank, tk.STREAM_RANK_SLAB)
    assert f32 - got == stages * sum(windows) * tk.FACTOR_ROW_TILE * slab * 2
    tile = tk.FACTOR_ROW_TILE * slab * 2
    assert tile % 16 == 0 and (slab * 2) % 16 == 0
    assert (stages * sum(windows) * tile) % 16 == 0


def test_stream_cu_window_is_in_the_factors_type():
    """The .cu sizes the window, its tiles and its per-row copies by the
    element type, and the other parts by float / int / mbarrier."""
    text = (CSRC / "gather_stream_mttkrp.cu").read_text()
    assert "sizeof(T) * (size_t)stages * wsum * frow * slab" in text
    assert "const unsigned tile_bytes = frow * slab * sizeof(T);" in text
    assert "slab * sizeof(T), &full[s]);" in text
    assert "gather_stream_mttkrp_bf16_launch" in text


@pytest.mark.parametrize("source", ["gather_mttkrp.cu"])
def test_gather_and_fused_smem_hold_no_factor_element(source):
    """B1 and B2 keep factor elements out of shared memory (partial tiles
    are fp32, the staging holds values, local rows and indices): their
    launches size shared memory by sizeof(float) alone; only the staging
    chunk differs between the element types
    (test_gather_smem_bytes_bf16_equal_the_cu_layout). (B3 and B4 stage
    their rows in a ring: test_fused_smem_bytes_equal_the_cu_layout.)"""
    text = (CSRC / source).read_text()
    assert "sizeof(T)" not in text
    lib = source[:-3]
    assert f"{lib}_launch(" in text and f"{lib}_bf16_launch(" in text


@pytest.mark.parametrize("k,rank,blk,windows", SMOKE_STREAMS)
def test_bf16_ring_fits_and_is_monotone_in_the_budget(k, rank, blk,
                                                      windows):
    prev = (0, 0)
    for budget in BUDGETS:
        stages, mappers = tk.stream_ring(k, rank, blk, 8, windows,
                                         smem_budget=budget,
                                         gather_itemsize=2)
        if stages:
            assert tk.gather_stream_smem_bytes(
                k, rank, blk, 8, windows, stages=stages, mappers=mappers,
                gather_itemsize=2) <= budget
        assert stages >= prev[0] and mappers >= prev[1]
        prev = (stages, mappers)
        # Never fewer stages than at fp32 under the same budget, up to
        # the CTA size two of which share an SM (beyond it bf16 keeps
        # its two-CTA ring).
        if budget <= tk.SM_SMEM_BYTES // 2 - tk.CTA_SMEM_RESERVED:
            assert stages >= tk.stream_ring(k, rank, blk, 8, windows,
                                            smem_budget=budget)[0]


def test_bf16_ring_of_the_nell2_stream():
    """At half the window bytes the nell-2 stand-in's Morton windows take
    two stages beside eight mapper warps in a CTA two of which share an
    SM (three in one CTA at fp32; five would fit one bf16 CTA), and the
    data-blind K=3, blk=128 window gets all eight mappers."""
    assert tk.stream_ring(2, 16, 64, 8, (64, 62), gather_itemsize=2) \
        == (2, 8)
    assert tk.stream_ring(3, 16, 128, 8, (128, 128, 128),
                          gather_itemsize=2) == (1, 8)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("rank,slab", [(16, 16), (32, 32), (256, 128),
                                       (256, None)])
def test_gather_smem_bytes_equal_the_cu_layout(k, rank, slab):
    """Partial tiles, then kBuffers staging buffers of kChunk slots, each
    a value, a local row and K indices (gather_mttkrp.cu)."""
    chunk = _cu_int("gather_mttkrp.cu", "kChunk")
    buffers = _cu_int("gather_mttkrp.cu", "kBuffers")
    assert buffers == tk.STAGE_BUFFERS >= 2
    assert chunk * buffers == tk.STAGE_SLOTS
    width = rank if slab is None else min(rank, slab)
    want = 4 * (tk._groups(8) * 8 * width + buffers * chunk * (2 + k))
    assert tk.gather_smem_bytes(k, rank, 8, rank_slab=slab) == want


@pytest.mark.parametrize("slab", [16, 32, 48, 64, 128, 256, 512])
def test_gather_bf16_lanes_own_16_byte_column_blocks(slab):
    """bf16 B1/B2 at a slab of kVecMinSlab (BF16_VEC_MIN_SLAB) or more: a
    lane per kVec = 8 columns (one 16-byte read of a bf16 row), at most
    32; below it, and for float32, _lanes. A CTA stays within 512
    threads, and the staging is the float32 kernel's (one byte count)."""
    vec = _cu_int("gather_mttkrp.cu", "kVec")
    assert vec * 2 == 16
    assert _cu_int("gather_mttkrp.cu", "kVecMinSlab") \
        == tk.BF16_VEC_MIN_SLAB
    lanes = tk._gather_lanes(slab, 2)
    if slab >= tk.BF16_VEC_MIN_SLAB:
        assert lanes == min(32, slab // vec)
    else:
        assert lanes == tk._lanes(slab)
    assert tk._gather_lanes(slab) == tk._lanes(slab)
    for tile_rows in (1, 8, 128):
        assert tk._groups(tile_rows) * lanes <= 512
    text = (CSRC / "gather_mttkrp.cu").read_text()
    assert "gather_mttkrp_vec_kernel<K, T><<<grid, groups * lanes, smem" \
        in text


def test_stream_bf16_consumers_fit_a_block():
    """B6's consumers read two bf16 columns a lane (slab / 2 lanes);
    float32 keeps _lanes. With kIssuerWarps issuer warps (the count
    lowering's launch plan names) and the most mapper warps, a CTA stays
    within 1024 threads at every tile height."""
    from repro_torch.kernels.mttkrp import lowering
    issuers = _cu_int("gather_stream_mttkrp.cu", "kIssuerWarps")
    assert issuers == lowering._STREAM_ISSUER_WARPS == 4
    slab = tk.STREAM_RANK_SLAB
    assert tk._stream_lanes(slab, 2) == slab // 2
    assert tk._stream_lanes(slab) == tk._lanes(slab)
    for tile_rows in (1, 2, 8, 32, 128):
        for itemsize in (4, 2):
            lanes = tk._stream_lanes(slab, itemsize)
            consumers = -(-tk._groups(tile_rows) * lanes // 32) * 32
            threads = consumers + 32 * (tk.MAX_STREAM_MAPPERS + issuers + 1)
            assert threads <= lowering.MAX_BLOCK_THREADS


@pytest.mark.parametrize("k,rank,blk,windows", SMOKE_STREAMS)
def test_bf16_ring_lets_two_ctas_share_an_sm(k, rank, blk, windows):
    """At the card's budget the bf16 ring is the deepest of two stages or
    more whose CTA two can share an SM; where none is, the float32 rule
    (the most stages within 227 KB)."""
    half = tk.SM_SMEM_BYTES // 2 - tk.CTA_SMEM_RESERVED

    def smem(stages, mappers):
        return tk.gather_stream_smem_bytes(
            k, rank, blk, 8, windows, stages=stages, mappers=mappers,
            gather_itemsize=2)
    stages, mappers = tk.stream_ring(k, rank, blk, 8, windows,
                                     gather_itemsize=2)
    two = [s for s in range(2, tk.MAX_STREAM_STAGES + 1)
           if smem(s, tk.MAX_STREAM_MAPPERS) <= half]
    if two:
        assert (stages, mappers) == (max(two), tk.MAX_STREAM_MAPPERS)
        assert 2 * (smem(stages, mappers) + tk.CTA_SMEM_RESERVED) \
            <= tk.SM_SMEM_BYTES
    else:
        assert stages >= 1
        assert smem(stages, mappers) <= tk.SMEM_LIMIT_BYTES
        if stages < tk.MAX_STREAM_STAGES and \
                mappers == tk.MAX_STREAM_MAPPERS:
            assert smem(stages + 1, mappers) > tk.SMEM_LIMIT_BYTES


def test_ladder_asks_the_fp32_gather_bytes_for_bf16():
    """The ladder's gather rungs cost B1/B2's CTA for bf16 gathers as for
    float32 ones (the same staging and partial tiles, byte for byte), so
    its choices and plan_bytes do not move."""
    for k, rpad, tr in ((2, 16, 8), (3, 256, 8), (2, 512, 128)):
        for backend in ("pallas_fused_gather", "pallas_fused_gather_tiled"):
            slab = None if backend == "pallas_fused_gather" else \
                min(rpad, tk.RANK_SLAB)
            want = tk.gather_smem_bytes(k, rpad, tr, rank_slab=slab)
            for gi in (4, 2):
                smem, _, _ = planner._rung_cost(
                    backend, k=k, rpad=rpad, tile_rows=tr, blk=128,
                    per_mode=None, total=1000, gi=gi)
                assert smem == want, (backend, gi)


@pytest.mark.parametrize("k,rank,blk,windows", SMOKE_STREAMS)
def test_ring_fits_and_is_monotone_in_the_budget(k, rank, blk, windows):
    prev = (0, 0)
    for budget in BUDGETS:
        stages, mappers = tk.stream_ring(k, rank, blk, 8, windows,
                                         smem_budget=budget)
        one = tk.gather_stream_smem_bytes(k, rank, blk, 8, windows)
        if one > budget:
            assert (stages, mappers) == (0, 0)
        else:
            assert 1 <= stages <= tk.MAX_STREAM_STAGES
            assert 1 <= mappers <= tk.MAX_STREAM_MAPPERS
            assert tk.gather_stream_smem_bytes(
                k, rank, blk, 8, windows, stages=stages,
                mappers=mappers) <= budget
        assert stages >= prev[0] and mappers >= prev[1]
        prev = (stages, mappers)


@pytest.mark.parametrize("k,rank,blk,windows", SMOKE_STREAMS)
def test_ring_at_the_card_budget(k, rank, blk, windows):
    """Every smoke-run stream gets at least one stage within 227 KB, and
    the most stages that fit beside the full set of mapper warps."""
    stages, mappers = tk.stream_ring(k, rank, blk, 8, windows)
    assert stages >= 1
    assert tk.gather_stream_smem_bytes(
        k, rank, blk, 8, windows, stages=stages, mappers=mappers) \
        <= tk.SMEM_LIMIT_BYTES
    if mappers == tk.MAX_STREAM_MAPPERS and stages < tk.MAX_STREAM_STAGES:
        assert tk.gather_stream_smem_bytes(
            k, rank, blk, 8, windows, stages=stages + 1,
            mappers=mappers) > tk.SMEM_LIMIT_BYTES


def test_ring_of_the_nell2_stream():
    """The nell-2 stand-in's Morton windows (~64 tiles per mode at blk=64)
    take three stages with eight mapper warps."""
    assert tk.stream_ring(2, 16, 64, 8, (64, 62)) == (3, 8)


def test_ring_keeps_the_ladder():
    """The smallest CTA (one stage, one mapper) is what the residency
    ladder asks about: the data-blind K=3, blk=128 window still fits."""
    windows = (128, 128, 128)
    assert tk.stream_ring(3, 16, 128, 8, windows)[0] == 1
    assert tk.gather_stream_smem_bytes(3, 16, 128, 8, windows) \
        <= tk.SMEM_LIMIT_BYTES


def _misaligned(n, dtype=torch.float32):
    """A contiguous tensor whose data starts 4 bytes past a 16-byte
    boundary."""
    base = torch.zeros(n + 1, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    return base[1:]


@pytest.mark.parametrize("bad", ["vals", "idx_stream", "local_row_in_tile",
                                 "factors[1]"])
def test_alignment_check_raises_on_a_misaligned_operand(bad):
    ops_ = {"vals": torch.zeros(256), "idx_stream": torch.zeros(
        256, 2, dtype=torch.int32), "local_row_in_tile": torch.zeros(
        256, dtype=torch.int32), "factors[0]": torch.zeros(64, 16),
        "factors[1]": torch.zeros(64, 16)}
    assert all(t.data_ptr() % 16 == 0 for t in ops_.values())
    tk._check_async_operands(64, **ops_)      # aligned: no error
    ops_[bad] = _misaligned(ops_[bad].numel(), ops_[bad].dtype)
    with pytest.raises(ValueError, match=re.escape(bad)):
        tk._check_async_operands(64, **ops_)


@pytest.mark.parametrize("blk", [2, 6, 30])
def test_alignment_check_raises_on_a_block_not_a_multiple_of_4(blk):
    with pytest.raises(ValueError, match=f"blk={blk}"):
        tk._check_async_operands(blk, vals=torch.zeros(64))


# ---------------------------------------------------------------------------
# B3, B4: the ring of pre-gathered rows
# ---------------------------------------------------------------------------

FUSED_RANKS = [16, 32, 256]


def _fused_layout(k, rank, tile_rows, slab, stages, slots, itemsize):
    """The byte count the fused_mttkrp.cu note lays out, summed apart."""
    groups = tk._groups(tile_rows)
    meta_stages = _cu_int("fused_mttkrp.cu", "kMetaStages")
    meta_chunk = _cu_int("fused_mttkrp.cu", "kMetaChunk")
    hdr = _cu_int("fused_mttkrp.cu", "kHdrInts")
    ring = stages * k * slots * slab * itemsize
    tile = tile_rows * slab
    stride = tile + 16 if tile % 32 == 0 else tile  # odd multiple of 16
    partials = groups * stride * 4
    meta = meta_stages * meta_chunk * (4 + 4)
    headers = (stages + meta_stages) * hdr * 4
    barriers = 8 * (2 * stages + 2 * meta_stages)
    return ring + partials + meta + headers + barriers


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("rank", FUSED_RANKS)
def test_fused_smem_bytes_equal_the_cu_layout(k, itemsize, rank):
    """B3 (the whole rank) and B4 (a 16-column slab) at the ring the
    wrapper picks and at the smallest ring: the ring of rows at the rows'
    itemsize, partial tiles, meta ring, headers and mbarriers, and every
    ring stage a multiple of 512 bytes (each row slice a multiple of 128,
    the 2-D tensor copy's alignment)."""
    assert tk.FUSED_META_STAGES == _cu_int("fused_mttkrp.cu", "kMetaStages")
    assert tk.FUSED_META_CHUNK == _cu_int("fused_mttkrp.cu", "kMetaChunk")
    for slab in (None, 16):
        width = rank if slab is None else slab
        stages, slots = tk.fused_ring(k, rank, 8, rank_slab=slab,
                                      gather_itemsize=itemsize)
        for st, sl in ((stages, slots), (1, tk.FUSED_MIN_SLOTS)):
            assert st >= 1
            assert tk.fused_smem_bytes(k, rank, 8, rank_slab=slab, stages=st,
                                       slots=sl, gather_itemsize=itemsize) \
                == _fused_layout(k, rank, 8, width, st, sl, itemsize)
            assert (sl * width * itemsize) % 128 == 0
        assert tk.fused_smem_bytes(k, rank, 8, rank_slab=slab,
                                   gather_itemsize=itemsize) \
            == _fused_layout(k, rank, 8, width, 1, tk.FUSED_MIN_SLOTS,
                             itemsize)


def test_fused_cu_layout_matches_the_formula():
    """The .cu sizes its CTA with the formula the wrapper uses: the ring in
    the rows' type, the rest in floats and ints, two mbarriers per ring
    stage and meta slot."""
    text = (CSRC / "fused_mttkrp.cu").read_text()
    assert "return (size_t)itemsize * stages * k * slots * slab +" in text
    assert "(size_t)groups * part_stride(tile_rows * slab) +" in text
    assert "return (tile_elems / 16 | 1) * 16;" in text
    assert "(size_t)kMetaStages * kMetaChunk * 2 +" in text
    assert "(size_t)(stages + kMetaStages) * kHdrInts) +" in text
    assert "sizeof(Barrier) * 2 * ((size_t)stages + kMetaStages);" in text
    assert "fused_smem(K, sizeof(T), groups, tile_rows, slab, stages, slots)" \
        in text
    assert "fused_mttkrp_launch(" in text and "fused_mttkrp_bf16_launch(" \
        in text


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("rank,slab", [(16, None), (32, 16), (256, None),
                                       (256, 128)])
def test_fused_ring_fits_and_is_monotone_in_the_budget(k, itemsize, rank,
                                                      slab):
    """Under every budget the ring fits it, a stage is a power of two of at
    least FUSED_MIN_SLOTS slots (a multiple of every ``groups``) within a
    meta chunk, and the slots and the ring's bytes never shrink as the
    budget grows; the smallest CTA fits exactly when some ring does."""
    width = rank if slab is None else slab
    prev_slots, prev_bytes = 0, 0
    for budget in sorted(BUDGETS + [tk.fused_smem_bytes(
            k, rank, 8, slab, gather_itemsize=itemsize)]):
        stages, slots = tk.fused_ring(k, rank, 8, rank_slab=slab,
                                      smem_budget=budget,
                                      gather_itemsize=itemsize)
        least = tk.fused_smem_bytes(k, rank, 8, rank_slab=slab,
                                    gather_itemsize=itemsize)
        assert (stages >= 1) == (least <= budget)
        ring = stages * slots * k * width * itemsize
        if stages:
            assert 1 <= stages <= (tk.FUSED_STAGES if slab is None
                                   else tk.FUSED_SLAB_STAGES)
            assert tk.FUSED_MIN_SLOTS <= slots <= tk.FUSED_STAGE_SLOTS
            assert slots == tk.FUSED_MIN_SLOTS \
                or slots * k * width * itemsize <= tk.FUSED_STAGE_BYTES
            assert slots & (slots - 1) == 0
            assert tk.FUSED_META_CHUNK % slots == 0
            assert tk.FUSED_META_CHUNK // slots <= 64
            assert tk.fused_smem_bytes(
                k, rank, 8, rank_slab=slab, stages=stages, slots=slots,
                gather_itemsize=itemsize) <= budget
        assert slots >= prev_slots and ring >= prev_bytes
        prev_slots, prev_bytes = slots, ring


def test_fused_ring_of_the_main_path():
    """The nell-2 stand-in's B3 (K=2, R=16): two 256-slot stages (32 KB in
    fp32, 16 KB in bf16), so two CTAs share an SM in fp32 and three in
    bf16; B4 at R=32 in 16-column slabs, four such stages; wide ranks keep
    a ring of narrow stages."""
    assert tk.fused_ring(2, 16, 8) == (2, 256)
    assert tk.fused_ring(2, 16, 8, gather_itemsize=2) == (2, 256)
    assert tk.fused_ring(2, 32, 8, rank_slab=16) == (4, 256)
    assert 2 * tk.fused_smem_bytes(2, 16, 8, stages=2, slots=256) \
        <= tk.SMEM_LIMIT_BYTES
    assert 3 * tk.fused_smem_bytes(2, 16, 8, stages=2, slots=256,
                                   gather_itemsize=2) <= tk.SMEM_LIMIT_BYTES
    assert tk.fused_ring(2, 256, 8) == (2, 16)
    assert tk.fused_ring(3, 256, 8) == (1, 16)


@pytest.mark.parametrize("k,itemsize,largest", [
    (2, 4, 304), (3, 4, 272), (2, 2, 336), (3, 2, 320)])
def test_fused_largest_rank(k, itemsize, largest):
    """The widest padded rank B3 runs at tile_rows=8 (partials plus the
    smallest ring); one step wider, the ladder takes B4 (one 128-column
    slab) where no gather rung fits."""
    def fits(r):
        return tk.fused_ring(k, r, 8, gather_itemsize=itemsize)[0] >= 1
    assert fits(largest) and not fits(largest + 16)
    plan = planner.plan_residency(nmodes=k + 1, rank=largest + 16, blk=512,
                                  tile_rows=8, gather_itemsize=itemsize)
    assert plan.backend == "pallas_fused_tiled"
    plan = planner.plan_residency(nmodes=k + 1, rank=largest, blk=512,
                                  tile_rows=8, gather_itemsize=itemsize)
    assert plan.backend == "pallas_fused"


def _stage_case(run, dead=()):
    """A run of ``run`` slots starting at slot 96 whose values are 1 but in
    the slot ranges of ``dead``."""
    start = 96
    vals = [0.0] * start + [1.0] * run + [1.0] * 64
    for a, b in dead:
        for i in range(start + a, start + b):
            vals[i] = 0.0
    return start, start + run, vals


# (run length, dead slot ranges within the run) at 64-slot stages:
STAGE_RUNS = [
    (32, ()),                      # shorter than one stage
    (64, ()),                      # one whole stage
    (200, ()),                     # ends mid-stage
    (1024, ()),                    # one whole meta chunk
    (1100, ()),                    # a chunk and a stage's worth past it
    (3000, ((64, 128), (1024, 2048))),   # a padding stage, a padding chunk
    (2100, ((1024, 2100),)),       # the last chunks padding only
    (512, ((0, 512),)),            # padding only
    (40, ((0, 40),)),              # padding only, shorter than a stage
    (300, ((250, 300),)),          # padding ends a stage mid-way
]


@pytest.mark.parametrize("run,dead", STAGE_RUNS)
@pytest.mark.parametrize("slots,groups", [(64, 16), (16, 16), (128, 8),
                                          (32, 1)])
def test_fused_stage_partition(run, dead, slots, groups):
    """Every slot of a run that shares a stage with a nonzero lies in
    exactly one posted stage, the stages in order; a stage of padding only
    is not posted (its slots add nothing); slot i goes to the group
    (i - run start) mod groups; a run whose last chunk is padding posts
    one stage without rows, last, to end the tile."""
    start, end, vals = _stage_case(run, dead)
    posted, groups_of = tk.fused_stage_partition(start, end, vals, slots,
                                                 groups)
    seen = [i for first, count in posted for i in range(first,
                                                        first + count)]
    assert seen == sorted(set(seen))                 # once each, in order
    assert all(start <= i < end for i in seen)
    for first, count in posted:
        assert (first - start) % slots == 0 and count <= slots
        assert count == 0 or any(vals[i] for i in range(first, first + count))
    nonzero = [i for i in range(start, end) if vals[i]]
    assert set(nonzero) <= set(seen)
    chunk = tk.FUSED_META_CHUNK
    for i in range(start, end):  # a slot is left out only with its stage
        if i not in groups_of:
            s0 = start + (i - start) // slots * slots
            c1 = min(start + ((i - start) // chunk + 1) * chunk, end)
            assert not any(vals[j] for j in range(s0, min(s0 + slots, c1)))
    assert groups_of == {i: (i - start) % groups for i in seen}
    last_chunk = range(start + (run - 1) // chunk * chunk, end)
    ends_dead = not any(vals[i] for i in last_chunk)
    assert (posted[-1][1] == 0) == ends_dead
    assert sum(1 for _, count in posted if count == 0) == int(ends_dead)


# The residency ladder's choices (``auto``) before B3/B4 held rows in
# shared memory, at the default budgets and with no L2 for the gather
# rungs: the chip run's [auto] grid (R in {16, 256}, blk in {64, 512}) on
# the nell-2 stand-in's input factors, and factors beyond L2.
AUTO_GRID = {
    (16, 64, (9200, 28800)): ("pallas_fused_gather",
                              "pallas_fused_gather_stream"),
    (16, 64, (12104, 28800)): ("pallas_fused_gather",
                               "pallas_fused_gather_stream"),
    (16, 64, (12104, 9200)): ("pallas_fused_gather",
                              "pallas_fused_gather_stream"),
    (16, 64, (2_000_000, 3_000_000)): ("pallas_fused_gather_stream",) * 2,
    (16, 64, (500_000,) * 3): ("pallas_fused_gather_stream",) * 2,
    (16, 512, (9200, 28800)): ("pallas_fused_gather", "pallas_fused"),
    (16, 512, (12104, 28800)): ("pallas_fused_gather", "pallas_fused"),
    (16, 512, (12104, 9200)): ("pallas_fused_gather", "pallas_fused"),
    (16, 512, (2_000_000, 3_000_000)): ("pallas_fused",) * 2,
    (16, 512, (500_000,) * 3): ("pallas_fused",) * 2,
    (256, 64, (9200, 28800)): ("pallas_fused_gather_tiled",
                               "pallas_fused_gather_stream"),
    (256, 64, (12104, 28800)): ("pallas_fused_gather_tiled",
                                "pallas_fused_gather_stream"),
    (256, 64, (12104, 9200)): ("pallas_fused_gather",
                               "pallas_fused_gather_stream"),
    (256, 64, (2_000_000, 3_000_000)): ("pallas_fused_gather_stream",) * 2,
    (256, 64, (500_000,) * 3): ("pallas_fused_gather_stream",) * 2,
    (256, 512, (9200, 28800)): ("pallas_fused_gather_tiled", "pallas_fused"),
    (256, 512, (12104, 28800)): ("pallas_fused_gather_tiled",
                                 "pallas_fused"),
    (256, 512, (12104, 9200)): ("pallas_fused_gather", "pallas_fused"),
    (256, 512, (2_000_000, 3_000_000)): ("pallas_fused",) * 2,
    (256, 512, (500_000,) * 3): ("pallas_fused",) * 2,
}


@pytest.mark.parametrize("rank,blk,factor_rows", list(AUTO_GRID))
def test_auto_grid_choices_are_unchanged(rank, blk, factor_rows):
    """With B3/B4's ring counted in their shared memory, ``auto`` still
    takes the rung it took before, with the L2 budget and without one."""
    want = AUTO_GRID[(rank, blk, factor_rows)]
    got = tuple(planner.plan_residency(
        nmodes=len(factor_rows) + 1, rank=rank, blk=blk, tile_rows=8,
        factor_rows=factor_rows, l2_budget=l2).backend
        for l2 in (tk.L2_BUDGET_BYTES, 0))
    assert got == want


@pytest.mark.parametrize("bad", ["vals", "local_row_in_tile",
                                 "factor_rows[0]", "factor_rows[2]"])
def test_alignment_check_names_a_misaligned_fused_operand(bad):
    """B3/B4's bulk copies: values, local rows and every row array, float32
    or bf16, must start on a 16-byte boundary."""
    ops_ = {"vals": torch.zeros(256), "local_row_in_tile": torch.zeros(
        256, dtype=torch.int32), "factor_rows[0]": torch.zeros(256, 16),
        "factor_rows[1]": torch.zeros(256, 16, dtype=torch.bfloat16),
        "factor_rows[2]": torch.zeros(256, 16, dtype=torch.bfloat16)}
    tk._check_async_operands(64, **ops_)
    ops_[bad] = _misaligned(ops_[bad].numel(), ops_[bad].dtype)
    with pytest.raises(ValueError, match=re.escape(bad)):
        tk._check_async_operands(64, **ops_)
