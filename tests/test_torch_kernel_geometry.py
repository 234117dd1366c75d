"""Geometry of the redesigned gather (B1, B2) and stream (B6) kernels.

CPU-only arithmetic: the stream kernel's ring (stages and mapper warps)
against the shared-memory budget, the shared-memory byte counts against
the layouts that ``csrc/gather_mttkrp.cu`` and ``csrc/gather_stream_mttkrp.cu``
describe, and the wrappers' alignment check for the kernels' 16-byte and
bulk copies. The kernels themselves run in ``tests/test_torch_gpu.py``.
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.mttkrp import kernel as tk  # noqa: E402

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


@pytest.mark.parametrize("source", ["gather_mttkrp.cu", "fused_mttkrp.cu"])
def test_gather_and_fused_smem_hold_no_factor_element(source):
    """B1-B4 keep factor elements out of shared memory (partial tiles are
    fp32, the staging holds values, rows and indices): their launches size
    shared memory by sizeof(float) alone, so one byte count serves both
    element types."""
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
        # Never fewer stages than at fp32 under the same budget.
        assert stages >= tk.stream_ring(k, rank, blk, 8, windows,
                                        smem_budget=budget)[0]


def test_bf16_ring_of_the_nell2_stream():
    """At half the window bytes the nell-2 stand-in's Morton windows take
    five stages beside eight mapper warps (three at fp32), and the
    data-blind K=3, blk=128 window gets all eight mappers."""
    assert tk.stream_ring(2, 16, 64, 8, (64, 62), gather_itemsize=2) \
        == (5, 8)
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
