"""Port parity: the out-of-core stream path (``repro_torch.oocore``), the
stream kernel's plain version (B6) and its schedules.

Integers and counts must equal the JAX package's exactly under the
reference's geometry (``frow_tile`` 128, rank padded to 128, slab 128),
which the tests pass explicitly; floats agree at rtol 2e-5 (fp32 sums in
another order than the Pallas interpreter's one-hot matmuls), CP-ALS
fits at 1e-5 absolute. JAX runs its Pallas kernels in interpret mode on
the CPU; the port runs its plain versions with ``device="cpu"``. Inputs
come from seeded numpy generators: no unseeded draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import cpals as jcpals  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.core import flycoo as jfly  # noqa: E402
from repro.core import tensors as jten  # noqa: E402
from repro.kernels.mttkrp import kernel as jk  # noqa: E402
from repro.kernels.mttkrp import ops as jops  # noqa: E402
from repro.oocore import executor as jex  # noqa: E402
from repro.oocore import planner as jp  # noqa: E402
from repro_torch.core import cpals as tcpals  # noqa: E402
from repro_torch.core import flycoo as tfly  # noqa: E402
from repro_torch.core import tensors as tten  # noqa: E402
from repro_torch.kernels.mttkrp import kernel as tk  # noqa: E402
from repro_torch.kernels.mttkrp import ops as tops  # noqa: E402
from repro_torch.oocore import executor as tex  # noqa: E402
from repro_torch.oocore import planner as tp  # noqa: E402
from repro_torch.reorder import reorder_stream  # noqa: E402

BLK, TILE = 32, 8
RTOL, ATOL = 2e-5, 1e-5
# The reference's geometry, for exact comparison of counts.
JAX_GEOMETRY = dict(frow_tile=128, rank_slab=128, rank_multiple=128)
ORDERINGS = ("none", "tile", "morton")
COUNTED = ("chunks", "num_blocks", "nnz", "blk", "rank_padded", "rank_slabs",
           "window_tiles", "chunk_block_counts", "scheduled_tile_bytes",
           "distinct_tile_bytes", "pipelined_tile_bytes",
           "index_stream_bytes", "ordering", "presort_scheduled_tile_bytes",
           "presort_distinct_tile_bytes")


def _t(x):
    return torch.from_numpy(np.array(x))


def _sorted_case(shape, nnz, rank, mode, seed, invalid_tail=0,
                 distribution="uniform"):
    """Executor-contract stream (sorted by output row, trailing invalid
    elements) and float32 factors, from one seed."""
    t = jten.random_sparse_tensor(shape, nnz, seed=seed,
                                  distribution=distribution)
    order = np.argsort(t.indices[:, mode], kind="stable")
    idx = t.indices[order].astype(np.int32)
    valid = np.arange(len(order)) < len(order) - invalid_tail
    val = np.where(valid, t.values[order], 0.0).astype(np.float32)
    rng = np.random.default_rng(seed + 1)
    factors = [rng.standard_normal((d, rank)).astype(np.float32)
               for d in shape]
    return idx, val, valid, factors


# ---------------------------------------------------------------------------
# Planner arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("blk", [8, 32, 128])
@pytest.mark.parametrize("rows", [1, 100, 128, 129, 5000])
@pytest.mark.parametrize("frow_tile", [8, 128])
def test_window_bounds_equal(blk, rows, frow_tile):
    assert tp.factor_row_tiles(rows, frow_tile) \
        == jp.factor_row_tiles(rows, frow_tile)
    assert tp.stream_window_tiles(blk, rows, frow_tile) \
        == jp.stream_window_tiles(blk, rows, frow_tile)


@pytest.mark.parametrize("k,windows", [(1, (3,)), (2, (1, 7)),
                                       (3, (4, 4, 4))])
@pytest.mark.parametrize("blk", [16, 128])
def test_stream_chunk_bytes_equal(k, windows, blk):
    assert tp.stream_chunk_bytes(blk, k, windows) \
        == jp.stream_chunk_bytes(blk, k, windows)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_blocks", [1, 2, 5, 13, 1000])
def test_chunk_boundaries_equal(seed, max_blocks):
    rng = np.random.default_rng(seed)
    # Runs of 1..20 blocks per tile, some tiles skipped.
    runs = rng.integers(1, 21, 40)
    tiles = np.repeat(np.cumsum(rng.integers(1, 3, 40)), runs)
    want = jp.chunk_boundaries(tiles, max_blocks)
    assert tp.chunk_boundaries(_t(tiles), max_blocks) == want
    assert tp.chunk_boundaries(tiles, max_blocks) == want


def test_chunk_window_tiles_equal():
    dcounts = np.array([[1, 4], [1, 1], [2, 1], [5, 1], [1, 1], [1, 2]])
    windows = (4, 3)
    for chunks in ([(0, 2), (2, 4), (4, 6)], [(0, 6)], [(0, 1), (1, 6)]):
        assert tp.chunk_window_tiles(_t(dcounts), chunks, windows) \
            == jp.chunk_window_tiles(dcounts, chunks, windows)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_tile_analysis_equal(seed):
    rng = np.random.default_rng(seed)
    per_block = rng.integers(0, 9, (20, 16, 3))
    for a, b in zip(jp.block_tile_analysis(per_block),
                    tp.block_tile_analysis(_t(per_block))):
        np.testing.assert_array_equal(b.numpy(), a)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("window", [1, 2, 5, 32])
@pytest.mark.parametrize("frow_tile", [8, 128])
def test_tile_schedule_equal(seed, window, frow_tile):
    """Including windows narrower than a block's distinct count, and the
    unfilled slots repeating the block's first tile."""
    rng = np.random.default_rng(seed)
    stream = rng.integers(0, 1500, BLK * 12).astype(np.int32)
    want = jops.tile_schedule(jnp.asarray(stream), BLK, window,
                              frow_tile=frow_tile)
    got = tops.tile_schedule(_t(stream), BLK, window, frow_tile=frow_tile)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rows,multiple", [(5, 8), (16, 8), (300, 128)])
def test_pad_factor_rows_equal(rows, multiple):
    f = np.random.default_rng(rows).standard_normal((rows, 3)).astype(
        np.float32)
    want = jops._pad_factor_rows(jnp.asarray(f), multiple)
    got = tops._pad_factor_rows(_t(f), multiple)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _traffic_kw(shape, mode, budget):
    return dict(mode=mode, rows_cap=-(-shape[mode] // TILE) * TILE, blk=BLK,
                tile_rows=TILE, rank=16,
                factor_rows=tuple(d for w, d in enumerate(shape)
                                  if w != mode),
                max_chunk_bytes=budget)


@pytest.mark.parametrize("ordering", ORDERINGS)
@pytest.mark.parametrize("budget", [None, 2_000, 9_000])
def test_predict_stream_traffic_equal(ordering, budget):
    shape = (40, 300, 170, 6)
    idx, val, valid, _ = _sorted_case(shape, 500, 16, 0, seed=3,
                                      invalid_tail=6,
                                      distribution="powerlaw")
    if ordering != "none":
        idx, val, valid, _ = reorder_stream(
            _t(idx), _t(val), _t(valid), mode=0, ordering=ordering,
            tile_rows=TILE, frow_tile=128)
        idx, valid = idx.numpy(), valid.numpy()
    kw = _traffic_kw(shape, 0, budget)
    want = jp.predict_stream_traffic(idx, valid, ordering=ordering, **kw)
    got = tp.predict_stream_traffic(_t(idx), _t(valid), ordering=ordering,
                                    **kw, **JAX_GEOMETRY)
    assert got.__dict__ == want.__dict__
    assert got.scheduled_over_distinct == want.scheduled_over_distinct


# ---------------------------------------------------------------------------
# Shared-memory sizing (the port's own geometry)
# ---------------------------------------------------------------------------

def test_gather_stream_smem_bytes_layout():
    # groups=16 partial 8x16 tiles; one stage: 2 modes x 5 tiles of 8x16;
    # one mapper warp, so 1 + 1 + 1 meta slots, each 128 slots x (value,
    # row, 2 indices), the 10 schedule entries (padded to 12) and 10 run
    # lengths and a flag (padded to 12); 2 + 3 * 3 eight-byte mbarriers.
    assert tk.gather_stream_smem_bytes(2, 16, 128, 8, (5, 5)) == 4 * (
        16 * 8 * 16 + 10 * 8 * 16 + 3 * (128 * 4 + 12 + 12)) + 8 * 11
    assert tk.gather_stream_smem_bytes(2, 16, 128, 8, 5) \
        == tk.gather_stream_smem_bytes(2, 16, 128, 8, (5, 5))


@pytest.mark.parametrize("nmodes", [3, 4])
def test_data_blind_window_fits_for_three_input_modes(nmodes):
    """The port's geometry: with blk=128 and K <= 3 the window bound
    min(blk, ceil(rows/8)) fits shared memory for any factor size, so the
    stream rung runs without an ordering; K = 4 needs the data."""
    kw = dict(nmodes=nmodes, rank=16, blk=128, tile_rows=8,
              factor_rows=(10 ** 7,) * (nmodes - 1))
    assert tp.stream_fits_smem(**kw)
    assert not tp.stream_fits_smem(**dict(kw, nmodes=5,
                                          factor_rows=(10 ** 7,) * 4))
    assert tp.stream_fits_smem(**dict(kw, nmodes=5,
                                      factor_rows=(10 ** 7,) * 4),
                               window_tiles=(40,) * 4)


def test_stream_fits_smem_monotone_in_budget():
    kw = dict(nmodes=3, rank=48, blk=128, tile_rows=8,
              factor_rows=(5000, 300))
    need = tk.gather_stream_smem_bytes(2, 48, 128, 8, (128, 38))
    assert not tp.stream_fits_smem(smem_budget=need - 1, **kw)
    assert tp.stream_fits_smem(smem_budget=need, **kw)
    assert tp.stream_fits_smem(smem_budget=2 * need, **kw)


# ---------------------------------------------------------------------------
# The stream kernel's plain version against the JAX kernel
# ---------------------------------------------------------------------------

SHAPES = {3: (20, 300, 170), 4: (12, 300, 170, 6), 5: (8, 300, 170, 6, 5)}


def _stream_operands(nmodes, rank, seed):
    shape = SHAPES[nmodes]
    idx, val, valid, factors = _sorted_case(shape, 150, rank, 0, seed=seed)
    rows_cap = -(-shape[0] // TILE) * TILE
    slot, tob = jops.build_block_layout(
        jnp.asarray(idx[:, 0]), jnp.asarray(valid), rows_cap=rows_cap,
        blk=BLK, tile_rows=TILE)
    n_pad = jops.n_pad_for(len(val), rows_cap, BLK, TILE)

    def al(x):
        return np.asarray(jops._align_to_blocks(jnp.asarray(x), slot, n_pad))
    idx_al = al(idx[:, 1:])
    fm = [np.asarray(jops._pad_factor_rows(jops.pad_rank(jnp.asarray(f)),
                                           128)) for f in factors[1:]]
    scheds = [np.asarray(jops.tile_schedule(
        jnp.asarray(idx_al[:, i]), BLK,
        jp.stream_window_tiles(BLK, f.shape[0]))) for i, f in enumerate(fm)]
    return (al(val), idx_al, fm, al(idx[:, 0] % TILE), np.asarray(tob),
            scheds, rows_cap)


@pytest.mark.parametrize("nmodes", [3, 4, 5])
@pytest.mark.parametrize("rank", [16, 256])
def test_stream_plain_matches_jax_kernel(nmodes, rank):
    vals, idx_al, fm, rows, tob, scheds, rows_cap = _stream_operands(
        nmodes, rank, seed=nmodes)
    kw = dict(rows_cap=rows_cap, blk=BLK, tile_rows=TILE, frow_tile=128)
    init = np.random.default_rng(rank).standard_normal(
        (rows_cap, fm[0].shape[1])).astype(np.float32)
    want = jk.fused_mttkrp_nmode_gather_stream(
        jnp.asarray(vals), jnp.asarray(idx_al),
        tuple(jnp.asarray(f) for f in fm), jnp.asarray(rows),
        jnp.asarray(tob), tuple(jnp.asarray(s) for s in scheds),
        interpret=True, out_init=jnp.asarray(init), **kw)
    args = (_t(vals), _t(idx_al), tuple(_t(f) for f in fm), _t(rows),
            _t(tob), tuple(_t(s) for s in scheds))
    got = tk.fused_mttkrp_nmode_gather_stream(*args, rank_slab=128,
                                              out_init=_t(init), **kw)
    plain = tk.fused_mttkrp_nmode_gather_stream_plain(
        *args, rank_slab=128, out_init=_t(init), **kw)
    assert torch.equal(got, plain)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_stream_plain_skips_slots_missing_from_schedule():
    vals, idx_al, fm, rows, tob, scheds, rows_cap = _stream_operands(
        3, 16, seed=8)
    args = [_t(vals), _t(idx_al), tuple(_t(f) for f in fm), _t(rows),
            _t(tob)]
    kw = dict(rows_cap=rows_cap, blk=BLK, tile_rows=TILE, frow_tile=128,
              rank_slab=128)
    empty = tuple(torch.full_like(_t(s), 2) for s in scheds)  # tile 2: none
    out = tk.fused_mttkrp_nmode_gather_stream_plain(*args, empty, **kw)
    assert torch.equal(out, torch.zeros_like(out))


def test_stream_wrapper_rejects_bad_operands():
    vals, idx_al, fm, rows, tob, scheds, rows_cap = _stream_operands(
        3, 16, seed=9)
    args = [_t(vals), _t(idx_al), tuple(_t(f) for f in fm), _t(rows),
            _t(tob), tuple(_t(s) for s in scheds)]
    kw = dict(rows_cap=rows_cap, blk=BLK, tile_rows=TILE, rank_slab=128)
    with pytest.raises(ValueError, match="frow_tile"):
        tk.fused_mttkrp_nmode_gather_stream(*args, frow_tile=96, **kw)
    bad = list(args)
    bad[5] = (args[5][0][:-1], args[5][1])
    with pytest.raises(ValueError, match="tile_schedules"):
        tk.fused_mttkrp_nmode_gather_stream(*bad, frow_tile=128, **kw)


def test_stream_carry_on_cpu():
    """The plain version adds everything at once: its carry holds zeros,
    names the open tile and counts its consumed slots."""
    vals, idx_al, fm, rows, tob, scheds, rows_cap = _stream_operands(
        3, 16, seed=10)
    args = [_t(vals), _t(idx_al), tuple(_t(f) for f in fm), _t(rows),
            _t(tob), tuple(_t(s) for s in scheds)]
    kw = dict(rows_cap=rows_cap, blk=BLK, tile_rows=TILE, frow_tile=128,
              rank_slab=128)
    whole = tk.fused_mttkrp_nmode_gather_stream(*args, **kw)
    nb = len(tob)
    cut = next(b for b in range(1, nb) if tob[b] == tob[b - 1])
    first = [a[:cut * BLK] for a in args[:2]] + [args[2]] + [
        args[3][:cut * BLK], args[4][:cut], tuple(s[:cut] for s in args[5])]
    out, carry = tk.fused_mttkrp_nmode_gather_stream_chunk(
        *first, split_tail=True, **kw)
    assert carry.tile == int(tob[cut - 1])
    assert carry.slots == int((tob[:cut] == tob[cut - 1]).sum()) * BLK
    assert not carry.partials.any()
    rest = [a[cut * BLK:] for a in args[:2]] + [args[2]] + [
        args[3][cut * BLK:], args[4][cut:], tuple(s[cut:] for s in args[5])]
    out, none = tk.fused_mttkrp_nmode_gather_stream_chunk(
        *rest, out_init=out, carry=carry, **kw)
    assert none is None
    np.testing.assert_allclose(out.numpy(), whole.numpy(), rtol=RTOL,
                               atol=ATOL)
    with pytest.raises(ValueError, match="carry holds tile"):
        tk.fused_mttkrp_nmode_gather_stream_chunk(
            *rest, carry=carry._replace(tile=carry.tile + 1), **kw)


# ---------------------------------------------------------------------------
# The executor and the device step against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ordering", ORDERINGS)
@pytest.mark.parametrize("shape,budget", [((12, 300, 170, 6), 1500),
                                          ((40, 300, 170), None)])
def test_executor_matches_jax(ordering, shape, budget):
    rank = 32
    idx, val, valid, factors = _sorted_case(shape, 250, rank, 0, seed=9,
                                            invalid_tail=7,
                                            distribution="powerlaw")
    rows_cap = -(-shape[0] // TILE) * TILE
    kw = dict(mode=0, rows_cap=rows_cap, blk=BLK, tile_rows=TILE,
              max_chunk_bytes=budget, ordering=ordering)
    want, jstats = jex.mttkrp_out_of_core(
        idx, val, valid, [jnp.asarray(f) for f in factors], **kw)
    got, tstats = tex.mttkrp_out_of_core(idx, val, valid, factors,
                                         device="cpu", **kw, **JAX_GEOMETRY)
    for field in COUNTED:
        assert getattr(tstats, field) == getattr(jstats, field), field
    if budget is not None:
        assert tstats.chunks >= 3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # Predicted == counted on the stream the executor ran.
    ridx, rvalid = _t(idx), _t(valid)
    if ordering != "none":
        ridx, _, rvalid, _ = reorder_stream(
            ridx, _t(val), rvalid, mode=0, ordering=ordering,
            tile_rows=TILE, frow_tile=128)
    pred = tp.predict_stream_traffic(
        ridx, rvalid, ordering=ordering, **_traffic_kw(shape, 0, budget),
        **JAX_GEOMETRY)
    assert pred.scheduled_tile_bytes == tstats.scheduled_tile_bytes
    assert pred.distinct_tile_bytes == tstats.distinct_tile_bytes
    assert pred.window_tiles == tstats.window_tiles
    assert pred.chunks == tstats.chunks


def test_executor_port_geometry_chunked_matches_single_pass():
    """At the port's geometry (frow 8, slab 16), with chunks that split
    tile runs: the same counts either way, the same sums to fp32."""
    idx, val, valid, factors = _sorted_case((40, 300, 170), 3000, 24, 0,
                                            seed=4)
    kw = dict(mode=0, rows_cap=40, blk=BLK, tile_rows=TILE,
              ordering="morton", device="cpu")
    single, s1 = tex.mttkrp_out_of_core(idx, val, valid, factors, **kw)
    budget = 5 * tp.stream_chunk_bytes(BLK, 2, s1.window_tiles)
    chunked, s2 = tex.mttkrp_out_of_core(idx, val, valid, factors,
                                         max_chunk_bytes=budget, **kw)
    assert (s1.rank_padded, s1.rank_slabs) == (32, 2)
    assert s2.chunks > 5 and max(s2.chunk_block_counts) <= 5
    assert s2.distinct_tile_bytes == s1.distinct_tile_bytes
    assert s2.scheduled_tile_bytes <= s1.scheduled_tile_bytes
    # Morton order cuts both the tiles scheduled and the tiles copied.
    assert s1.scheduled_tile_bytes < s1.presort_scheduled_tile_bytes
    assert s1.distinct_tile_bytes < s1.presort_distinct_tile_bytes
    np.testing.assert_allclose(chunked.numpy(), single.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("ordering", ORDERINGS)
def test_device_step_stream_matches_jax(ordering):
    shape = (40, 300, 170)
    idx, val, valid, factors = _sorted_case(shape, 300, 16, 0, seed=2,
                                            invalid_tail=4)
    kw = dict(mode=0, rows_cap=40, row_offset=0, blk=BLK, tile_rows=TILE,
              backend="pallas_fused_gather_stream", ordering=ordering)
    want = jops.mttkrp_device_step(
        jnp.asarray(idx), jnp.asarray(val), jnp.asarray(valid),
        [jnp.asarray(f) for f in factors], interpret=True, **kw)
    got = tops.mttkrp_device_step(
        _t(idx), _t(val), _t(valid), [_t(f) for f in factors], **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


CP_SHAPE, CP_NNZ, CP_RANK = (30, 300, 170), 2000, 8


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]), (jdist.AXIS,))


@pytest.mark.parametrize("ordering,backend", [
    ("tile", "pallas_fused_gather_stream"),
    ("morton", "pallas_fused_gather_stream"),
    ("morton", "pallas_fused_gather"),
])
def test_cp_als_fits_match_jax(mesh, ordering, backend):
    ft = tfly.build_flycoo(tten.random_sparse_tensor(CP_SHAPE, CP_NNZ,
                                                     seed=0), 1)
    fj = jfly.build_flycoo(jten.random_sparse_tensor(CP_SHAPE, CP_NNZ,
                                                     seed=0), 1)
    kw = dict(iters=3, tol=0.0, backend=backend, ordering=ordering)
    want = jcpals.cp_als_distributed(fj, CP_RANK, mesh, **kw)
    got = tcpals.cp_als_distributed(ft, CP_RANK, device="cpu", **kw)
    np.testing.assert_allclose(got.fits, want.fits, rtol=0, atol=1e-5)
