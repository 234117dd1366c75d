"""Port parity: bf16 gathers (bf16 factor operands, fp32 products and sums).

On a CPU tensor the port's wrappers run their plain versions, which upcast
each gathered bf16 row to fp32 before the Hadamard product; the JAX
package's Pallas kernels run in interpret mode on the same bf16 operands,
where type promotion does the same. Casting an fp32 factor to bf16 rounds
to nearest even in both frameworks, so one mode step on the same fp32
factors agrees at the port's fp32 tolerance (rtol 2e-5: fp32 sums in
another order). Counts (stream bytes, planner bytes) at 2 bytes per factor
element equal the reference's exactly under its geometry. A whole CP-ALS
run is held by its fits at the reference's bf16 bound, (N-1)·2⁻⁸
relative: factors that differ in their last fp32 bit may round to bf16
values 2⁻⁸ apart in the next sweep.
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
from repro.core import mttkrp as jmt  # noqa: E402
from repro.core import tensors as jten  # noqa: E402
from repro.kernels.mttkrp import kernel as jk  # noqa: E402
from repro.kernels.mttkrp import ops as jops  # noqa: E402
from repro.oocore import executor as jex  # noqa: E402
from repro.oocore import planner as jp  # noqa: E402
from repro_torch.core import cpals as tcpals  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import flycoo as tfly  # noqa: E402
from repro_torch.core import mttkrp as tmt  # noqa: E402
from repro_torch.core import tensors as tten  # noqa: E402
from repro_torch.kernels.mttkrp import kernel as tk  # noqa: E402
from repro_torch.kernels.mttkrp import ops as tops  # noqa: E402
from repro_torch.oocore import executor as tex  # noqa: E402
from repro_torch.oocore import planner as tp  # noqa: E402

BLK, TILE = 32, 8
RTOL, ATOL = 2e-5, 1e-5
BF16 = torch.bfloat16
JAX_GEOMETRY = dict(frow_tile=128, rank_slab=128, rank_multiple=128)
SHAPES = {3: (20, 300, 170), 4: (12, 300, 170, 6), 5: (8, 300, 170, 6, 5)}
FUSED_FAMILY = ("pallas_fused", "pallas_fused_tiled", "pallas_fused_gather",
                "pallas_fused_gather_tiled", "pallas_fused_gather_stream")


def _t(x):
    return torch.from_numpy(np.array(x))


def _case(nmodes, rank, seed, nnz=150, invalid_tail=0):
    """A mode-0 sorted stream, trailing invalid elements, and fp32
    factors, from one seed."""
    shape = SHAPES[nmodes]
    t = jten.random_sparse_tensor(shape, nnz, seed=seed)
    order = np.argsort(t.indices[:, 0], kind="stable")
    idx = t.indices[order].astype(np.int32)
    valid = np.arange(len(order)) < len(order) - invalid_tail
    val = np.where(valid, t.values[order], 0.0).astype(np.float32)
    rng = np.random.default_rng(seed + 1)
    factors = [rng.standard_normal((d, rank)).astype(np.float32)
               for d in shape]
    rows_cap = -(-shape[0] // TILE) * TILE
    return idx, val, valid, factors, rows_cap


def _aligned(idx, val, valid, rows_cap):
    """The reference's block-aligned stream: values, indices, local rows,
    tile_of_block (numpy)."""
    slot, tob = jops.build_block_layout(
        jnp.asarray(idx[:, 0]), jnp.asarray(valid), rows_cap=rows_cap,
        blk=BLK, tile_rows=TILE)
    n_pad = jops.n_pad_for(len(val), rows_cap, BLK, TILE)

    def al(x):
        return np.asarray(jops._align_to_blocks(jnp.asarray(x), slot, n_pad))
    return (al(np.where(valid, val, 0.0).astype(np.float32)),
            al(np.where(valid[:, None], idx[:, 1:], 0)),
            al(idx[:, 0] % TILE), np.asarray(tob))


def _bf16(f, rank_multiple):
    """A factor as bf16, rank padded: the port's and the reference's."""
    jf = jops.pad_rank(jnp.asarray(f).astype(jnp.bfloat16))
    tf = tops.pad_rank(torch.from_numpy(f).to(BF16), rank_multiple)
    return jf, tf


# ---------------------------------------------------------------------------
# Per kernel: the bf16 plain version against the JAX kernel on bf16 operands
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nmodes", [3, 4, 5])
@pytest.mark.parametrize("rank", [16, 256])
def test_gather_bf16_plain_matches_jax_kernel(nmodes, rank):
    """B1 and B2 on bf16 factors."""
    idx, val, valid, factors, rows_cap = _case(nmodes, rank, seed=nmodes)
    vals, idx_al, rows, tob = _aligned(idx, val, valid, rows_cap)
    jf, tf = zip(*(_bf16(f, tk.RANK_MULTIPLE)
                   for f in factors[1:]))
    kw = dict(rows_cap=rows_cap, blk=BLK, tile_rows=TILE)
    args = (_t(vals), _t(idx_al), tf, _t(rows), _t(tob))
    jargs = (jnp.asarray(vals), jnp.asarray(idx_al), jf, jnp.asarray(rows),
             jnp.asarray(tob))
    slab = tops.tiled_rank_slab(rank)
    for got, kern in (
            (tk.fused_mttkrp_nmode_gather(*args, **kw),
             jk.fused_mttkrp_nmode_gather),
            (tk.fused_mttkrp_nmode_gather_tiled(*args, rank_slab=slab, **kw),
             jk.fused_mttkrp_nmode_gather_tiled)):
        want = np.asarray(kern(*jargs, interpret=True, **kw))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got[:, :rank].numpy(), want[:, :rank],
                                   rtol=RTOL, atol=ATOL)
    assert torch.equal(
        tk.fused_mttkrp_nmode_gather_plain(*args, **kw),
        tk.fused_mttkrp_nmode_gather(*args, **kw))


@pytest.mark.parametrize("nmodes", [3, 4])
@pytest.mark.parametrize("rank", [16, 256])
def test_fused_bf16_plain_matches_jax_kernel(nmodes, rank):
    """B3 and B4 on bf16 pre-gathered rows (the reference casts the matrix
    before the take)."""
    idx, val, valid, factors, rows_cap = _case(nmodes, rank, seed=10 + nmodes)
    vals, idx_al, rows, tob = _aligned(idx, val, valid, rows_cap)
    jf, tf = zip(*(_bf16(f, 16) for f in factors[1:]))
    jrows = tuple(jnp.take(f, jnp.asarray(idx_al[:, i]), axis=0)
                  for i, f in enumerate(jf))
    trows = tops.pregathered_rows(_t(idx_al), tf)
    assert all(r.dtype == BF16 for r in trows)
    kw = dict(rows_cap=rows_cap, blk=BLK, tile_rows=TILE)
    args = (_t(vals), trows, _t(rows), _t(tob))
    jargs = (jnp.asarray(vals), jrows, jnp.asarray(rows), jnp.asarray(tob))
    for got, kern in (
            (tk.fused_mttkrp_nmode(*args, **kw), jk.fused_mttkrp_nmode),
            (tk.fused_mttkrp_nmode_tiled(*args, rank_slab=16, **kw),
             jk.fused_mttkrp_nmode_tiled)):
        want = np.asarray(kern(*jargs, interpret=True, **kw))
        np.testing.assert_allclose(got[:, :rank].numpy(), want[:, :rank],
                                   rtol=RTOL, atol=ATOL)
    # On one aligned stream B3-bf16 and B1-bf16 add the same products.
    np.testing.assert_allclose(
        tk.fused_mttkrp_nmode(*args, **kw).numpy(),
        tk.fused_mttkrp_nmode_gather(_t(vals), _t(idx_al), tf, _t(rows),
                                     _t(tob), **kw).numpy(),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("nmodes", [3, 4, 5])
@pytest.mark.parametrize("rank", [16, 256])
def test_stream_bf16_plain_matches_jax_kernel(nmodes, rank):
    """B6 on bf16 factors under the reference's geometry (128-row tiles,
    128-column slabs), with an out_init."""
    idx, val, valid, factors, rows_cap = _case(nmodes, rank, seed=20 + nmodes)
    vals, idx_al, rows, tob = _aligned(idx, val, valid, rows_cap)
    fm = [jops._pad_factor_rows(jops.pad_rank(
        jnp.asarray(f).astype(jnp.bfloat16)), 128) for f in factors[1:]]
    scheds = [np.asarray(jops.tile_schedule(
        jnp.asarray(idx_al[:, i]), BLK,
        jp.stream_window_tiles(BLK, f.shape[0]))) for i, f in enumerate(fm)]
    init = np.random.default_rng(rank).standard_normal(
        (rows_cap, fm[0].shape[1])).astype(np.float32)
    kw = dict(rows_cap=rows_cap, blk=BLK, tile_rows=TILE, frow_tile=128)
    want = jk.fused_mttkrp_nmode_gather_stream(
        jnp.asarray(vals), jnp.asarray(idx_al), tuple(fm), jnp.asarray(rows),
        jnp.asarray(tob), tuple(jnp.asarray(s) for s in scheds),
        interpret=True, out_init=jnp.asarray(init), **kw)
    tf = tuple(tops._pad_factor_rows(
        tops.pad_rank(torch.from_numpy(f).to(BF16), 128), 128)
        for f in factors[1:])
    for a, b in zip(tf, fm):   # the same bf16 values in both frameworks
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b.astype(jnp.float32)))
    got = tk.fused_mttkrp_nmode_gather_stream(
        _t(vals), _t(idx_al), tf, _t(rows), _t(tob),
        tuple(_t(s) for s in scheds), rank_slab=128, out_init=_t(init), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_bf16_plain_versions_upcast_before_the_product():
    """A bf16 multiply would round every product to 8 bits; the plain
    versions multiply in fp32 on the exact bf16 values."""
    vals = torch.tensor([1.0 + 2.0 ** -20] + [0.0] * 3)
    f = torch.full((8, 16), 1.0 + 2.0 ** -7, dtype=BF16)
    idx = torch.zeros(4, 2, dtype=torch.int32)
    rows = torch.zeros(4, dtype=torch.int32)
    tob = torch.zeros(1, dtype=torch.int32)
    kw = dict(rows_cap=8, blk=4, tile_rows=8)
    step = torch.tensor(1.0 + 2.0 ** -7)
    want = (torch.tensor(1.0 + 2.0 ** -20) * step) * step   # fp32, in order
    for out in (tk.fused_mttkrp_nmode_gather(vals, idx, (f, f), rows, tob,
                                             **kw),
                tk.fused_mttkrp_nmode(vals, (f[:4], f[:4]), rows, tob, **kw)):
        assert out.dtype == torch.float32
        assert float(out[0, 0]) == float(want)


def test_mixed_or_other_element_types_raise():
    vals = torch.zeros(4)
    idx = torch.zeros(4, 2, dtype=torch.int32)
    rows = torch.zeros(4, dtype=torch.int32)
    tob = torch.zeros(1, dtype=torch.int32)
    kw = dict(rows_cap=8, blk=4, tile_rows=8)
    f32, bf = torch.zeros(8, 16), torch.zeros(8, 16, dtype=BF16)
    with pytest.raises(ValueError, match="one element type"):
        tk.fused_mttkrp_nmode_gather(vals, idx, (f32, bf), rows, tob, **kw)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tk.fused_mttkrp_nmode_gather(vals, idx, (f32.half(), f32.half()),
                                     rows, tob, **kw)
    with pytest.raises(ValueError, match="vals"):
        tk.fused_mttkrp_nmode(vals.to(BF16), (bf[:4], bf[:4]), rows, tob,
                              **kw)
    with pytest.raises(ValueError, match="contrib"):
        tk.segment_accumulate(bf[:4], rows, tob, **kw)


def test_cpu_bf16_never_counts_launches():
    idx, val, valid, factors, rows_cap = _case(3, 16, seed=5)
    before = {n: (getattr(tk, n).launches, getattr(tk, n).launches_bf16)
              for n in ("fused_mttkrp_nmode_gather",
                        "fused_mttkrp_nmode_gather_tiled",
                        "fused_mttkrp_nmode", "fused_mttkrp_nmode_tiled",
                        "fused_mttkrp_nmode_gather_stream")}
    for backend in FUSED_FAMILY:
        tops.mttkrp_device_step(_t(idx), _t(val), _t(valid),
                                [_t(f) for f in factors], mode=0,
                                rows_cap=rows_cap, blk=BLK, tile_rows=TILE,
                                backend=backend, gather_dtype="bfloat16")
    assert before == {n: (getattr(tk, n).launches,
                          getattr(tk, n).launches_bf16) for n in before}


# ---------------------------------------------------------------------------
# Per backend: the mode step against the JAX bf16 step
# ---------------------------------------------------------------------------

def _steps(idx, val, valid, factors, rows_cap, **kw):
    kw = dict(mode=0, rows_cap=rows_cap, row_offset=0, blk=BLK,
              tile_rows=TILE, **kw)
    got = tops.mttkrp_device_step(_t(idx), _t(val), _t(valid),
                                  [_t(f) for f in factors], **kw)
    want = jops.mttkrp_device_step(
        jnp.asarray(idx), jnp.asarray(val), jnp.asarray(valid),
        [jnp.asarray(f) for f in factors], interpret=True, **kw)
    return got, np.asarray(want)


@pytest.mark.parametrize("nmodes", [3, 4])
@pytest.mark.parametrize("backend", FUSED_FAMILY)
def test_device_step_bf16_matches_jax(nmodes, backend):
    idx, val, valid, factors, rows_cap = _case(nmodes, 8, seed=30,
                                               invalid_tail=7)
    got, want = _steps(idx, val, valid, factors, rows_cap, backend=backend,
                       gather_dtype="bfloat16")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # It really gathered bf16: the fp32 step differs.
    f32, _ = _steps(idx, val, valid, factors, rows_cap, backend=backend)
    assert not torch.equal(got, f32)


@pytest.mark.parametrize("backend", FUSED_FAMILY)
def test_device_step_bf16_matches_jax_under_morton(backend):
    idx, val, valid, factors, rows_cap = _case(3, 16, seed=31,
                                               invalid_tail=3)
    got, want = _steps(idx, val, valid, factors, rows_cap, backend=backend,
                       gather_dtype="bfloat16", ordering="morton")
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("nmodes", [3, 4])
@pytest.mark.parametrize("name,kernel_backend", [
    ("pallas_fused_bf16", "pallas_fused"),
    ("pallas_fused_gather_bf16", "pallas_fused_gather")])
def test_bf16_backend_names_match_jax(nmodes, name, kernel_backend):
    """The two bf16 names are their kernels with gather_dtype forced to
    bf16, whatever gather_dtype says."""
    idx, val, valid, factors, rows_cap = _case(nmodes, 8, seed=32)
    got, want = _steps(idx, val, valid, factors, rows_cap, backend=name)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    forced, _ = _steps(idx, val, valid, factors, rows_cap,
                       backend=kernel_backend, gather_dtype="bfloat16")
    assert torch.equal(got, forced)
    again, _ = _steps(idx, val, valid, factors, rows_cap, backend=name,
                      gather_dtype="bfloat16")
    assert torch.equal(got, again)


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_materialized_backends_ignore_gather_dtype(backend):
    idx, val, valid, factors, rows_cap = _case(3, 16, seed=33,
                                               invalid_tail=5)
    got, want = _steps(idx, val, valid, factors, rows_cap, backend=backend,
                       gather_dtype="bfloat16")
    f32, _ = _steps(idx, val, valid, factors, rows_cap, backend=backend)
    assert torch.equal(got, f32)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("gather_dtype", ["float16", "bf16", "float64"])
def test_unknown_gather_dtype_raises_value_error(gather_dtype):
    idx, val, valid, factors, rows_cap = _case(3, 8, seed=34)
    for backend in ("ref", "pallas_fused_gather"):
        with pytest.raises(ValueError, match="gather_dtype"):
            tops.mttkrp_device_step(
                _t(idx), _t(val), _t(valid), [_t(f) for f in factors],
                mode=0, rows_cap=rows_cap, backend=backend,
                gather_dtype=gather_dtype)
    with pytest.raises(ValueError, match="gather_dtype"):
        tex.mttkrp_out_of_core(idx, val, valid, factors, mode=0,
                               rows_cap=rows_cap, blk=BLK, tile_rows=TILE,
                               gather_dtype=gather_dtype, device="cpu")


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_mttkrp_blocked_on_a_bf16_contribution_matches_jax(dtype):
    """B5 takes fp32: a bf16 contribution is upcast exactly by
    ``ops.blocked_operands`` and sums to the reference's values."""
    rng = np.random.default_rng(1)
    n_el, rows, rank = 500, 64, 16
    row = np.sort(rng.integers(0, rows, n_el)).astype(np.int32)
    contrib = rng.standard_normal((n_el, rank)).astype(np.float32)
    valid = np.ones(n_el, bool)
    valid[-25:] = False
    contrib[-25:] = 0.0
    row[-25:] = rows - 1
    jc = jnp.asarray(contrib)
    tc = torch.from_numpy(contrib)
    if dtype == "bfloat16":
        jc, tc = jc.astype(jnp.bfloat16), tc.to(BF16)
    kw = dict(rows_cap=rows, blk=64, tile_rows=16)
    want = jops.mttkrp_blocked(jc, jnp.asarray(row), jnp.asarray(valid),
                               interpret=True, **kw)
    got = tops.mttkrp_blocked(tc, _t(row), _t(valid), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rank,factor_rows", [
    (16, (300, 170)), (256, (9200, 28800)), (256, (30000, 40000)),
    (1024, (2_000_000, 3_000_000))])
def test_auto_never_sees_the_gather_dtype(rank, factor_rows):
    """``auto``'s rung is the fp32 ladder's, never a bf16 name (the
    reference's ``select_backend`` never sees the itemsize either)."""
    rung = tops.select_backend("auto", nmodes=3, rank=rank, blk=BLK,
                               tile_rows=TILE, factor_rows=factor_rows)
    assert rung in tops.AUTO_BACKENDS and not rung.endswith("_bf16")
    assert rung == tp.plan_residency(nmodes=3, rank=rank, blk=BLK,
                                     tile_rows=TILE,
                                     factor_rows=factor_rows).backend


@pytest.mark.parametrize("nmodes", [3, 4])
def test_auto_in_bf16_is_its_rung_in_bf16(nmodes):
    idx, val, valid, factors, rows_cap = _case(nmodes, 16, seed=35)
    args = (_t(idx), _t(val), _t(valid), [_t(f) for f in factors])
    kw = dict(mode=0, rows_cap=rows_cap, blk=BLK, tile_rows=TILE,
              gather_dtype="bfloat16")
    rung = tops.select_backend(
        "auto", nmodes=nmodes, rank=16, blk=BLK, tile_rows=TILE,
        factor_rows=tuple(f.shape[0] for f in factors[1:]))
    auto = tops.mttkrp_device_step(*args, backend="auto", **kw)
    assert torch.equal(auto, tops.mttkrp_device_step(*args, backend=rung,
                                                     **kw))
    got, want = _steps(idx, val, valid, factors, rows_cap, backend="auto",
                       gather_dtype="bfloat16")
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("gather_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["auto", "pallas_fused",
                                     "pallas_fused_gather_stream"])
def test_mttkrp_fused_matches_jax(mode, gather_dtype, backend):
    t = jten.random_sparse_tensor((20, 16, 12), 200, seed=mode)
    rng = np.random.default_rng(mode + 7)
    factors = [rng.standard_normal((d, 8)).astype(np.float32)
               for d in t.shape]
    kw = dict(blk=BLK, tile_rows=TILE, backend=backend,
              gather_dtype=gather_dtype)
    got = tmt.mttkrp_fused(_t(t.indices), _t(t.values),
                           [_t(f) for f in factors], mode, t.shape[mode],
                           **kw)
    want = jmt.mttkrp_fused(jnp.asarray(t.indices), jnp.asarray(t.values),
                            [jnp.asarray(f) for f in factors], mode,
                            t.shape[mode], interpret=True, **kw)
    assert got.shape == (t.shape[mode], 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# The out-of-core executor and the planner at 2 bytes per factor element
# ---------------------------------------------------------------------------

COUNTED = ("chunks", "num_blocks", "nnz", "blk", "rank_padded", "rank_slabs",
           "window_tiles", "chunk_block_counts", "scheduled_tile_bytes",
           "distinct_tile_bytes", "pipelined_tile_bytes",
           "index_stream_bytes", "ordering", "presort_scheduled_tile_bytes",
           "presort_distinct_tile_bytes")


@pytest.mark.parametrize("ordering", ["none", "morton"])
@pytest.mark.parametrize("shape,budget", [((12, 300, 170, 6), 1500),
                                          ((40, 300, 170), None)])
def test_executor_bf16_matches_jax(ordering, shape, budget):
    t = jten.random_sparse_tensor(shape, 250, seed=9,
                                  distribution="powerlaw")
    order = np.argsort(t.indices[:, 0], kind="stable")
    idx = t.indices[order].astype(np.int32)
    valid = np.arange(len(order)) < len(order) - 7
    val = np.where(valid, t.values[order], 0.0).astype(np.float32)
    rng = np.random.default_rng(10)
    factors = [rng.standard_normal((d, 32)).astype(np.float32)
               for d in shape]
    rows_cap = -(-shape[0] // TILE) * TILE
    kw = dict(mode=0, rows_cap=rows_cap, blk=BLK, tile_rows=TILE,
              max_chunk_bytes=budget, ordering=ordering,
              gather_dtype="bfloat16")
    want, jstats = jex.mttkrp_out_of_core(
        idx, val, valid, [jnp.asarray(f) for f in factors], **kw)
    got, tstats = tex.mttkrp_out_of_core(idx, val, valid, factors,
                                         device="cpu", **kw, **JAX_GEOMETRY)
    for field in COUNTED:
        assert getattr(tstats, field) == getattr(jstats, field), field
    _, f32 = tex.mttkrp_out_of_core(
        idx, val, valid, factors, device="cpu",
        **dict(kw, gather_dtype="float32"), **JAX_GEOMETRY)
    assert tstats.distinct_tile_bytes * 2 == f32.distinct_tile_bytes
    assert tstats.chunks == f32.chunks
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_executor_bf16_port_geometry_chunked_matches_single_pass():
    """At the port's geometry: bf16 tiles of 8 x 16 x 2 B, the same chunks
    as fp32, chunked == single pass."""
    t = tten.random_sparse_tensor((40, 300, 170), 3000, seed=4)
    order = np.argsort(t.indices[:, 0], kind="stable")
    idx, val = t.indices[order], t.values[order]
    valid = np.ones(len(val), bool)
    factors = [np.random.default_rng(5).standard_normal(
        (d, 24)).astype(np.float32) for d in t.shape]
    kw = dict(mode=0, rows_cap=40, blk=BLK, tile_rows=TILE,
              ordering="morton", device="cpu", gather_dtype="bfloat16")
    single, s1 = tex.mttkrp_out_of_core(idx, val, valid, factors, **kw)
    budget = 5 * tp.stream_chunk_bytes(BLK, 2, s1.window_tiles)
    chunked, s2 = tex.mttkrp_out_of_core(idx, val, valid, factors,
                                         max_chunk_bytes=budget, **kw)
    assert s2.chunks > 5
    assert s1.window_smem_bytes == tk.gather_stream_smem_bytes(
        2, 32, BLK, TILE, s1.window_tiles, gather_itemsize=2)
    pred = tp.predict_stream_traffic(
        _t(idx), _t(valid), mode=0, rows_cap=40, blk=BLK, tile_rows=TILE,
        rank=24, factor_rows=(300, 170), max_chunk_bytes=budget,
        ordering="morton", gather_itemsize=2)
    assert pred.tile_bytes == 8 * 16 * 2
    np.testing.assert_allclose(chunked.numpy(), single.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("ordering", ["none", "morton"])
@pytest.mark.parametrize("budget", [None, 2_000])
def test_predict_stream_traffic_bf16_equal(ordering, budget):
    shape = (40, 300, 170, 6)
    t = jten.random_sparse_tensor(shape, 500, seed=3,
                                  distribution="powerlaw")
    order = np.argsort(t.indices[:, 0], kind="stable")
    idx = t.indices[order].astype(np.int32)
    valid = np.arange(len(order)) < len(order) - 6
    kw = dict(mode=0, rows_cap=40, blk=BLK, tile_rows=TILE, rank=16,
              factor_rows=(300, 170, 6), max_chunk_bytes=budget)
    want = jp.predict_stream_traffic(idx, valid, ordering=ordering,
                                     gather_itemsize=2, **kw)
    got = tp.predict_stream_traffic(_t(idx), _t(valid), ordering=ordering,
                                    gather_itemsize=2, **kw, **JAX_GEOMETRY)
    assert got.__dict__ == want.__dict__
    assert got.tile_bytes == 128 * 128 * 2


@pytest.mark.parametrize("backend", ["pallas_fused_gather",
                                     "pallas_fused_gather_tiled",
                                     "pallas_fused_gather_stream",
                                     "pallas_fused", "pallas_fused_tiled"])
def test_bf16_names_fold_into_itemsize_2(backend):
    """``backend_fits`` on a ``*_bf16`` name is the base name at
    ``gather_itemsize=2``, in the port as in the reference."""
    for rank, rows, s, l2 in ((16, (4000, 4000), 40_000, 300_000),
                              (256, (9200, 28800), 232_448, 25 * 2**20),
                              (128, (60_000, 50_000), 232_448, 25 * 2**20)):
        kw = dict(nmodes=3, rank=rank, blk=128, tile_rows=8,
                  factor_rows=rows, smem_budget=s, l2_budget=l2)
        at2 = tp.backend_fits(backend, gather_itemsize=2, **kw)
        assert tp.backend_fits(backend + "_bf16", **kw) == at2
        jkw = dict(nmodes=3, rank=rank, blk=128, tile_rows=128,
                   factor_rows=rows)
        assert jp.backend_fits(backend + "_bf16", **jkw) \
            == jp.backend_fits(backend, gather_itemsize=2, **jkw)


@pytest.mark.parametrize("rank,factor_rows,backend", [
    (128, (4000, 4000), "pallas_fused_gather"),
    (256, (1000, 2000), "pallas_fused_gather"),
    (512, (40_000, 50_000), "pallas_fused_gather_tiled")])
def test_plan_residency_bf16_bytes_equal_the_reference(rank, factor_rows,
                                                       backend):
    """Where the geometry is shared (ranks that both pad to one width, and
    the rungs both ladders pick here), the factors' resident bytes at
    itemsize 2 equal the reference's, and are half the fp32 ones."""
    plan = tp.plan_residency(nmodes=3, rank=rank, blk=128, tile_rows=8,
                             factor_rows=factor_rows, gather_itemsize=2)
    want = jp.plan_residency(nmodes=3, rank=rank, factor_rows=factor_rows,
                             gather_itemsize=2)
    assert plan.backend == want.backend == backend
    assert plan.gather_itemsize == 2

    def states(p):   # row tiles differ: 8 rows here, 128 there
        return [(f.rows, f.policy, f.rank_cols, f.resident_bytes)
                for f in p.factors]
    assert states(plan) == states(want)
    assert plan.l2_bytes == sum(f.resident_bytes for f in plan.factors)
    f32 = tp.plan_residency(nmodes=3, rank=rank, blk=128, tile_rows=8,
                            factor_rows=factor_rows, l2_budget=10**12)
    whole = tp.plan_residency(nmodes=3, rank=rank, blk=128, tile_rows=8,
                              factor_rows=factor_rows, l2_budget=10**12,
                              gather_itemsize=2)
    assert f32.backend == whole.backend
    assert f32.l2_bytes == 2 * whole.l2_bytes


@pytest.mark.parametrize("rank", [16, 256, 1024])
@pytest.mark.parametrize("factor_rows", [(4000, 4000), (12104, 28800),
                                         (2_000_000, 3_000_000)])
def test_ladder_monotone_in_both_budgets_at_itemsize_2(rank, factor_rows):
    rung = {b: i for i, b in enumerate(tp.LADDER)}
    smem_budgets = (20_000, 60_000, 100_000, 232_448, 10**7)
    l2_budgets = (0, 2**20, 25 * 2**20, 10**10)
    grid = {(s, l2): rung[tp.plan_residency(
        nmodes=3, rank=rank, blk=128, tile_rows=8, factor_rows=factor_rows,
        smem_budget=s, l2_budget=l2, gather_itemsize=2).backend]
        for s in smem_budgets for l2 in l2_budgets}
    for (s, l2), r in grid.items():
        for (s2, l22), r2 in grid.items():
            if s2 >= s and l22 >= l2:
                assert r2 <= r, ((s, l2), (s2, l22))
    # Half the bytes never moves a choice down the ladder.
    for s in smem_budgets:
        for l2 in l2_budgets:
            at4 = rung[tp.plan_residency(
                nmodes=3, rank=rank, blk=128, tile_rows=8,
                factor_rows=factor_rows, smem_budget=s,
                l2_budget=l2).backend]
            assert grid[(s, l2)] <= at4


# ---------------------------------------------------------------------------
# A whole CP-ALS run in bf16 against the JAX run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]), (jdist.AXIS,))


@pytest.fixture(scope="module")
def low_rank():
    shape, rank, nnz = (30, 25, 20), 3, 3000
    t, _ = tten.low_rank_sparse_tensor(shape, rank, nnz, seed=0)
    tj, _ = jten.low_rank_sparse_tensor(shape, rank, nnz, seed=0)
    return tfly.build_flycoo(t, 1), jfly.build_flycoo(tj, 1), rank


@pytest.mark.parametrize("backend,gather_dtype", [
    ("pallas_fused_gather", "bfloat16"),
    ("pallas_fused_gather_bf16", "float32"),
    ("pallas_fused_tiled", "bfloat16"),
    ("pallas_fused_gather_stream", "bfloat16")])
def test_cp_als_bf16_fits_match_jax(mesh, low_rank, backend, gather_dtype):
    ft, fj, rank = low_rank
    kw = dict(iters=6, seed=1, tol=0.0, backend=backend,
              gather_dtype=gather_dtype)
    want = jcpals.cp_als_distributed(fj, rank, mesh, **kw)
    got = tcpals.cp_als_distributed(ft, rank, device="cpu", **kw)
    nmodes = 3
    bound = (nmodes - 1) * 2.0 ** -8
    assert len(got.fits) == len(want.fits) == 6
    np.testing.assert_allclose(got.fits, want.fits, rtol=bound, atol=0)
    assert all(np.isfinite(got.fits)) and got.fits[-1] > got.fits[0]
    # The first sweep starts from the same factors: it agrees at fp32.
    np.testing.assert_allclose(got.fits[0], want.fits[0], rtol=0,
                               atol=1e-5)


def test_runtime_gather_dtype(low_rank):
    ft, fj, rank = low_rank
    rt, _ = tdist.prepare_runtime(ft, rank, gather_dtype="bfloat16")
    rj, _ = jdist.prepare_runtime(fj, rank, gather_dtype="bfloat16")
    assert rt.gather_dtype == rj.gather_dtype == "bfloat16"
    for bad in ("bf16", "float16"):
        with pytest.raises(ValueError, match="gather_dtype"):
            tdist.prepare_runtime(ft, rank, gather_dtype=bad)
        with pytest.raises(ValueError, match="gather_dtype"):
            tcpals.cp_als_distributed(ft, rank, device="cpu", iters=1,
                                      gather_dtype=bad)
