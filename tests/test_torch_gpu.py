"""The CUDA kernels on the card: held against their plain versions.

Marked ``gpu``: each test skips, with its reason, where no CUDA device is
available (the CPU-only hosts that run the rest of the suite). On a
machine with an H100 run ``python -m pytest -m gpu tests/test_torch_gpu.py``.
This file imports no JAX, so it runs where JAX is not installed.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import cpals, flycoo, tensors  # noqa: E402
from repro_torch.kernels.mttkrp import kernel as K  # noqa: E402
from repro_torch.kernels.mttkrp import ops  # noqa: E402
from repro_torch.oocore import executor, planner  # noqa: E402
from repro_torch.reorder import reorder_stream  # noqa: E402
from torch_lm_common import frontend_inputs, open_gates  # noqa: E402

pytestmark = pytest.mark.gpu
BLK, TILE = 64, 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _stream(dev, k, rank, cap, rows_cap, seed, frows=None):
    """A row-sorted random stream (mode 0 out) and its factors (``frows``
    input-factor rows, random in 50..400 when not given)."""
    rng = np.random.default_rng(seed)
    if frows is None:
        frows = [int(x) for x in rng.integers(50, 400, k)]
    idx = np.stack([np.sort(rng.integers(0, rows_cap, cap))]
                   + [rng.integers(0, f, cap) for f in frows], 1)
    factors = [torch.zeros(rows_cap, rank)] + [
        torch.from_numpy(rng.standard_normal((f, rank)).astype(np.float32))
        for f in frows]
    valid = torch.from_numpy(np.arange(cap) < cap - 17)
    val = rng.standard_normal(cap).astype(np.float32)
    return (torch.from_numpy(idx.astype(np.int32)).to(dev),
            torch.from_numpy(val).to(dev), valid.to(dev),
            [f.to(dev) for f in factors])


def _operands(dev, k, rank, slab, cap=5000, rows_cap=96, seed=0, blk=BLK,
              tile_rows=TILE, ordering="none"):
    idx, val, valid, factors = _stream(dev, k, rank, cap, rows_cap, seed)
    return ops.gather_operands(
        idx, val, valid, factors, mode=0, rows_cap=rows_cap, row_offset=0,
        blk=blk, tile_rows=tile_rows, slab=slab, ordering=ordering)


def _stream_args(operands, blk=BLK):
    """B6's operands from B1's: factors padded to whole tiles, schedules."""
    vals, idx_al, fmats, rows, tob = operands
    fmats = tuple(ops._pad_factor_rows(f, K.FACTOR_ROW_TILE) for f in fmats)
    scheds, _, _ = ops.stream_schedules(idx_al, blk,
                                        [f.shape[0] for f in fmats])
    return vals, idx_al, fmats, rows, tob, scheds


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("rank", [16, 48, 256])
def test_kernels_match_plain_and_each_other(cuda, k, rank):
    slab = ops.tiled_rank_slab(rank)
    args = _operands(cuda, k, ops.padded_rank(rank), slab, seed=k + rank)
    kw = dict(rows_cap=96, blk=BLK, tile_rows=TILE)
    n1, n2 = K.fused_mttkrp_nmode_gather.launches, \
        K.fused_mttkrp_nmode_gather_tiled.launches
    b1 = K.fused_mttkrp_nmode_gather(*args, **kw)
    b2 = K.fused_mttkrp_nmode_gather_tiled(*args, rank_slab=slab, **kw)
    plain = K.fused_mttkrp_nmode_gather_plain(*args, **kw)
    assert K.fused_mttkrp_nmode_gather.launches == n1 + 1
    assert K.fused_mttkrp_nmode_gather_tiled.launches == n2 + 1
    scale = float(plain.abs().max())
    assert torch.allclose(b1, plain, rtol=1e-5, atol=1e-5 * scale)
    assert torch.equal(b1, b2)
    assert torch.equal(b1, K.fused_mttkrp_nmode_gather(*args, **kw))


@pytest.mark.parametrize("blk,tile_rows", [(32, 1), (128, 4), (512, 16),
                                            (64, 128), (256, 3)])
def test_geometries(cuda, blk, tile_rows):
    """groups = 16, 16, 8, 1 and 32->16 partial tiles; 16- and 32-lane groups."""
    rows_cap = 128 * tile_rows
    for rank, slab in ((16, 16), (64, 32)):
        args = _operands(cuda, 3, rank, slab, cap=20_000, rows_cap=rows_cap,
                         seed=blk + tile_rows, blk=blk, tile_rows=tile_rows)
        kw = dict(rows_cap=rows_cap, blk=blk, tile_rows=tile_rows)
        b1 = K.fused_mttkrp_nmode_gather(*args, **kw)
        b2 = K.fused_mttkrp_nmode_gather_tiled(*args, rank_slab=slab, **kw)
        plain = K.fused_mttkrp_nmode_gather_plain(*args, **kw)
        scale = float(plain.abs().max())
        assert torch.allclose(b1, plain, rtol=1e-5, atol=1e-5 * scale)
        assert torch.equal(b1, b2)


def test_out_init_and_padding(cuda):
    args = _operands(cuda, 2, 16, 16, seed=3)
    kw = dict(rows_cap=96, blk=BLK, tile_rows=TILE)
    init = torch.randn(96, 16, device=cuda)
    keep = init.clone()
    got = K.fused_mttkrp_nmode_gather(*args, out_init=init, **kw)
    want = K.fused_mttkrp_nmode_gather_plain(*args, out_init=init, **kw)
    assert torch.equal(init, keep)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-4)
    # A stream of padding only adds nothing: the output is out_init.
    vals = torch.zeros_like(args[0])
    assert torch.equal(
        K.fused_mttkrp_nmode_gather(vals, *args[1:], out_init=init, **kw),
        init)


def test_wrong_operands_raise(cuda):
    args = list(_operands(cuda, 2, 16, 16, seed=4))
    kw = dict(rows_cap=96, blk=BLK, tile_rows=TILE)
    cpu_vals = args.copy()
    cpu_vals[0] = args[0].cpu()
    with pytest.raises(ValueError):
        K.fused_mttkrp_nmode_gather(*cpu_vals, **kw)
    strided = args.copy()
    strided[0] = torch.stack([args[0], args[0]], 1)[:, 0]
    with pytest.raises(ValueError):
        K.fused_mttkrp_nmode_gather(*strided, **kw)


def test_cp_als_on_card_matches_cpu(cuda):
    t = tensors.random_sparse_tensor((40, 30, 20), 2000, seed=0)
    ft = flycoo.build_flycoo(t, 1)
    for backend in ("pallas_fused_gather", "pallas_fused_gather_tiled"):
        got = cpals.cp_als_distributed(ft, 8, iters=3, tol=0.0,
                                       backend=backend)
        want = cpals.cp_als_distributed(ft, 8, device="cpu", iters=3,
                                        tol=0.0, backend=backend)
        np.testing.assert_allclose(got.fits, want.fits, rtol=0, atol=1e-5)
        for a, b in zip(got.factors, want.factors):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_cp_als_oracle_on_card_matches_cpu(cuda):
    t = tensors.random_sparse_tensor((30, 20, 10), 500, seed=4)
    got = cpals.cp_als(t, 6, iters=5, seed=5)
    want = cpals.cp_als(t, 6, device="cpu", iters=5, seed=5)
    np.testing.assert_allclose(got.fits, want.fits, rtol=0, atol=1e-5)
    for a, b in zip(got.factors, want.factors):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# B6, the stream kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("rank,slab", [(16, 16), (48, 16), (64, 32)])
@pytest.mark.parametrize("ordering", ["none", "morton"])
def test_stream_matches_plain_and_b1_bitwise(cuda, k, rank, slab, ordering):
    args = _operands(cuda, k, rank, rank, seed=k + rank, ordering=ordering)
    kw = dict(rows_cap=96, blk=BLK, tile_rows=TILE)
    sargs = _stream_args(args)
    n6 = K.fused_mttkrp_nmode_gather_stream.launches
    b6 = K.fused_mttkrp_nmode_gather_stream(*sargs, rank_slab=slab, **kw)
    assert K.fused_mttkrp_nmode_gather_stream.launches == n6 + 1
    plain = K.fused_mttkrp_nmode_gather_stream_plain(*sargs, rank_slab=slab,
                                                     **kw)
    scale = float(plain.abs().max())
    assert torch.allclose(b6, plain, rtol=1e-5, atol=1e-5 * scale)
    assert torch.equal(b6, K.fused_mttkrp_nmode_gather(*args, **kw))
    assert torch.equal(b6, K.fused_mttkrp_nmode_gather_stream(
        *sargs, rank_slab=slab, **kw))


@pytest.mark.parametrize("blk,tile_rows", [(32, 1), (128, 4), (64, 16),
                                            (128, 8)])
def test_stream_geometries(cuda, blk, tile_rows):
    """groups = 16, 16, 8 and 16 partial tiles; B6 == B1 bitwise."""
    rows_cap = 64 * tile_rows
    args = _operands(cuda, 3, 16, 16, cap=20_000, rows_cap=rows_cap,
                     seed=blk + tile_rows, blk=blk, tile_rows=tile_rows,
                     ordering="morton")
    kw = dict(rows_cap=rows_cap, blk=blk, tile_rows=tile_rows)
    b6 = K.fused_mttkrp_nmode_gather_stream(*_stream_args(args, blk), **kw)
    assert torch.equal(b6, K.fused_mttkrp_nmode_gather(*args, **kw))


def test_stream_missing_tile_adds_nothing(cuda):
    """A slot whose tile is not in its block's schedule row adds nothing,
    like an out-of-range index in B1."""
    args = _operands(cuda, 2, 16, 16, seed=11)
    vals, idx_al, fmats, rows, tob, scheds = _stream_args(args)
    # Replace block 0's schedule row for mode 0 by a tile it never reads.
    bad = scheds[0].clone()
    bad[0] = int(fmats[0].shape[0] // K.FACTOR_ROW_TILE) - 1
    kw = dict(rows_cap=96, blk=BLK, tile_rows=TILE)
    used = (idx_al[:BLK, 0] // K.FACTOR_ROW_TILE) != bad[0, 0]
    keep = torch.ones_like(vals, dtype=torch.bool)
    keep[:BLK] = ~used
    want = K.fused_mttkrp_nmode_gather_plain(
        torch.where(keep, vals, 0.0), idx_al, fmats, rows, tob, **kw)
    got = K.fused_mttkrp_nmode_gather_stream(
        vals, idx_al, fmats, rows, tob, (bad, scheds[1]), **kw)
    scale = float(want.abs().max())
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


def test_stream_unsorted_schedule_matches_b1(cuda):
    """A schedule row in another order (here reversed) is still searched
    in full: the kernel falls back from its binary search to a scan."""
    args = _operands(cuda, 2, 16, 16, seed=13, ordering="morton")
    vals, idx_al, fmats, rows, tob, scheds = _stream_args(args)
    kw = dict(rows_cap=96, blk=BLK, tile_rows=TILE)
    rev = tuple(torch.flip(s, dims=[1]).contiguous() for s in scheds)
    got = K.fused_mttkrp_nmode_gather_stream(vals, idx_al, fmats, rows, tob,
                                             rev, **kw)
    assert torch.equal(got, K.fused_mttkrp_nmode_gather(*args, **kw))


def test_stream_window_over_smem_raises(cuda):
    args = _operands(cuda, 2, 16, 16, seed=12)
    vals, idx_al, fmats, rows, tob, scheds = _stream_args(args)
    wide = tuple(s[:, :1].expand(-1, 300).contiguous() for s in scheds)
    nbytes = K.gather_stream_smem_bytes(2, 16, BLK, TILE, (300, 300))
    assert nbytes > K.SMEM_LIMIT_BYTES
    with pytest.raises(ValueError, match=str(nbytes)):
        K.fused_mttkrp_nmode_gather_stream(vals, idx_al, fmats, rows, tob,
                                           wide, rows_cap=96, blk=BLK,
                                           tile_rows=TILE)


@pytest.mark.parametrize("ordering", ["none", "tile", "morton"])
def test_chunked_equals_single_pass_with_mid_tile_split(cuda, ordering):
    """Chunks that split output tiles' runs give the single pass's bits,
    which are B1's on the same (reordered) stream."""
    # 40 rows in 5 tiles of 8: each tile's run is ~30 blocks of 32, so a
    # budget of ~7 blocks splits every run mid-tile.
    idx, val, valid, factors = _stream(cuda, 3, 16, 5000, 40, seed=5)
    kw = dict(mode=0, rows_cap=40, blk=32, tile_rows=8, ordering=ordering)
    single, s1 = executor.mttkrp_out_of_core(idx, val, valid, factors, **kw)
    budget = 7 * planner.stream_chunk_bytes(32, 3, s1.window_tiles)
    chunked, s2 = executor.mttkrp_out_of_core(
        idx, val, valid, factors, max_chunk_bytes=budget, **kw)
    assert s1.chunks == 1 and s2.chunks >= 10
    assert max(s2.chunk_block_counts) < 30     # runs split mid-tile
    assert torch.equal(chunked, single)
    if ordering != "none":
        idx, val, valid, _ = reorder_stream(
            idx, val, valid, mode=0, ordering=ordering, tile_rows=8)
    b1 = ops.mttkrp_device_step(idx, val, valid, factors, mode=0,
                                rows_cap=40, blk=32, tile_rows=8,
                                backend="pallas_fused_gather")
    assert torch.equal(chunked, b1)
    want = executor.mttkrp_out_of_core(
        idx.cpu(), val.cpu(), valid.cpu(), [f.cpu() for f in factors],
        device="cpu", max_chunk_bytes=budget,
        **dict(kw, ordering="none"))[0]
    scale = float(want.abs().max())
    assert torch.allclose(chunked.cpu(), want, rtol=1e-5, atol=1e-5 * scale)


def test_stream_cp_als_on_card(cuda):
    """The stream backend's fits equal B1's with the same ordering (same
    aligned stream, bitwise equal kernels) and match the CPU run."""
    t = tensors.random_sparse_tensor((40, 300, 170), 3000, seed=0)
    ft = flycoo.build_flycoo(t, 1)
    kw = dict(iters=3, tol=0.0, ordering="morton", blk=128)
    got = cpals.cp_als_distributed(
        ft, 8, backend="pallas_fused_gather_stream", **kw)
    b1 = cpals.cp_als_distributed(ft, 8, backend="pallas_fused_gather", **kw)
    assert got.fits == b1.fits
    want = cpals.cp_als_distributed(
        ft, 8, device="cpu", backend="pallas_fused_gather_stream", **kw)
    np.testing.assert_allclose(got.fits, want.fits, rtol=0, atol=1e-5)
    for a, b in zip(got.factors, want.factors):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# B3, B4 (fused on pre-gathered rows) and B5 (scatter of a contribution)
# ---------------------------------------------------------------------------

def _fused_args(args):
    """B3's operands from B1's on the same aligned stream: each input
    factor's rows gathered by the aligned index stream (as ops does)."""
    vals, idx_al, fmats, rows, tob = args
    return vals, ops.pregathered_rows(idx_al, fmats), rows, tob


def _contrib(args):
    """B5's contribution: B1's products, (val * row_0) * row_1 ..."""
    vals, pre, _, _ = _fused_args(args)
    out = vals[:, None]
    for r in pre:
        out = out * r
    return out


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("rank", [16, 48, 256])
def test_fused_match_plain_and_b1_bitwise(cuda, k, rank):
    args = _operands(cuda, k, rank, rank, seed=20 + k + rank)
    kw = dict(rows_cap=96, blk=BLK, tile_rows=TILE)
    fargs = _fused_args(args)
    n3, n4 = K.fused_mttkrp_nmode.launches, K.fused_mttkrp_nmode_tiled.launches
    b3 = K.fused_mttkrp_nmode(*fargs, **kw)
    b4 = K.fused_mttkrp_nmode_tiled(*fargs, rank_slab=16, **kw)
    assert K.fused_mttkrp_nmode.launches == n3 + 1
    assert K.fused_mttkrp_nmode_tiled.launches == n4 + 1
    plain = K.fused_mttkrp_nmode_plain(*fargs, **kw)
    scale = float(plain.abs().max())
    assert torch.allclose(b3, plain, rtol=1e-5, atol=1e-5 * scale)
    assert torch.equal(b3, K.fused_mttkrp_nmode_gather(*args, **kw))
    assert torch.equal(b4, b3)
    assert torch.equal(b3, K.fused_mttkrp_nmode(*fargs, **kw))


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("rank", [16, 48, 256, 1024])
def test_segment_accumulate_matches_plain_and_b1_bitwise(cuda, k, rank):
    args = _operands(cuda, k, rank, min(rank, 128), seed=40 + k + rank)
    kw = dict(rows_cap=96, blk=BLK, tile_rows=TILE)
    contrib = _contrib(args)
    n5 = K.segment_accumulate.launches
    b5 = K.segment_accumulate(contrib, args[3], args[4], **kw)
    assert K.segment_accumulate.launches == n5 + 1
    plain = K.segment_accumulate_plain(contrib, args[3], args[4], **kw)
    scale = float(plain.abs().max())
    assert torch.allclose(b5, plain, rtol=1e-5, atol=1e-5 * scale)
    # B2 == B1 at any slab; B1 alone does not fit shared memory at 1024.
    b2 = K.fused_mttkrp_nmode_gather_tiled(*args, rank_slab=min(rank, 128),
                                           **kw)
    assert torch.equal(b5, b2)
    assert torch.equal(b5, K.segment_accumulate(contrib, args[3], args[4],
                                                **kw))


@pytest.mark.parametrize("blk,tile_rows", [(32, 1), (128, 4), (64, 16),
                                            (256, 3)])
def test_fused_geometries(cuda, blk, tile_rows):
    """B3 == B4 == B5 == B1 bitwise over groups of 16, 16, 8 and 16
    partial tiles and 16- and 32-lane groups."""
    rows_cap = 128 * tile_rows
    for rank, slab in ((16, 16), (64, 32)):
        args = _operands(cuda, 3, rank, rank, cap=20_000, rows_cap=rows_cap,
                         seed=blk + tile_rows, blk=blk, tile_rows=tile_rows)
        kw = dict(rows_cap=rows_cap, blk=blk, tile_rows=tile_rows)
        b1 = K.fused_mttkrp_nmode_gather(*args, **kw)
        fargs = _fused_args(args)
        assert torch.equal(K.fused_mttkrp_nmode(*fargs, **kw), b1)
        assert torch.equal(K.fused_mttkrp_nmode_tiled(*fargs, rank_slab=slab,
                                                      **kw), b1)
        assert torch.equal(K.segment_accumulate(_contrib(args), args[3],
                                                args[4], **kw), b1)


def test_fused_out_init_is_honoured(cuda):
    args = _operands(cuda, 2, 32, 32, seed=21)
    kw = dict(rows_cap=96, blk=BLK, tile_rows=TILE)
    fargs = _fused_args(args)
    init = torch.randn(96, 32, device=cuda)
    keep = init.clone()
    b3 = K.fused_mttkrp_nmode(*fargs, out_init=init, **kw)
    b4 = K.fused_mttkrp_nmode_tiled(*fargs, rank_slab=16, out_init=init,
                                    **kw)
    assert torch.equal(init, keep)
    want = K.fused_mttkrp_nmode_plain(*fargs, out_init=init, **kw)
    assert torch.allclose(b3, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(b3, b4)
    assert torch.equal(b3, K.fused_mttkrp_nmode_gather(*args, out_init=init,
                                                       **kw))
    # Padding only: the output is out_init.
    zero = torch.zeros_like(fargs[0])
    assert torch.equal(K.fused_mttkrp_nmode(zero, *fargs[1:], out_init=init,
                                            **kw), init)


def test_fused_wrong_operands_raise(cuda):
    args = _operands(cuda, 2, 16, 16, seed=22)
    kw = dict(rows_cap=96, blk=BLK, tile_rows=TILE)
    vals, pre, rows, tob = _fused_args(args)
    with pytest.raises(ValueError):
        K.fused_mttkrp_nmode(vals.cpu(), pre, rows, tob, **kw)
    with pytest.raises(ValueError):
        K.fused_mttkrp_nmode(vals, tuple(p[:, :8] for p in pre), rows, tob,
                             **kw)
    strided = torch.stack([pre[0], pre[0]], 2)[..., 0]
    with pytest.raises(ValueError):
        K.fused_mttkrp_nmode(vals, (strided, pre[1]), rows, tob, **kw)
    with pytest.raises(ValueError):
        K.segment_accumulate(pre[0][1:], rows[1:], tob, **kw)
    wide = _operands(cuda, 2, 512, 512, seed=23)
    with pytest.raises(ValueError, match="shared memory"):
        K.fused_mttkrp_nmode(*_fused_args(wide), **kw)


_COUNTERS = {
    "pallas_fused_gather": K.fused_mttkrp_nmode_gather,
    "pallas_fused_gather_tiled": K.fused_mttkrp_nmode_gather_tiled,
    ops.STREAM_BACKEND: K.fused_mttkrp_nmode_gather_stream,
    "pallas_fused": K.fused_mttkrp_nmode,
    "pallas_fused_tiled": K.fused_mttkrp_nmode_tiled,
    "pallas": K.segment_accumulate,
}


@pytest.mark.parametrize("want,rank,frows,blk,budgets", [
    ("pallas_fused_gather", 16, None, 64, {}),
    ("pallas_fused_gather_tiled", 256, (300, 200), 64,
     {"l2_budget": 500 * 128 * 4}),
    (ops.STREAM_BACKEND, 16, None, 64, {"l2_budget": 0}),
    ("pallas_fused", 16, (4000, 4000), 512, {"l2_budget": 0}),
    ("pallas_fused_tiled", 512, (4000, 4000), 512, {"l2_budget": 0}),
    ("pallas", 16, None, 64, {"l2_budget": 0, "smem_budget": 1000}),
])
def test_auto_lands_on_each_rung(cuda, want, rank, frows, blk, budgets):
    """``auto`` through mttkrp_device_step launches the rung's kernel, and
    only it, and computes what ``ref`` computes."""
    idx, val, valid, factors = _stream(cuda, 2, rank, 5000, 96, seed=30,
                                       frows=frows)
    kw = dict(mode=0, rows_cap=96, blk=blk, tile_rows=TILE)
    assert ops.select_backend(
        "auto", nmodes=3, rank=rank, blk=blk, tile_rows=TILE,
        factor_rows=[f.shape[0] for f in factors[1:]], **budgets) == want
    before = {b: c.launches for b, c in _COUNTERS.items()}
    got = ops.mttkrp_device_step(idx, val, valid, factors, backend="auto",
                                 **budgets, **kw)
    moved = {b for b, c in _COUNTERS.items() if c.launches != before[b]}
    assert moved == {want}
    assert _COUNTERS[want].launches == before[want] + 1
    ref = ops.mttkrp_device_step(idx, val, valid, factors, backend="ref",
                                 **kw)
    scale = float(ref.abs().max())
    assert torch.allclose(got, ref, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("ordering", ["none", "morton"])
def test_device_step_backends_bitwise(cuda, ordering):
    """On one aligned stream the fused and gather backends agree bitwise
    per ordering; pallas (B5, no ordering) agrees with B1 unordered."""
    idx, val, valid, factors = _stream(cuda, 3, 16, 6000, 96, seed=31)
    kw = dict(mode=0, rows_cap=96, blk=BLK, tile_rows=TILE)
    b1 = ops.mttkrp_device_step(idx, val, valid, factors, ordering=ordering,
                                backend="pallas_fused_gather", **kw)
    for backend in ("pallas_fused", "pallas_fused_tiled"):
        assert torch.equal(b1, ops.mttkrp_device_step(
            idx, val, valid, factors, ordering=ordering, backend=backend,
            **kw))
    if ordering == "none":
        assert torch.equal(b1, ops.mttkrp_device_step(
            idx, val, valid, factors, backend="pallas", **kw))


def test_fused_cp_als_on_card(cuda):
    """pallas_fused, pallas_fused_tiled and pallas give B1's fits exactly
    (bitwise equal kernels) and match the CPU run; auto lands on B1."""
    t = tensors.random_sparse_tensor((40, 30, 20), 2000, seed=0)
    ft = flycoo.build_flycoo(t, 1)
    b1 = cpals.cp_als_distributed(ft, 8, iters=3, tol=0.0,
                                  backend="pallas_fused_gather")
    for backend in ("auto", "pallas_fused", "pallas_fused_tiled", "pallas"):
        got = cpals.cp_als_distributed(ft, 8, iters=3, tol=0.0,
                                       backend=backend)
        assert got.fits == b1.fits, backend
        want = cpals.cp_als_distributed(ft, 8, device="cpu", iters=3,
                                        tol=0.0, backend=backend)
        np.testing.assert_allclose(got.fits, want.fits, rtol=0, atol=1e-5)
        for a, b in zip(got.factors, want.factors):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# The redesigned B6 ring and B1/B2 staging: edges of runs, rings and chunks
# ---------------------------------------------------------------------------

def _runs_operands(dev, k, rank, runs, *, blk=BLK, seed=0, pad_blocks=(),
                   frows=(200, 300, 150, 90)):
    """A block-aligned stream with ``runs[t]`` blocks for output tile t
    (random slots; the blocks in ``pad_blocks`` hold padding only) and
    its factors. Returns ``(vals, idx, factors, rows, tob), rows_cap``."""
    rng = np.random.default_rng(seed)
    n = int(sum(runs)) * blk
    vals = rng.standard_normal(n).astype(np.float32)
    for b in pad_blocks:
        vals[b * blk:(b + 1) * blk] = 0.0
    idx = np.stack([rng.integers(0, frows[w], n) for w in range(k)], 1)
    factors = [torch.from_numpy(rng.standard_normal(
        (frows[w], rank)).astype(np.float32)).to(dev) for w in range(k)]
    tob = np.repeat(np.arange(len(runs)), runs).astype(np.int32)
    rows = rng.integers(0, TILE, n).astype(np.int32)
    args = (torch.from_numpy(vals).to(dev),
            torch.from_numpy(idx.astype(np.int32)).to(dev), factors,
            torch.from_numpy(rows).to(dev), torch.from_numpy(tob).to(dev))
    return args, len(runs) * TILE


def _b6_args(args, blk=BLK, widths=None):
    """B6's operands; ``widths`` widens each schedule row to that many
    entries with entries that repeat entry 0 (which the kernel skips)."""
    vals, idx, factors, rows, tob = args
    fm = tuple(ops._pad_factor_rows(f, K.FACTOR_ROW_TILE) for f in factors)
    scheds, windows, _ = ops.stream_schedules(idx, blk,
                                              [f.shape[0] for f in fm])
    if widths is not None:
        scheds = tuple(torch.cat([s, s[:, :1].expand(-1, w - s.shape[1])],
                                 1).contiguous()
                       for s, w in zip(scheds, widths))
        windows = tuple(widths)
    return (vals, idx, fm, rows, tob, scheds), tuple(windows)


def _check_b6(args6, rows_cap, *, blk=BLK, rank_slab=16):
    """B6 == B1 bitwise, close to its plain version; returns B6."""
    kw = dict(rows_cap=rows_cap, blk=blk, tile_rows=TILE)
    b6 = K.fused_mttkrp_nmode_gather_stream(*args6, rank_slab=rank_slab,
                                            **kw)
    assert torch.equal(b6, K.fused_mttkrp_nmode_gather(*args6[:5], **kw))
    plain = K.fused_mttkrp_nmode_gather_stream_plain(
        *args6, rank_slab=rank_slab, **kw)
    scale = float(plain.abs().max())
    assert torch.allclose(b6, plain, rtol=1e-5, atol=1e-5 * scale)
    return b6


def _ring_stages(k, rank, windows):
    return K.stream_ring(k, rank, BLK, TILE, windows)[0]


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("rank", [16, 64])
def test_stream_runs_around_the_ring_depth(cuda, k, rank):
    """Tiles with runs of 1, S-1, S and S+1 blocks (S the ring's stages),
    an empty tile, and a run of 2S+1 blocks; R=64 copies each tile row
    on its own (ld > slab)."""
    # Schedules widened to the data-blind width min(blk, ceil(rows / 8)),
    # so the ring's depth is known before the stream is drawn.
    widths = [min(BLK, -(-r // K.FACTOR_ROW_TILE))
              for r in (200, 300, 150, 90)[:k]]
    s = _ring_stages(k, rank, widths)
    runs = [r for r in (1, s - 1, s, s + 1, 0, 2 * s + 1)]
    args, rows_cap = _runs_operands(cuda, k, rank, runs, seed=10 + k)
    _check_b6(_b6_args(args, widths=widths)[0], rows_cap)


@pytest.mark.parametrize("k", [2, 3])
def test_stream_chunk_ends_at_every_ring_phase(cuda, k):
    """A chunk ending after each of the first S+1 blocks of a tile's run
    (every ring phase, and past the ring) hands on its partials, and the
    two calls give the single pass's bits."""
    args, rows_cap = _runs_operands(cuda, k, 16, [2, 40, 3], seed=20 + k)
    args6, windows = _b6_args(args)
    s = _ring_stages(k, 16, windows)
    single = _check_b6(args6, rows_cap)
    vals, idx, fm, rows, tob, scheds = args6
    kw = dict(rows_cap=rows_cap, blk=BLK, tile_rows=TILE)
    nb = tob.shape[0]
    for cut in range(3, 3 + s + 1):
        a, b = slice(0, cut * BLK), slice(cut * BLK, nb * BLK)
        out, carry = K.fused_mttkrp_nmode_gather_stream_chunk(
            vals[a], idx[a], fm, rows[a], tob[:cut],
            tuple(x[:cut].contiguous() for x in scheds), split_tail=True,
            **kw)
        assert carry is not None and carry.tile == 1
        out, carry = K.fused_mttkrp_nmode_gather_stream_chunk(
            vals[b], idx[b], fm, rows[b], tob[cut:],
            tuple(x[cut:].contiguous() for x in scheds), out_init=out,
            carry=carry, **kw)
        assert carry is None
        assert torch.equal(out, single), cut


@pytest.mark.parametrize("rank", [16, 64])
def test_stream_padding_blocks_between_real_ones(cuda, rank):
    """Blocks of padding only inside runs (one, and three in a row) copy
    nothing and add nothing; the bits are B1's."""
    args, rows_cap = _runs_operands(cuda, 3, rank, [10, 12, 6], seed=30,
                                    pad_blocks=(3, 11, 12, 13, 27))
    _check_b6(_b6_args(args)[0], rows_cap)


@pytest.mark.parametrize("width", ["one", "blk"])
@pytest.mark.parametrize("rank", [16, 64])
def test_stream_schedule_widths_one_and_blk(cuda, width, rank):
    """Every block reads one tile per mode (width 1), or every slot a
    tile of its own (width blk, no runs to merge when the tiles are
    spread)."""
    _check_schedule_width(cuda, width, rank, torch.float32)


def _check_schedule_width(cuda, width, rank, dtype):
    args, rows_cap = _runs_operands(cuda, 2, rank, [3, 5, 2], seed=40,
                                    frows=(8 * 2 * BLK, 8 * 2 * BLK))
    if dtype == torch.bfloat16:
        args = _to_bf16(args)
    vals, idx, factors, rows, tob = args
    rng = np.random.default_rng(41)
    nb = tob.shape[0]
    if width == "one":
        tiles = rng.integers(0, 2 * BLK, (nb, 1, 2))
        new = tiles * 8 + rng.integers(0, 8, (nb, BLK, 2))
    else:
        tiles = np.stack([np.stack([rng.permutation(2 * BLK)[:BLK]
                                    for _ in range(2)], 1)
                          for _ in range(nb)])
        new = tiles * 8 + rng.integers(0, 8, (nb, BLK, 2))
    idx = torch.from_numpy(new.reshape(-1, 2).astype(np.int32)).to(cuda)
    args6, windows = _b6_args((vals, idx, factors, rows, tob))
    assert windows == ((1, 1) if width == "one" else (BLK, BLK))
    _check_b6(args6, rows_cap)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("extra", [1, 2, 3])
def test_stream_odd_schedule_widths(cuda, k, extra):
    """Schedule rows widened by entries that repeat entry 0 (so of odd and
    even widths, not 16-byte aligned): the same bits."""
    args, rows_cap = _runs_operands(cuda, k, 16, [4, 6, 3], seed=50 + k)
    windows = _b6_args(args)[1]
    widths = [w + extra + (w + extra + 1) % 2 for w in windows]
    assert all(w % 2 for w in widths)
    _check_b6(_b6_args(args, widths=widths)[0], rows_cap)


def _check_b1_b2(args, rows_cap, rank, *, blk):
    kw = dict(rows_cap=rows_cap, blk=blk, tile_rows=TILE)
    slab = ops.tiled_rank_slab(rank)
    b1 = K.fused_mttkrp_nmode_gather(*args, **kw)
    plain = K.fused_mttkrp_nmode_gather_plain(*args, **kw)
    scale = float(plain.abs().max())
    assert torch.allclose(b1, plain, rtol=1e-5, atol=1e-5 * scale)
    assert torch.equal(b1, K.fused_mttkrp_nmode_gather_tiled(
        *args, rank_slab=slab, **kw))


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("rank", [16, 32, 256])
def test_gather_runs_at_the_staging_edge(cuda, k, rank):
    """Runs ending one block before, at and one block after a staging
    buffer's edge (blk=4), and a run whose last nonzero sits one slot
    before, at and after the edge (padding behind it)."""
    chunk = K.STAGE_SLOTS // K.STAGE_BUFFERS
    blk = 4
    runs = [chunk // blk - 1, chunk // blk, chunk // blk + 1,
            2 * chunk // blk + 3]
    args, rows_cap = _runs_operands(cuda, k, rank, runs, blk=blk,
                                    seed=60 + k)
    _check_b1_b2(args, rows_cap, rank, blk=blk)
    start = sum(runs[:3]) * blk
    for last in (chunk - 1, chunk, chunk + 1):
        vals = args[0].clone()
        vals[start + last:] = 0.0
        _check_b1_b2((vals,) + args[1:], rows_cap, rank, blk=blk)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("rank", [16, 32, 256])
def test_gather_padding_chunks_on_the_last_tile(cuda, k, rank):
    """The last tile's run ends in many staging buffers of padding only
    (as the aligned stream's clipped blocks do)."""
    runs = [5, 3, 120]
    args, rows_cap = _runs_operands(cuda, k, rank, runs, seed=70 + k,
                                    pad_blocks=range(12, 128))
    _check_b1_b2(args, rows_cap, rank, blk=BLK)


# ---------------------------------------------------------------------------
# bf16 gathers: the bf16 variants of B1, B2, B3, B4 and B6, each held
# bitwise against the bf16 B1 (one product order, exact bf16 -> fp32)
# ---------------------------------------------------------------------------

def _to_bf16(args):
    """The same operands with bf16 factors."""
    vals, idx, factors, rows, tob = args
    return vals, idx, [f.to(torch.bfloat16) for f in factors], rows, tob


def _bf16_counts():
    return {n: (getattr(K, n).launches, getattr(K, n).launches_bf16)
            for n in ("fused_mttkrp_nmode_gather",
                      "fused_mttkrp_nmode_gather_tiled",
                      "fused_mttkrp_nmode", "fused_mttkrp_nmode_tiled",
                      "fused_mttkrp_nmode_gather_stream")}


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("rank", [16, 48, 256])
def test_bf16_kernels_match_plain_and_b1_bitwise(cuda, k, rank):
    idx, val, valid, factors = _stream(cuda, k, rank, 5000, 96, seed=k)
    kw = dict(rows_cap=96, blk=BLK, tile_rows=TILE)
    args = ops.gather_operands(idx, val, valid, factors, mode=0, rows_cap=96,
                               row_offset=0, blk=BLK, tile_rows=TILE,
                               slab=ops.padded_rank(rank),
                               dtype=torch.bfloat16)
    assert args[2][0].dtype == torch.bfloat16
    before = _bf16_counts()
    b1 = K.fused_mttkrp_nmode_gather(*args, **kw)
    plain = K.fused_mttkrp_nmode_gather_plain(*args, **kw)
    scale = float(plain.abs().max())
    assert b1.dtype == torch.float32
    assert torch.allclose(b1, plain, rtol=1e-5, atol=1e-5 * scale)
    assert torch.equal(b1, K.fused_mttkrp_nmode_gather(*args, **kw))
    slab = ops.tiled_rank_slab(rank)
    assert torch.equal(b1, K.fused_mttkrp_nmode_gather_tiled(
        *args, rank_slab=slab, **kw))
    vals, idx_al, fmats, rows, tob = args
    pre = ops.pregathered_rows(idx_al, fmats)
    assert torch.equal(b1, K.fused_mttkrp_nmode(vals, pre, rows, tob, **kw))
    assert torch.equal(b1, K.fused_mttkrp_nmode_tiled(
        vals, pre, rows, tob, rank_slab=16, **kw))
    if rank <= 64:
        s_args = _stream_args(args)
        assert torch.equal(b1, K.fused_mttkrp_nmode_gather_stream(
            *s_args, rank_slab=16, **kw))
    after = _bf16_counts()
    # Only the bf16 variants launched, each as often as it was called.
    for name, (f32, b16) in after.items():
        assert f32 == before[name][0], name
    assert after["fused_mttkrp_nmode_gather"][1] \
        == before["fused_mttkrp_nmode_gather"][1] + 2
    assert after["fused_mttkrp_nmode_gather_stream"][1] \
        == before["fused_mttkrp_nmode_gather_stream"][1] + (rank <= 64)
    # bf16 gathers differ from fp32 ones by the rounding of the factors.
    f32 = K.fused_mttkrp_nmode_gather(*ops.gather_operands(
        idx, val, valid, factors, mode=0, rows_cap=96, row_offset=0,
        blk=BLK, tile_rows=TILE, slab=ops.padded_rank(rank)), **kw)
    assert not torch.equal(b1, f32)


def _bf16_ring_stages(k, rank, windows):
    return K.stream_ring(k, rank, BLK, TILE, windows, gather_itemsize=2)[0]


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("rank", [16, 64])
def test_bf16_stream_runs_around_the_ring_depth(cuda, k, rank):
    """The bf16 ring (the deepest two CTAs of which share an SM): runs of
    1, S-1, S, S+1 blocks, an empty tile and a run of 2S+1; bitwise the
    bf16 B1."""
    widths = [min(BLK, -(-r // K.FACTOR_ROW_TILE))
              for r in (200, 300, 150, 90)[:k]]
    s = _bf16_ring_stages(k, rank, widths)
    assert s >= 2 and 2 * (K.gather_stream_smem_bytes(
        k, rank, BLK, TILE, widths, stages=s, mappers=K.MAX_STREAM_MAPPERS,
        gather_itemsize=2) + K.CTA_SMEM_RESERVED) <= K.SM_SMEM_BYTES
    runs = [1, max(s - 1, 0), s, s + 1, 0, 2 * s + 1]
    args, rows_cap = _runs_operands(cuda, k, rank, runs, seed=110 + k)
    _check_b6(_b6_args(_to_bf16(args), widths=widths)[0], rows_cap)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_bf16_stream_chunk_ends_at_every_ring_phase(cuda, k):
    """bf16 chunks ending after each of the first S+1 blocks of a run hand
    on their partials: two calls give the single pass's bits."""
    args, rows_cap = _runs_operands(cuda, k, 16, [2, 40, 3], seed=120 + k)
    args6, windows = _b6_args(_to_bf16(args))
    s = _bf16_ring_stages(k, 16, windows)
    single = _check_b6(args6, rows_cap)
    vals, idx, fm, rows, tob, scheds = args6
    kw = dict(rows_cap=rows_cap, blk=BLK, tile_rows=TILE)
    nb = tob.shape[0]
    for cut in range(3, 3 + s + 1):
        a, b = slice(0, cut * BLK), slice(cut * BLK, nb * BLK)
        out, carry = K.fused_mttkrp_nmode_gather_stream_chunk(
            vals[a], idx[a], fm, rows[a], tob[:cut],
            tuple(x[:cut].contiguous() for x in scheds), split_tail=True,
            **kw)
        out, carry = K.fused_mttkrp_nmode_gather_stream_chunk(
            vals[b], idx[b], fm, rows[b], tob[cut:],
            tuple(x[cut:].contiguous() for x in scheds), out_init=out,
            carry=carry, **kw)
        assert carry is None
        assert torch.equal(out, single), cut


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("rank", [16, 32, 256])
def test_bf16_gather_runs_at_the_staging_edge(cuda, k, rank):
    """The bf16 B1 and B2 with runs at a staging buffer's edge +-1 and the
    last nonzero one slot before, at and after it."""
    chunk = K.STAGE_SLOTS // K.STAGE_BUFFERS
    blk = 4
    runs = [chunk // blk - 1, chunk // blk, chunk // blk + 1,
            2 * chunk // blk + 3]
    args, rows_cap = _runs_operands(cuda, k, rank, runs, blk=blk,
                                    seed=160 + k)
    args = _to_bf16(args)
    _check_b1_b2(args, rows_cap, rank, blk=blk)
    start = sum(runs[:3]) * blk
    for last in (chunk - 1, chunk, chunk + 1):
        vals = args[0].clone()
        vals[start + last:] = 0.0
        _check_b1_b2((vals,) + args[1:], rows_cap, rank, blk=blk)


@pytest.mark.parametrize("ordering", ["none", "morton"])
def test_bf16_device_step_backends_bitwise(cuda, ordering):
    """Every fused-family backend in bf16, and both bf16 names, give the
    bf16 B1's bits on one stream; pallas and ref ignore the dtype (ref's
    index_add_ adds with float atomics, so two of its runs agree only to
    fp32 rounding)."""
    idx, val, valid, factors = _stream(cuda, 2, 16, 20_000, 96, seed=7)
    kw = dict(mode=0, rows_cap=96, row_offset=0, blk=BLK, tile_rows=TILE,
              ordering=ordering)
    base = ops.mttkrp_device_step(idx, val, valid, factors,
                                  backend="pallas_fused_gather",
                                  gather_dtype="bfloat16", **kw)
    for backend in ("pallas_fused", "pallas_fused_tiled",
                    "pallas_fused_gather_tiled",
                    "pallas_fused_gather_stream"):
        assert torch.equal(base, ops.mttkrp_device_step(
            idx, val, valid, factors, backend=backend,
            gather_dtype="bfloat16", **kw)), backend
    for name in ("pallas_fused_bf16", "pallas_fused_gather_bf16"):
        assert torch.equal(base, ops.mttkrp_device_step(
            idx, val, valid, factors, backend=name, **kw)), name
    assert torch.equal(
        ops.mttkrp_device_step(idx, val, valid, factors, backend="pallas",
                               gather_dtype="bfloat16", **kw),
        ops.mttkrp_device_step(idx, val, valid, factors, backend="pallas",
                               **kw))
    ref = ops.mttkrp_device_step(idx, val, valid, factors, backend="ref",
                                 **kw)
    assert torch.allclose(
        ops.mttkrp_device_step(idx, val, valid, factors, backend="ref",
                               gather_dtype="bfloat16", **kw),
        ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))


def test_bf16_chunked_equals_single_pass(cuda):
    idx, val, valid, factors = _stream(cuda, 2, 16, 60_000, 64, seed=8)
    kw = dict(mode=0, rows_cap=64, blk=BLK, tile_rows=TILE,
              ordering="morton", gather_dtype="bfloat16", device=cuda)
    single, s1 = executor.mttkrp_out_of_core(idx, val, valid, factors, **kw)
    budget = 7 * planner.stream_chunk_bytes(BLK, 2, s1.window_tiles)
    chunked, s2 = executor.mttkrp_out_of_core(idx, val, valid, factors,
                                              max_chunk_bytes=budget, **kw)
    assert s2.chunks > 5
    assert torch.equal(chunked, single)
    f32 = executor.mttkrp_out_of_core(
        idx, val, valid, factors, **dict(kw, gather_dtype="float32"))[1]
    assert s1.distinct_tile_bytes * 2 == f32.distinct_tile_bytes


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("rank", [64, 96, 256])
def test_bf16_gather_16_byte_rows_at_the_staging_edge(cuda, k, rank):
    """The bf16 B1 and B2 where B1's slab takes the 16-byte row loads
    (R >= BF16_VEC_MIN_SLAB; 96: 12 lanes a group, not a power of two;
    256: 32 lanes, 512-thread CTAs, B2's 128-column slabs):
    runs at a staging buffer's edge +-1 and the last nonzero one slot
    before, at and after it."""
    assert rank >= K.BF16_VEC_MIN_SLAB
    chunk = K.STAGE_SLOTS // K.STAGE_BUFFERS
    blk = 4
    runs = [chunk // blk - 1, chunk // blk, chunk // blk + 1,
            2 * chunk // blk + 3]
    args, rows_cap = _runs_operands(cuda, k, rank, runs, blk=blk,
                                    seed=260 + k)
    args = _to_bf16(args)
    _check_b1_b2(args, rows_cap, rank, blk=blk)
    start = sum(runs[:3]) * blk
    for last in (chunk - 1, chunk, chunk + 1):
        vals = args[0].clone()
        vals[start + last:] = 0.0
        _check_b1_b2((vals,) + args[1:], rows_cap, rank, blk=blk)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("rank", [16, 64, 256])
def test_bf16_gather_padding_chunks_on_the_last_tile(cuda, k, rank):
    """The bf16 B1 and B2: the last tile's run ends in many staging
    buffers of padding only."""
    args, rows_cap = _runs_operands(cuda, k, rank, [5, 3, 120],
                                    seed=270 + k, pad_blocks=range(12, 128))
    _check_b1_b2(_to_bf16(args), rows_cap, rank, blk=BLK)


@pytest.mark.parametrize("rank", [16, 64])
def test_bf16_stream_padding_blocks_between_real_ones(cuda, rank):
    """The bf16 B6: blocks of padding only inside runs copy and add
    nothing; the bits are the bf16 B1's."""
    args, rows_cap = _runs_operands(cuda, 3, rank, [10, 12, 6], seed=130,
                                    pad_blocks=(3, 11, 12, 13, 27))
    _check_b6(_b6_args(_to_bf16(args))[0], rows_cap)


@pytest.mark.parametrize("width", ["one", "blk"])
@pytest.mark.parametrize("rank", [16, 64])
def test_bf16_stream_schedule_widths_one_and_blk(cuda, width, rank):
    """The bf16 B6 with one tile per block and mode, and with a tile per
    slot (no runs)."""
    _check_schedule_width(cuda, width, rank, torch.bfloat16)


def test_bf16_gather_checks_factor_alignment(cuda):
    """The bf16 B1 at a slab of 64 reads factor rows 16 bytes at a time:
    a factor whose base is not 16-byte aligned is refused by name."""
    args, rows_cap = _runs_operands(cuda, 2, 64, [2, 3], seed=140)
    vals, idx, factors, rows, tob = _to_bf16(args)
    flat = torch.zeros(factors[0].numel() + 8, dtype=torch.bfloat16,
                       device=cuda)
    bad = flat[1:1 + factors[0].numel()].view(factors[0].shape)
    bad.copy_(factors[0])
    assert bad.is_contiguous() and bad.data_ptr() % 16
    with pytest.raises(ValueError, match=r"factors\[0\]"):
        K.fused_mttkrp_nmode_gather(vals, idx, [bad, factors[1]], rows, tob,
                                    rows_cap=rows_cap, blk=BLK,
                                    tile_rows=TILE)


def test_bf16_cp_als_on_card_matches_cpu(cuda):
    t, _ = tensors.low_rank_sparse_tensor((60, 50, 40), 3, 20_000, seed=0)
    ft = flycoo.build_flycoo(t, 1)
    kw = dict(iters=4, tol=0.0, seed=1, backend="pallas_fused_gather_bf16")
    gpu = cpals.cp_als_distributed(ft, 3, device=cuda, **kw)
    cpu = cpals.cp_als_distributed(ft, 3, device="cpu", **kw)
    np.testing.assert_allclose(gpu.fits, cpu.fits, rtol=2 * 2.0 ** -8,
                               atol=0)
    np.testing.assert_allclose(gpu.fits[0], cpu.fits[0], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# B3/B4's ring: run edges, rings forced through the wrapper, persistent CTAs
# that cross tiles, wide ranks, bf16, slabs narrower than the row, alignment
# ---------------------------------------------------------------------------

# (stages, slots) forced on the wrapper (None: the ring it picks): one
# stage, stages narrower and wider than the runs, a deep ring.
FUSED_RINGS = [None, (1, 16), (2, 32), (3, 64), (6, 32), (2, 128)]
FUSED_BLK = 8


def _edge_runs():
    """Runs (in 8-slot blocks) of every shape the ring meets: shorter than
    a stage, none, mid-stage ends, one whole stage and one past it, one
    whole meta chunk and one past it; a run with a padding stage and a
    whole padding chunk inside; a padding-only run; and a last tile of 20
    real blocks and 400 padding blocks (the clipped padding's shape)."""
    runs = [1, 0, 3, 16, 17, 128, 129, 300, 5, 2, 420]
    first = np.cumsum([0] + runs)
    pad = list(range(first[7] + 16, first[7] + 32))
    pad += list(range(first[7] + 128, first[7] + 256))
    pad += list(range(first[8], first[9]))
    pad += list(range(first[10] + 20, first[11]))
    return runs, pad


def _check_fused_ring(args, rows_cap, *, slab, dtype, blk=FUSED_BLK):
    """B3 == B4 (``slab`` columns a slab) == B1 bitwise in ``dtype``, B3
    close to its plain version, a rerun bitwise equal."""
    vals, idx, factors, rows, tob = args
    factors = [f.to(dtype) for f in factors]
    kw = dict(rows_cap=rows_cap, blk=blk, tile_rows=TILE)
    pre = ops.pregathered_rows(idx, factors)
    b1 = K.fused_mttkrp_nmode_gather(vals, idx, factors, rows, tob, **kw)
    b3 = K.fused_mttkrp_nmode(vals, pre, rows, tob, **kw)
    b4 = K.fused_mttkrp_nmode_tiled(vals, pre, rows, tob, rank_slab=slab,
                                    **kw)
    plain = K.fused_mttkrp_nmode_plain(vals, pre, rows, tob, **kw)
    scale = float(plain.abs().max())
    assert torch.allclose(b3, plain, rtol=1e-5, atol=1e-5 * scale)
    assert torch.equal(b3, b1)
    assert torch.equal(b4, b1)
    assert torch.equal(b3, K.fused_mttkrp_nmode(vals, pre, rows, tob, **kw))


@pytest.mark.parametrize("ring", FUSED_RINGS, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rank,slab", [(16, 16), (32, 16)])
def test_fused_ring_at_run_edges(cuda, monkeypatch, ring, dtype, rank,
                                 slab):
    """Every run edge against every ring, B4 with the whole row (one bulk
    copy per row array) and with a 16-column slab of a 32-column row (the
    2-D tensor copy)."""
    if ring is not None:
        monkeypatch.setattr(K, "fused_ring", lambda *a, **kw: ring)
    runs, pad = _edge_runs()
    args, rows_cap = _runs_operands(cuda, 3, rank, runs, blk=FUSED_BLK,
                                    seed=80 + rank, pad_blocks=pad)
    _check_fused_ring(args, rows_cap, slab=slab, dtype=dtype)


@pytest.mark.parametrize("ring", [None, (1, 16), (3, 64)], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_persistent_ctas_cross_tiles(cuda, monkeypatch, ring, dtype):
    """6000 tiles of 0..6 blocks, some of padding only: far more work
    items than resident CTAs, so each CTA takes many tiles in turn and
    reduces one while its ring fills with the next."""
    if ring is not None:
        monkeypatch.setattr(K, "fused_ring", lambda *a, **kw: ring)
    rng = np.random.default_rng(90)
    runs = [int(x) for x in rng.integers(0, 7, 6000)]
    pad = [int(b) for b in rng.choice(sum(runs), sum(runs) // 10,
                                      replace=False)]
    args, rows_cap = _runs_operands(cuda, 2, 32, runs, blk=FUSED_BLK,
                                    seed=91, pad_blocks=pad)
    _check_fused_ring(args, rows_cap, slab=16, dtype=dtype)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_ring_at_a_wide_rank(cuda, k, dtype):
    """R=256: B3 on a ring of narrow stages beside 128 KB of partials, B4
    in 128-column slabs of the 256-column rows (the tensor copy's widest
    common box), both == B1."""
    runs, pad = _edge_runs()
    args, rows_cap = _runs_operands(cuda, k, 256, runs[:8], blk=FUSED_BLK,
                                    seed=95 + k,
                                    pad_blocks=[b for b in pad
                                                if b < sum(runs[:8])])
    _check_fused_ring(args, rows_cap, slab=128, dtype=dtype)


def _misaligned_like(t):
    """A contiguous copy of ``t`` starting 4 bytes past a 16-byte
    boundary."""
    n = t.numel()
    step = 4 // t.element_size()
    base = torch.zeros(n + step, dtype=t.dtype, device=t.device)
    out = base[step:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("bad", ["vals", "local_row_in_tile",
                                 "factor_rows[0]", "factor_rows[1]"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_misaligned_operand_raises(cuda, bad, dtype):
    """The bulk copies need 16-byte-aligned operands: a misaligned one
    raises, naming it, before any launch; there is no fallback."""
    args = _operands(cuda, 2, 16, 16, seed=24)
    vals, pre, rows, tob = _fused_args(args)
    pre = [p.to(dtype) for p in pre]
    kw = dict(rows_cap=96, blk=BLK, tile_rows=TILE)
    if bad == "vals":
        vals = _misaligned_like(vals)
    elif bad == "local_row_in_tile":
        rows = _misaligned_like(rows)
    else:
        w = int(bad[-2])
        pre[w] = _misaligned_like(pre[w])
    n3, n4 = (K.fused_mttkrp_nmode.launches + K.fused_mttkrp_nmode
              .launches_bf16, K.fused_mttkrp_nmode_tiled.launches
              + K.fused_mttkrp_nmode_tiled.launches_bf16)
    with pytest.raises(ValueError, match=re.escape(bad)):
        K.fused_mttkrp_nmode(vals, tuple(pre), rows, tob, **kw)
    with pytest.raises(ValueError, match=re.escape(bad)):
        K.fused_mttkrp_nmode_tiled(vals, tuple(pre), rows, tob,
                                   rank_slab=16, **kw)
    assert (K.fused_mttkrp_nmode.launches
            + K.fused_mttkrp_nmode.launches_bf16,
            K.fused_mttkrp_nmode_tiled.launches
            + K.fused_mttkrp_nmode_tiled.launches_bf16) == (n3, n4)


@pytest.mark.parametrize("ring", [(2, 512), (1, 1024)], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_stage_wider_than_a_tensor_box(cuda, monkeypatch, ring, dtype):
    """B4 with a 16-column slab of 32-column rows and stages of more rows
    than one 2-D tensor copy takes (256): several boxes per row array, the
    last ones past the array's end zero-filled and never read."""
    monkeypatch.setattr(K, "fused_ring", lambda *a, **kw: ring)
    runs, pad = _edge_runs()
    args, rows_cap = _runs_operands(cuda, 2, 32, runs, blk=FUSED_BLK,
                                    seed=97, pad_blocks=pad)
    vals, idx, factors, rows, tob = args
    factors = [f.to(dtype) for f in factors]
    kw = dict(rows_cap=rows_cap, blk=FUSED_BLK, tile_rows=TILE)
    pre = ops.pregathered_rows(idx, factors)
    b4 = K.fused_mttkrp_nmode_tiled(vals, pre, rows, tob, rank_slab=16, **kw)
    plain = K.fused_mttkrp_nmode_tiled_plain(vals, pre, rows, tob,
                                             rank_slab=16, **kw)
    scale = float(plain.abs().max())
    assert torch.allclose(b4, plain, rtol=1e-5, atol=1e-5 * scale)
    assert torch.equal(b4, K.fused_mttkrp_nmode_gather(vals, idx, factors,
                                                       rows, tob, **kw))


# ---------------------------------------------------------------------------
# D > 1 workers in one process (LocalWorkers): row offsets on the card
# ---------------------------------------------------------------------------

WORKER_BACKENDS = ("auto", "pallas_fused_gather", "pallas_fused_gather_tiled",
                   "pallas_fused", "pallas_fused_tiled", "pallas",
                   "pallas_fused_gather_stream")
SMALL_FLYCOO = dict(m_bounds=(2, 8), g_bounds=(8, 64), cache_bytes=1 << 20)


@pytest.mark.parametrize("D", [2, 4])
def test_workers_backends_bitwise_and_match_cpu(cuda, D):
    """Every backend at D workers, each worker's step at its row offset:
    bitwise equal to B1 on the card, allclose to the CPU plain run; CP-ALS
    on the card matches the CPU run."""
    from repro_torch.core import distributed as dist
    from repro_torch.core.workers import LocalWorkers
    t = tensors.random_sparse_tensor((30, 20, 10), 500, seed=3)
    ft = flycoo.build_flycoo(t, D, **SMALL_FLYCOO)
    rt, packed = dist.prepare_runtime(ft, 8)
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        wk = LocalWorkers(D, dev)
        stream, factors, _, _ = cpals.device_state(ft, rt, packed, seed=0,
                                                   workers=wk)
        for backend in WORKER_BACKENDS:
            got, _, diags = dist.make_spmttkrp_all_modes(
                rt, wk, backend=backend)(*stream, *factors)
            assert int(diags["dropped"].sum()) == 0
            outs[dev.type, backend] = [o.cpu() for o in got]
    for backend in WORKER_BACKENDS:
        for a, b, p in zip(outs["cuda", backend],
                           outs["cuda", "pallas_fused_gather"],
                           outs["cpu", "pallas_fused_gather"]):
            assert torch.equal(a, b), backend
            scale = float(p.abs().max())
            assert torch.allclose(a, p, rtol=1e-5, atol=1e-5 * scale)
    got = cpals.cp_als_distributed(ft, 8, iters=3, tol=0.0, backend="auto")
    want = cpals.cp_als_distributed(ft, 8, device="cpu", iters=3, tol=0.0,
                                    backend="auto")
    np.testing.assert_allclose(got.fits, want.fits, rtol=0, atol=1e-5)
    for a, b in zip(got.factors, want.factors):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_worker_3_padding_at_row_0_changes_nothing(cuda):
    """Worker 3's padding slots pointing at row 0 (as after a remap), at
    its own first row (as packed) or cut off: B6's windows and every
    backend's output at worker 3's row offset are the same."""
    from repro_torch.core import distributed as dist
    t = tensors.random_sparse_tensor((30, 20, 10), 500, seed=3)
    ft = flycoo.build_flycoo(t, 4, **SMALL_FLYCOO)
    rt, (idx, val, mask) = dist.prepare_runtime(ft, 8)
    i, v, m = idx[3], val[3], mask[3]
    assert (~m).any()
    k = int(m.sum())
    variants = [(i, v, m), (np.where(m[:, None], i, 0), v, m),
                (i[:k], v[:k], m[:k])]
    factors = [torch.from_numpy(f).to(cuda)
               for f in dist.init_factors(ft, rt, seed=0)]
    kw = dict(mode=0, rows_cap=rt.rows_cap[0], row_offset=3 * rt.rows_cap[0],
              blk=rt.blk, tile_rows=rt.tile_rows)
    windows, outs = [], []
    for i_, v_, m_ in variants:
        i_, v_, m_ = (torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
                      for x in (i_, v_, m_))
        args = ops.gather_operands(i_, v_, m_, factors, slab=16, **kw)
        windows.append([s.shape[1] for s in _stream_args(args, blk=rt.blk)[5]])
        outs.append([ops.mttkrp_device_step(i_, v_, m_, factors, backend=b,
                                            **kw)
                     for b in WORKER_BACKENDS])
    assert windows[0] == windows[1] == windows[2]
    for got in outs:
        for a in got:
            assert torch.equal(a, outs[0][1])


# ---------------------------------------------------------------------------
# Resilience (ROADMAP A10) on the card: chaos and resume, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [1, 4])
def test_resilience_chaos_and_resume_bitwise(cuda, tmp_path, D):
    """The stepped driver under a transient and a resource fault at
    ``ops.kernel`` (one mode step of one worker runs B2 in place of B1)
    and a transient one at the remap gives bitwise the fault-free run's
    factors; a run checkpointed at sweep 1 and resumed equals it too."""
    from repro_torch.core.workers import LocalWorkers
    from repro_torch.obs import counters as ocnt
    from repro_torch.resilience import RetryPolicy, inject
    t = tensors.random_sparse_tensor((300, 200, 400), 20000, seed=0)
    ft = flycoo.build_flycoo(t, D)
    kw = dict(workers=LocalWorkers(D, cuda), backend="auto", iters=3,
              tol=0.0)
    clean = cpals.cp_als_distributed(ft, 16, resilience=RetryPolicy(), **kw)
    specs = [("ops.kernel", 1, "transient"), ("ops.kernel", 2, "resource"),
             ("distributed.remap", 0, "transient")]
    K.fused_mttkrp_nmode_gather.launches = 0
    K.fused_mttkrp_nmode_gather_tiled.launches = 0
    with ocnt.use_registry() as reg, inject(specs) as inj:
        chaos = cpals.cp_als_distributed(ft, 16, resilience=RetryPolicy(),
                                         **kw)
    assert inj.pending() == ()
    assert reg.total("resilience.injected") == 3
    assert reg.total("resilience.retries") == 2
    assert reg.total("resilience.degradations") == 1
    assert K.fused_mttkrp_nmode_gather_tiled.launches == 1
    assert K.fused_mttkrp_nmode_gather.launches == 3 * 3 * D - 1
    assert chaos.fits == clean.fits
    for a, b in zip(chaos.factors, clean.factors):
        np.testing.assert_array_equal(a, b)
    d = str(tmp_path / "ck")
    with ocnt.use_registry() as reg:
        cpals.cp_als_distributed(ft, 16, checkpoint_dir=d,
                                 **dict(kw, iters=2))
        resumed = cpals.cp_als_distributed(ft, 16, checkpoint_dir=d, **kw)
        assert reg.get("resilience.checkpoint.restores") == 1
    assert resumed.fits == clean.fits
    for a, b in zip(resumed.factors, clean.factors):
        np.testing.assert_array_equal(a, b)


def test_resilience_chunk_replay_bitwise(cuda):
    """A transient fault at one chunk of the out-of-core step (B6) under a
    policy replays that chunk: bitwise the fault-free chunked result."""
    from repro_torch.obs import counters as ocnt
    from repro_torch.resilience import inject, use_policy
    idx, val, valid, factors = _stream(cuda, 2, 16, 20000, 96, seed=4)
    kw = dict(mode=0, rows_cap=96, blk=BLK, tile_rows=TILE,
              max_chunk_bytes=20000, device=cuda)
    clean, stats = executor.mttkrp_out_of_core(idx, val, valid, factors,
                                               **kw)
    assert stats.chunks >= 5
    with ocnt.use_registry() as reg, use_policy(), \
            inject([("oocore.chunk", 3, "transient")]) as inj:
        again, _ = executor.mttkrp_out_of_core(idx, val, valid, factors,
                                               **kw)
    assert inj.pending() == ()
    assert reg.get("resilience.retries", site="oocore.chunk") == 1
    assert torch.equal(clean, again)


@pytest.mark.parametrize("backend", ["auto", "pallas_fused_gather_stream"])
def test_timed_device_step_equals_device_step(cuda, backend):
    """``ops.timed_device_step`` on the card: bitwise the output of
    ``mttkrp_device_step`` on the same inputs, with its modeled bytes in
    the ``ops.device_step`` span and its host seconds after it."""
    from repro_torch.obs import counters as ocnt
    from repro_torch.obs import tracer as otr
    idx, val, valid, factors = _stream(cuda, 2, 16, 20000, 96, seed=5)
    kw = dict(mode=0, rows_cap=96, blk=BLK, tile_rows=TILE, backend=backend)
    want = ops.mttkrp_device_step(idx, val, valid, factors, **kw)
    tracer = otr.Tracer()
    with ocnt.use_registry() as reg, otr.use_tracer(tracer):
        got = ops.timed_device_step(idx, val, valid, factors, **kw)
    assert torch.equal(got, want)
    model_b = ops.step_traffic_bytes(cap=20000, nmodes=3, rank=16,
                                     rows_cap=96)
    assert reg.get("ops.step.model_bytes", backend=backend) == model_b
    assert reg.get("ops.step_s", backend=backend) > 0
    (span,) = [r for r in tracer.records if r.name == "ops.device_step"]
    assert span.self_counters[
        f"ops.step.model_bytes{{backend={backend}}}"] == model_b


# ---------------------------------------------------------------------------
# Calibration tables on the card (repro_torch.tune)
# ---------------------------------------------------------------------------

_TUNE_GRID = None


def _tune_table(dev):
    """A real calibration of two points over every backend, timed once
    per session."""
    global _TUNE_GRID
    from repro_torch import tune
    if _TUNE_GRID is None:
        grid = [tune.GridPoint(3, 16, 64, 8, 2.0),
                tune.GridPoint(4, 256, 512, 8, 0.5)]
        K.fused_mttkrp_nmode_gather.launches = 0
        _TUNE_GRID = (tune.calibrate(grid=grid, device=dev, iters=3),
                      K.fused_mttkrp_nmode_gather.launches)
    return _TUNE_GRID


def test_tune_real_calibration_times_every_backend(cuda):
    from repro_torch.tune import microbench
    table, b1_launches = _tune_table(cuda)
    assert len(table.entries) == 2
    for e in table.entries:
        assert set(e.timings_s) == set(microbench.BACKENDS)
        assert all(np.isfinite(s) and s > 0 for s in e.timings_s.values())
    assert table.meta["device_type"] == "cuda"
    assert table.meta["device_name"] == torch.cuda.get_device_name(0)
    # The kernels ran: B1 at least warmup + iters times per point.
    assert b1_launches >= 2 * 4
    for case in table.meta["obs"]["cases"]:
        assert case["nnz"] == microbench.CARD_CASE_NNZ
        assert case["trailing_blocks"] >= 0


def test_tune_check_exits_zero_on_a_card_table(cuda, tmp_path):
    from repro_torch.tune import cli
    table, _ = _tune_table(cuda)
    path = table.save(str(tmp_path / "t.json"))
    assert cli.main(["check", "--table", path]) == 0
    assert cli.main(["show", "--table", path]) == 0


def test_tune_plans_equal_to_static_are_bitwise_the_static_run(cuda):
    """A table whose plans are the static configuration (B1 at the
    runtime's blk and tile) gives the static run bit for bit on the card."""
    from repro_torch import tune
    from repro_torch.core import distributed as dist
    t = tensors.random_sparse_tensor((300, 200, 100), 20000, seed=0)
    ft = flycoo.build_flycoo(t, 1)
    rt0, _ = dist.prepare_runtime(ft, 16)
    table = tune.CalibrationTable([tune.CalibrationEntry(
        nmodes=3, rank=16, blk=rt0.blk, tile_rows=8, density=1.0,
        timings_s={"pallas_fused_gather": 0.001, "segsum": 1.0})])
    rt, _ = dist.prepare_runtime(ft, 16, table=table)
    assert [(p.backend, p.blk, p.tile_rows) for p in rt.mode_plans] == \
        [("pallas_fused_gather", rt0.blk, 8)] * 3
    a = cpals.cp_als_distributed(ft, 16, iters=3, tol=0.0, backend="auto")
    K.fused_mttkrp_nmode_gather.launches = 0
    b = cpals.cp_als_distributed(ft, 16, iters=3, tol=0.0, backend="auto",
                                 table=table)
    assert K.fused_mttkrp_nmode_gather.launches == 9
    assert a.fits == b.fits
    for x, y in zip(a.factors, b.factors):
        assert np.array_equal(x, y)


# ---------------------------------------------------------------------------
# The compile-validation tier and the package smokes on the card
# ---------------------------------------------------------------------------

def test_lowering_smoke_grid_builds_for_sm90a(cuda):
    """Every (backend, geometry) of the smoke grid builds for sm_90a, with
    its kernel's ptxas report and a launch plan within the card's
    limits."""
    from repro_torch.kernels.mttkrp import lowering
    results = lowering.run(lowering.SMOKE_GEOMETRIES)
    assert len(results) == len(ops.BACKENDS) * 3
    assert not lowering.failed(results), [r.row() for r in results
                                          if not r.ok]
    for r in results:
        assert r.ok and r.sm90a == (r.backend != "ref")
        assert r.backend == "ref" or r.registers > 0
    assert lowering.main([]) == 0


@pytest.mark.parametrize("smoke", ["oocore", "reorder"])
def test_package_smoke_on_card_launches_b6_and_b1(cuda, smoke):
    import importlib
    cli = importlib.import_module(f"repro_torch.{smoke}.__main__")
    K.fused_mttkrp_nmode_gather_stream.launches = 0
    K.fused_mttkrp_nmode_gather.launches = 0
    assert cli.main([]) == 0
    assert K.fused_mttkrp_nmode_gather_stream.launches >= 3
    assert K.fused_mttkrp_nmode_gather.launches >= 1


# ---------------------------------------------------------------------------
# The LM serving path on the card (no kernel of its own: plain PyTorch)
# ---------------------------------------------------------------------------

def _lm(name, act, dev, seed=0):
    """Smoke config at ``act``, the port's weights on the CPU and a copy
    on ``dev``; the ``xattn`` layers' ``x_gate`` opened to 0.5 (at its
    published zero the cross-attention adds nothing)."""
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    cfg = dataclasses.replace(smoke_config(name), act_dtype=act)
    cpu = open_gates(init_params(M.model_specs(cfg), seed=seed,
                                 device="cpu"))
    return cfg, cpu, _tree_to(cpu, dev)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.parametrize("name, near_ties", [
    pytest.param(n, t, id=n) for n, t in (
        ("internlm2-20b", 0), ("minitron-8b", 0), ("phi3-mini-3.8b", 0),
        ("qwen3-32b", 0), ("qwen2-moe-a2.7b", 0), ("mamba2-370m", 0),
        # One step of this config's 24 (3 requests x 8 tokens) is a near
        # tie: top-2 margin 1.547e-4 against the devices' difference of
        # 1.920e-4 (on an H100 80GB HBM3).
        ("llama4-scout-17b-a16e", 1),
        ("jamba-1.5-large-398b", 0), ("seamless-m4t-large-v2", 0),
        ("llama-3.2-vision-11b", 0))])
def test_lm_generate_on_card_equals_cpu_at_fp32(cuda, name, near_ties):
    """Smoke config at fp32 activations (TF32 off). Prefill logits within
    1e-4 of max|logits| of the CPU's and its bf16 K/V within one bf16
    ulp; each decode step, given the CPU's cache, within 1e-4. Greedy
    tokens equal, each step's top-2 margin above the largest difference
    of the two devices' free-running logits (where a cache element that
    rounds to the other bf16 neighbour on the card carries on). A config
    with a measured near tie (a step whose margin is within that
    difference) admits that many, where the two devices must rank the
    same two tokens on top. The MoE, SSM and hybrid smoke configs too
    (their float32 mamba state within the same bound as the K/V), and the
    enc-dec and vision ones with their stub frontend's input (their
    cross-attention ``ck`` / ``cv`` within the same bound)."""
    from repro_torch.launch.serve import ServeSession, _pad_caches
    from repro_torch.models import model as M
    cfg, cpu, card = _lm(name, "float32", cuda)
    b, lp, n = 3, 12, 8
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (b, lp)).astype(np.int32)
    extras = frontend_inputs(cfg, np.random.default_rng(100), b, lp)
    on = lambda dev: {k: torch.from_numpy(v).to(dev)  # noqa: E731
                      for k, v in extras.items()}
    got = ServeSession(cfg, card, max_len=lp + n + 1,
                       device=cuda).generate(prompts, n, extras=on(cuda))
    want = ServeSession(cfg, cpu, max_len=lp + n + 1,
                        device="cpu").generate(prompts, n, extras=on("cpu"))
    np.testing.assert_array_equal(got, want)
    run = {}
    for key, dev, params in (("cpu", "cpu", cpu), ("card", cuda, card)):
        lg, cache = M.prefill(cfg, params,
                              torch.from_numpy(prompts).to(dev), **on(dev))
        run[key] = dict(params=params, dev=dev, prefill=lg.float().cpu(),
                        cache=_pad_caches(cache, lp, lp + n + 1), free=[])
    scale = float(run["cpu"]["prefill"].abs().max())
    torch.testing.assert_close(run["card"]["prefill"], run["cpu"]["prefill"],
                               rtol=1e-4, atol=1e-4 * scale)
    for grp, leaves in run["cpu"]["cache"].items():
        for leaf, c in leaves.items():
            torch.testing.assert_close(
                run["card"]["cache"][grp][leaf].float().cpu(), c.float(),
                rtol=2 ** -8, atol=2 ** -8 * float(c.float().abs().max()))
    for i in range(n - 1):
        tok = torch.from_numpy(want[:, i:i + 1])
        shared = _tree_to(run["cpu"]["cache"], cuda)   # before the CPU step
        for r in run.values():
            lg, r["cache"] = M.decode_step(cfg, r["params"], r["cache"],
                                           tok.to(r["dev"]), lp + i)
            r["free"].append(lg[:, -1, :cfg.vocab].float().cpu())
        lg, _ = M.decode_step(cfg, card, shared, tok.to(cuda), lp + i)
        torch.testing.assert_close(lg[:, -1, :cfg.vocab].float().cpu(),
                                   run["cpu"]["free"][-1], rtol=1e-4,
                                   atol=1e-4 * scale)
    free = {k: torch.stack([r["prefill"][:, -1, :cfg.vocab]] + r["free"], 1)
            for k, r in run.items()}
    diff = float((free["card"] - free["cpu"]).abs().max())
    top2 = torch.topk(free["cpu"], 2, dim=-1)
    margin = top2.values[..., 0] - top2.values[..., 1]
    print(f"{name}: least top-2 margin {float(margin.min()):.3e}, devices' "
          f"difference {diff:.3e}, near ties {int((margin <= diff).sum())}")
    if not near_ties:
        assert float(margin.min()) > diff
        return
    near = margin <= diff
    assert int(near.sum()) <= near_ties, (margin[near].tolist(), diff)
    card2 = torch.topk(free["card"], 2, dim=-1).indices
    assert torch.equal(top2.indices.sort(-1).values[near],
                       card2.sort(-1).values[near])


@pytest.mark.parametrize("name", ["phi3-mini-3.8b", "qwen3-32b"])
def test_lm_forward_on_card_at_bf16(cuda, name):
    """Default bf16 activations: forward on the card within the
    reference's 2e-2 of the CPU's, and prefill == forward's last position
    on the card."""
    from repro_torch.models import model as M
    cfg, cpu, card = _lm(name, "bfloat16", cuda, seed=1)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 32)).astype(np.int32))
    want, _ = M.forward(cfg, cpu, toks)
    got, _ = M.forward(cfg, card, toks.to(cuda))
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=2e-2,
                               atol=2e-2 * scale)
    last, _ = M.prefill(cfg, card, toks.to(cuda))
    torch.testing.assert_close(last[:, 0].float(), got[:, -1].float(),
                               rtol=2e-2, atol=2e-2 * scale)


def test_lm_serve_main_and_example_run_on_the_card_by_default(cuda, capsys):
    import importlib.util
    import os
    from repro_torch.launch import serve
    for arch in ("phi3-mini-3.8b", "qwen2-moe-a2.7b", "mamba2-370m",
                 "seamless-m4t-large-v2", "llama-3.2-vision-11b"):
        assert serve.main(["--arch", arch, "--smoke", "--tokens",
                           "4"]) is None
        assert "on cuda" in capsys.readouterr().out
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "torch_lm_serve.py")
    spec = importlib.util.spec_from_file_location("torch_lm_serve", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(tokens=6)
    assert capsys.readouterr().out.strip().splitlines()[-1] == "OK"


# ---------------------------------------------------------------------------
# LM training on the card (plain PyTorch with autograd, no kernel)
# ---------------------------------------------------------------------------

def _lm_batch(cfg, b, l, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, l)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (b, l)).astype(np.int32),
            "loss_mask": (rng.random((b, l)) < 0.8).astype(np.float32),
            **frontend_inputs(cfg, np.random.default_rng(seed + 100), b,
                               l // 2)}


# The families beyond the dense one: MoE, SSM, hybrid, enc-dec, VLM.
LM_OTHERS = ["jamba-1.5-large-398b", "llama-3.2-vision-11b",
             "llama4-scout-17b-a16e", "mamba2-370m", "qwen2-moe-a2.7b",
             "seamless-m4t-large-v2"]


def _on(batch, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


@pytest.mark.parametrize("name", ["internlm2-20b", "minitron-8b",
                                  "phi3-mini-3.8b", "qwen3-32b"] + LM_OTHERS)
def test_lm_grads_on_card_equal_cpu_at_fp32(cuda, name):
    """Smoke config, fp32 activations, one starting state: the loss within
    1e-5 relative and every leaf's gradient within 1e-4 of its max|g|
    (the CPU tests' tolerances against the reference); all ten archs."""
    from repro_torch.models import steps as S
    from repro_torch.models.params import iter_leaves
    cfg, cpu, card = _lm(name, "float32", cuda)
    batch = _lm_batch(cfg, 2, 32, seed=1)
    (lw, mw), gw = S.loss_and_grads(cfg, cpu, _on(batch, "cpu"))
    (lg, mg), gg = S.loss_and_grads(cfg, card, _on(batch, cuda))
    assert _rel(lg, lw) < 1e-5 and _rel(mg["ce"], mw["ce"]) < 1e-5
    for (path, a), (_, b) in zip(iter_leaves(gg), iter_leaves(gw)):
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()),
                                   msg=str(path))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_lm_train_step_on_card_equals_cpu(cuda, opt_name, k):
    """One train step of qwen3-32b's smoke config at fp32 activations from
    one starting state: metrics within 1e-5 relative, step and count
    equal, parameters within 2.5 lr_t and all but 0.1% of their elements
    within 1e-5 of max|p|."""
    from repro_torch import optim as O
    from repro_torch.models import steps as S
    from repro_torch.models.params import iter_leaves
    cfg, cpu, card = _lm("qwen3-32b", "float32", cuda)
    runs = {}
    for dev, params in (("cpu", cpu), (cuda, card)):
        opt = O.make_optimizer(opt_name, O.cosine_schedule(1e-2, 2, 10))
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        batch = _lm_batch(cfg, 4, 16, seed=2)
        batch.pop("loss_mask")
        runs[str(dev)] = S.make_train_step(cfg, opt, grad_accum=k)(state,
                                                                   batch)
    (want, wm), (got, gm) = runs["cpu"], runs[str(cuda)]
    for key in ("loss", "ce", "z_loss", "grad_norm"):
        assert _rel(gm[key], wm[key]) < 1e-5, key
    assert int(got["step"]) == int(want["step"]) == 1
    assert int(got["opt"]["count"]) == int(want["opt"]["count"]) == 1
    lr_t = float(O.cosine_schedule(1e-2, 2, 10)(1))
    outliers = total = 0
    for (path, a), (_, b) in zip(iter_leaves(got["params"]),
                                 iter_leaves(want["params"])):
        err = (a.cpu() - b).abs()
        assert float(err.max()) <= 2.5 * lr_t, path
        outliers += int((err > 1e-5 * float(b.abs().max())).sum())
        total += err.numel()
    assert outliers <= 1e-3 * total


@pytest.mark.parametrize("name", LM_OTHERS)
def test_lm_train_step_of_each_family_on_card_equals_cpu(cuda, name):
    """One train step of each family beyond the dense one (smoke config,
    fp32 activations, the config's optimizer, ``grad_accum=2``; jamba:
    Adafactor and its bf16 gradient accumulator) on the card against the
    same step on the CPU: the CPU tests' bounds against the reference
    (``tests/test_torch_lm_train.py::test_train_step_matches_reference``)."""
    from repro_torch import optim as O
    from repro_torch.models import steps as S
    from repro_torch.models.params import iter_leaves
    cfg, cpu, card = _lm(name, "float32", cuda)
    runs = {}
    for dev, params in (("cpu", cpu), (cuda, card)):
        opt = O.make_optimizer(cfg.optimizer, O.cosine_schedule(1e-2, 2, 10))
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        batch = _lm_batch(cfg, 4, 16, seed=4)
        batch.pop("loss_mask")
        runs[str(dev)] = S.make_train_step(cfg, opt, grad_accum=2)(state,
                                                                   batch)
    (want, wm), (got, gm) = runs["cpu"], runs[str(cuda)]
    for key in ("loss", "ce", "z_loss", "moe_aux", "grad_norm"):
        if float(wm[key]) or float(gm[key]):
            assert _rel(gm[key], wm[key]) < 1e-5, key
    assert int(got["step"]) == int(want["step"]) == 1
    assert int(got["opt"]["count"]) == int(want["opt"]["count"]) == 1
    lr_t = float(O.cosine_schedule(1e-2, 2, 10)(1))
    floor = 2 ** -5 * lr_t if cfg.grad_accum_dtype == "bfloat16" else 0.0
    outliers = total = 0
    for (path, a), (_, b) in zip(iter_leaves(got["params"]),
                                 iter_leaves(want["params"])):
        assert bool(torch.isfinite(a).all()), path
        err = (a.cpu() - b).abs()
        assert float(err.max()) <= 2.5 * lr_t, path
        outliers += int((err > max(1e-5 * float(b.abs().max()),
                                   floor)).sum())
        total += err.numel()
    assert outliers <= 1e-3 * total


def test_lm_remat_and_grad_accum_on_card(cuda):
    """On the card, remat ``nothing`` / ``dots`` and ``grad_accum=2``
    give the gradients of remat off within 1e-5 of each leaf's max|g|
    (the embedding's backward adds with atomics: not bitwise)."""
    import dataclasses
    from repro_torch.models import steps as S
    from repro_torch.models.params import iter_leaves
    cfg, _, card = _lm("phi3-mini-3.8b", "float32", cuda)
    batch = _on(_lm_batch(cfg, 4, 32, seed=3), cuda)
    batch.pop("loss_mask")
    _, want = S.loss_and_grads(cfg, card, batch, remat=False)
    got = {p: S.loss_and_grads(dataclasses.replace(cfg, remat_policy=p),
                               card, batch)[1] for p in ("nothing", "dots")}
    got["accum"] = S.accumulate_grads(cfg, card, batch, 2)[1]
    for key, g in got.items():
        for (path, a), (_, b) in zip(iter_leaves(g), iter_leaves(want)):
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=1e-5 * float(b.abs().max()),
                                       msg=f"{key} {path}")


def test_lm_train_main_runs_on_the_card_by_default(cuda, capsys):
    from repro_torch.launch import train
    assert train.main(["--arch", "qwen3-32b", "--smoke", "--steps",
                       "3"]) is None
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        "final loss ")
    state, history = train.train("phi3-mini-3.8b", smoke=True, steps=2,
                                 log_fn=lambda *_: None)
    assert state["step"].device.type == "cuda" and len(history) == 2


# ---------------------------------------------------------------------------
# The int8 KV cache, the mesh and the owner-computes MoE dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [64, 1056, 2100])
def test_lm_int8_decode_on_card_equals_cpu(cuda, S):
    """``decode_attention_int8`` on the card against the CPU on the same
    inputs: the quantizers' codes and scales bitwise; both int32
    contractions of the card (recorded with their int8 codes) equal the
    CPU's and an int64 product on those codes element for element, and
    the QK sums equal the CPU run's own (the same codes); the output
    within 1e-5 of max|out|. At S past 1040 the PV sum takes two or more
    float32 chunks."""
    from repro_torch.models import attention as A
    rng = np.random.default_rng(S)
    q = torch.from_numpy(rng.standard_normal((2, 1, 8, 64)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, S, 4, 64)).astype(
        np.float32) * 2) for _ in range(2))
    runs = {}
    contract = A.int8_contract
    for dev in ("cpu", cuda):
        kq = A.quantize_per_token(k.to(dev))
        vq = A.quantize_per_channel(v.to(dev))
        sums = []

        def recording(a, b):
            out = contract(a, b)
            sums.append((a.cpu(), b.cpu(), out.cpu()))
            return out

        A.int8_contract = recording
        try:
            out = A.decode_attention_int8(q.to(dev), *kq, *vq,
                                          cur_pos=S - 5)
        finally:
            A.int8_contract = contract
        runs[str(dev)] = ([t.cpu() for t in kq + vq], sums, out.cpu())
    (cq, cs, co), (gq, gs, go) = runs["cpu"], runs[str(cuda)]
    for a, b in zip(cq, gq):
        assert torch.equal(a, b)
    assert len(cs) == len(gs) == 2
    for a, b, out in gs:
        assert out.dtype == torch.int32
        assert torch.equal(out, contract(a, b))
        assert torch.equal(out.long(), torch.matmul(a.long(), b.long()))
    # the QK codes are the same on both devices (the PV codes come from
    # each device's softmax)
    assert torch.equal(cs[0][2], gs[0][2])
    assert float((co - go).abs().max()) <= 1e-5 * float(co.abs().max())


def test_lm_int8_contract_exact_on_card(cuda):
    from repro_torch.models.attention import int8_contract
    a = torch.full((2, 3, 1, 2048), 127, dtype=torch.int8)
    b = torch.full((2, 3, 2048, 5), -127, dtype=torch.int8)
    b[:, :, 0] = 2
    want = torch.matmul(a.long(), b.long())
    got = int8_contract(a.to(cuda), b.to(cuda))
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu().long(), want)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(-127, 128, (4, 3, 1057)).astype(
        np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (4, 1057, 96)).astype(
        np.int8))
    assert torch.equal(int8_contract(a.to(cuda), b.to(cuda)).cpu(),
                       int8_contract(a, b))


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("top_k,n_shared", [(2, 0), (4, 1)])
def test_lm_moe_owner_on_card_equals_cpu(cuda, shape, top_k, n_shared):
    """``moe_apply_owner`` under a mesh on the card against the CPU: the
    drops and the psum's bytes equal, the output within 1e-5 of max|y|
    (float32), a rerun on the card bitwise."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as MoE
    from repro_torch.models.params import init_params
    from repro_torch.models.sharding import use_mesh_rules
    p = init_params({"m": MoE.moe_specs(64, 96, 16, n_shared, 14)}, seed=2,
                    device="cpu")["m"]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 64, 64)).astype(np.float32))
    outs = {}
    with use_mesh_rules(make_mesh(shape, ("data", "model"))):
        for dev in ("cpu", cuda, cuda):
            y, m = MoE.moe_apply(_tree_to(p, dev), x.to(dev), n_real=14,
                                 top_k=top_k)
            outs.setdefault(str(dev), []).append(
                (y.cpu(), int(m["moe_dropped"]), m["moe_sent_bytes"]))
    (cy, cd, cb), = outs["cpu"]
    (gy, gd, gb), (gy2, _, _) = outs[str(cuda)]
    assert cd == gd > 0 and cb == gb > 0
    assert float((gy - cy).abs().max()) <= 1e-5 * float(cy.abs().max())
    assert torch.equal(gy, gy2)


@pytest.mark.parametrize("name", ["qwen3-32b"] + LM_OTHERS)
def test_lm_mesh_train_step_of_each_family_on_card(cuda, name):
    """One ``make_train_step(mesh=, rules=rules_for(train_4k),
    param_shardings=)`` step of each family (smoke config, fp32
    activations, a ``(1, 4)`` mesh: the MoE layers on the owner path, the
    checkpointed layers recomputed under the same mesh context in the
    backward) on the card against the same step on the CPU: the CPU
    tests' bounds."""
    from repro_torch import optim as O
    from repro_torch.configs import SHAPES
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models import steps as S
    from repro_torch.models.params import iter_leaves, tree_shardings
    cfg, cpu, card = _lm(name, "float32", cuda)
    mesh = make_mesh((1, 4), ("data", "model"))
    rules = S.rules_for(SHAPES["train_4k"])
    kw = dict(mesh=mesh, rules=rules, grad_accum=2,
              param_shardings=tree_shardings(M.model_specs(cfg), mesh,
                                             rules))
    runs = {}
    for dev, params in (("cpu", cpu), (cuda, card)):
        opt = O.make_optimizer(cfg.optimizer, O.cosine_schedule(1e-2, 2, 10))
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        batch = _lm_batch(cfg, 4, 16, seed=4)
        batch.pop("loss_mask")
        runs[str(dev)] = S.make_train_step(cfg, opt, **kw)(state, batch)
    (want, wm), (got, gm) = runs["cpu"], runs[str(cuda)]
    for key in ("loss", "ce", "z_loss", "moe_aux", "grad_norm"):
        if float(wm[key]) or float(gm[key]):
            assert _rel(gm[key], wm[key]) < 1e-5, key
    lr_t = float(O.cosine_schedule(1e-2, 2, 10)(1))
    floor = 2 ** -5 * lr_t if cfg.grad_accum_dtype == "bfloat16" else 0.0
    outliers = total = 0
    for (path, a), (_, b) in zip(iter_leaves(got["params"]),
                                 iter_leaves(want["params"])):
        assert bool(torch.isfinite(a).all()), path
        err = (a.cpu() - b).abs()
        assert float(err.max()) <= 2.5 * lr_t, path
        outliers += int((err > max(1e-5 * float(b.abs().max()),
                                   floor)).sum())
        total += err.numel()
    assert outliers <= 1e-3 * total


def test_lm_int8_and_mesh_sessions_on_card(cuda):
    """``ServeSession`` with the int8 cache, and under a ``(1, 4)`` mesh
    (the MoE's owner path), serve on the card with bitwise greedy reruns;
    the int8 prefill's logits are bitwise the bf16 cache's."""
    import dataclasses
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import ServeSession
    from repro_torch.models import model as M
    for name, kw, mesh in (
            ("qwen3-32b", {"kv_cache_dtype": "int8"}, None),
            ("qwen2-moe-a2.7b", {}, make_mesh((1, 4), ("data", "model")))):
        cfg, _, card = _lm(name, "bfloat16", cuda)
        cfg = dataclasses.replace(cfg, **kw)
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab, (3, 40)).astype(np.int32)
        sess = ServeSession(cfg, card, mesh=mesh, max_len=60)
        a, b = sess.generate(prompts, 8), sess.generate(prompts, 8)
        assert a.shape == (3, 8) and np.array_equal(a, b)
    toks = torch.from_numpy(prompts).to(cuda)
    cfg8 = dataclasses.replace(_lm("qwen3-32b", "bfloat16", cuda)[0],
                               kv_cache_dtype="int8")
    card = _lm("qwen3-32b", "bfloat16", cuda)[2]
    assert torch.equal(M.prefill(cfg8, card, toks)[0],
                       M.prefill(dataclasses.replace(
                           cfg8, kv_cache_dtype="bfloat16"), card, toks)[0])


# ---------------------------------------------------------------------------
# The last tile's walk cut at its last live block (S1), and the narrow bf16
# B1/B2 (gather_mttkrp_narrow_kernel, slabs under BF16_VEC_MIN_SLAB)
# ---------------------------------------------------------------------------

def _narrow_case(case, k):
    """``(runs, pad_blocks, blk, zero_from)`` of a narrow-kernel case:
    ``zero_from`` zeroes every slot from there on (a last nonzero just
    before, at or after a batch edge, padding behind it). A group's batch
    is NARROW_UNROLL // K slots; the CTA's two batches in flight cover
    ``edge`` slots of the run."""
    edge = 2 * K._groups(TILE) * max(1, K.NARROW_UNROLL // k)
    if case == "last tile all padding":
        return [5, 3, 40], range(8, 48), BLK, None
    if case == "padding blocks between live ones":
        return [10, 12, 6, 30], (3, 11, 12, 13, 27, 30, 31, 50, 51, 52), \
            BLK, 56 * BLK - 7
    if case == "single block":
        return [1], (), BLK, None
    runs = [edge // 4 - 1, edge // 4, edge // 4 + 1, 3 * edge // 4 + 3]
    start = sum(runs[:3]) * 4
    if case.startswith("batch edge"):
        last = {"-1": edge - 1, "0": edge, "+1": edge + 1}[case[11:]]
        return runs, (), 4, start + last
    # The pipeline's depth: runs of 1, 2, 3 and 5 batches of every group.
    return [c * edge // 8 for c in (1, 2, 3, 5)], (), 4, None


NARROW_CASES = ["last tile all padding", "padding blocks between live ones",
                "single block", "batch edge -1", "batch edge 0",
                "batch edge +1", "pipeline depth"]


def _check_cut(args, rows_cap, blk):
    """The cut the kernels make (live_end_kernel) equals the plain one, and
    ends the last tile's walk within one block of its last live slot."""
    vals, _, _, _, tob = args
    kw = dict(rows_cap=rows_cap, blk=blk, tile_rows=TILE)
    starts = K.live_tile_starts(vals, tob, **kw)
    want = K.live_end_plain(vals, tob, **kw)
    assert int(starts[0]) == want
    b0, b1 = int(starts[-2]), int(starts[-1])
    live = torch.nonzero(vals[b0 * blk:b1 * blk]).flatten()
    if live.numel():
        assert (want - b0) * blk - int(live[-1]) <= blk
    else:
        assert want == 0


@pytest.mark.parametrize("case", NARROW_CASES)
@pytest.mark.parametrize("rank", [16, 32, 48])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_bf16_narrow_gather_edges(cuda, k, rank, case):
    """The narrow bf16 B1 (and B2 over 16-column slabs) against its plain
    version, and bitwise against B3-bf16, B4-bf16 and B6-bf16 on the same
    stream: a last tile whose run is all padding, padding blocks between
    live ones, a single block, a last nonzero at a batch edge +-1, and
    runs of 1, 2, 3 and 5 batches around the pipeline's two; with the tail
    cut held to the plain one."""
    runs, pads, blk, zero_from = _narrow_case(case, k)
    args, rows_cap = _runs_operands(cuda, k, rank, runs, blk=blk,
                                    seed=300 + 10 * k + rank,
                                    pad_blocks=pads)
    if zero_from is not None:
        args[0][zero_from:] = 0.0
    args = _to_bf16(args)
    assert K._gather_design(rank, 2) == "narrow"
    _check_cut(args, rows_cap, blk)
    kw = dict(rows_cap=rows_cap, blk=blk, tile_rows=TILE)
    n = K.fused_mttkrp_nmode_gather.launches_bf16
    b1 = K.fused_mttkrp_nmode_gather(*args, **kw)
    assert K.fused_mttkrp_nmode_gather.launches_bf16 == n + 1
    plain = K.fused_mttkrp_nmode_gather_plain(*args, **kw)
    scale = max(float(plain.abs().max()), 1e-30)
    assert torch.allclose(b1, plain, rtol=1e-5, atol=1e-5 * scale)
    assert torch.equal(b1, K.fused_mttkrp_nmode_gather(*args, **kw))
    assert torch.equal(b1, K.fused_mttkrp_nmode_gather_tiled(
        *args, rank_slab=16, **kw))
    vals, idx, fm, rows, tob = args
    pre = ops.pregathered_rows(idx, fm)
    assert torch.equal(b1, K.fused_mttkrp_nmode(vals, pre, rows, tob, **kw))
    assert torch.equal(b1, K.fused_mttkrp_nmode_tiled(
        vals, pre, rows, tob, rank_slab=16, **kw))
    if blk == BLK:
        s_args, _ = _b6_args(args)
        assert torch.equal(b1, K.fused_mttkrp_nmode_gather_stream(
            *s_args, rank_slab=16, **kw))


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_stream_chunk_of_trailing_padding_only(cuda, k, dtype, carry):
    """B6 chunks whose part of the last tile's run is trailing padding
    only: with a carry (the chunk starts inside that run, after its live
    blocks) the carried partials still reach ``out``; without one (the
    chunk starts at the run, all padding) the tile keeps ``out_init``.
    Chunked == single pass bitwise, and == B1."""
    pads = range(45, 62) if carry else range(42, 62)
    args, rows_cap = _runs_operands(cuda, k, 16, [2, 40, 20],
                                    seed=400 + k, pad_blocks=pads)
    if dtype == torch.bfloat16:
        args = _to_bf16(args)
    args6, _ = _b6_args(args)
    single = _check_b6(args6, rows_cap)
    _check_cut(args, rows_cap, BLK)
    vals, idx, fm, rows, tob, scheds = args6
    kw = dict(rows_cap=rows_cap, blk=BLK, tile_rows=TILE)
    cut = 47 if carry else 42
    a, b = slice(0, cut * BLK), slice(cut * BLK, tob.shape[0] * BLK)
    out, held = K.fused_mttkrp_nmode_gather_stream_chunk(
        vals[a], idx[a], fm, rows[a], tob[:cut],
        tuple(x[:cut].contiguous() for x in scheds), split_tail=carry, **kw)
    assert (held is not None) == carry
    out, held = K.fused_mttkrp_nmode_gather_stream_chunk(
        vals[b], idx[b], fm, rows[b], tob[cut:],
        tuple(x[cut:].contiguous() for x in scheds), out_init=out,
        carry=held, **kw)
    assert held is None
    assert torch.equal(out, single)


@pytest.mark.parametrize("rank", [16, 256])
def test_fp32_gather_tail_cut_matches_plain(cuda, rank):
    """fp32 B1/B2 with the aligned stream's own trailing padding (the
    blocks clipped onto the last tile): the cut equals the plain one, and
    the kernels still equal their plain version and each other."""
    args = _operands(cuda, 3, rank, ops.tiled_rank_slab(rank), cap=20_000,
                     rows_cap=256, seed=rank)
    _check_cut(args, 256, BLK)
    starts = K.live_tile_starts(args[0], args[4], rows_cap=256, blk=BLK,
                                tile_rows=TILE)
    assert int(starts[-1]) - int(starts[0]) > 8   # blocks cut
    _check_b1_b2(args, 256, rank, blk=BLK)
