"""The CUDA kernels on the card: held against their plain versions.

Marked ``gpu``: each test skips, with its reason, where no CUDA device is
available (the CPU-only hosts that run the rest of the suite). On a
machine with an H100 run ``python -m pytest -m gpu tests/test_torch_gpu.py``.
This file imports no JAX, so it runs where JAX is not installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import cpals, flycoo, tensors  # noqa: E402
from repro_torch.kernels.mttkrp import kernel as K  # noqa: E402
from repro_torch.kernels.mttkrp import ops  # noqa: E402

pytestmark = pytest.mark.gpu
BLK, TILE = 64, 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _operands(dev, k, rank, slab, cap=5000, rows_cap=96, seed=0, blk=BLK,
              tile_rows=TILE):
    rng = np.random.default_rng(seed)
    frows = [int(x) for x in rng.integers(50, 400, k)]
    idx = np.stack([np.sort(rng.integers(0, rows_cap, cap))]
                   + [rng.integers(0, f, cap) for f in frows], 1)
    factors = [torch.zeros(rows_cap, rank)] + [
        torch.from_numpy(rng.standard_normal((f, rank)).astype(np.float32))
        for f in frows]
    valid = torch.from_numpy(np.arange(cap) < cap - 17)
    return ops.gather_operands(
        torch.from_numpy(idx.astype(np.int32)).to(dev),
        torch.from_numpy(rng.standard_normal(cap).astype(np.float32)).to(dev),
        valid.to(dev), [f.to(dev) for f in factors], mode=0,
        rows_cap=rows_cap, row_offset=0, blk=blk, tile_rows=tile_rows,
        slab=slab)


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
