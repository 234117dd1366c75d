"""Port parity: one Dynasor ALS sweep and whole CP-ALS runs against JAX.

JAX runs on a one-device CPU mesh with its Pallas kernels interpreted;
the port runs its plain PyTorch versions with ``device="cpu"``.
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
from repro_torch import convert  # noqa: E402
from repro_torch.core import cpals as tcpals  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import flycoo as tfly  # noqa: E402
from repro_torch.core import tensors as tten  # noqa: E402

SHAPE, NNZ, RANK = (40, 30, 20), 2000, 8
FAC_TOL = dict(rtol=1e-4, atol=1e-5)
FIT_TOL = 1e-5


@pytest.fixture(scope="module")
def tensors():
    t = tten.random_sparse_tensor(SHAPE, NNZ, seed=0)
    tj = jten.random_sparse_tensor(SHAPE, NNZ, seed=0)
    return tfly.build_flycoo(t, 1), jfly.build_flycoo(tj, 1)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]), (jdist.AXIS,))


def _x_norm_sq(ft):
    return np.float32(np.sum(ft.tensor.values.astype(np.float64) ** 2))


def test_runtime_and_init_equal(tensors):
    ft, fj = tensors
    rt, packed = tdist.prepare_runtime(ft, RANK)
    rj, packed_j = jdist.prepare_runtime(fj, RANK)
    for f in ("num_workers", "nmodes", "rank", "rows_cap", "i_pad", "nnz_cap",
              "bucket_cap", "shape", "blk", "tile_rows", "bucket_caps",
              "gather_dtype", "ordering"):
        assert getattr(rt, f) == getattr(rj, f), f
    for a, b in zip(packed, packed_j):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for n, (a, b) in enumerate(zip(tdist.init_factors(ft, rt, seed=3),
                                   jdist.init_factors(fj, rj, seed=3))):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tdist.unpermute_factor(ft, rt, n, a),
                                      jdist.unpermute_factor(fj, rj, n, b))


def test_one_sweep_from_reference_state(tensors, mesh):
    """Sweeps 0 and 1 from the JAX state carried across by convert."""
    ft, fj = tensors
    rj, (idx, val, mask) = jdist.prepare_runtime(fj, RANK)
    rt, _ = tdist.prepare_runtime(ft, RANK)
    factors = jdist.init_factors(fj, rj, seed=0)
    lam = np.ones(RANK, np.float32)
    x2 = _x_norm_sq(fj)
    sweep = jcpals.make_als_sweep(rj, mesh, backend="pallas_fused_gather")
    state = ((idx, val, mask), [jnp.asarray(f) for f in factors],
             jnp.asarray(lam))
    for sweep0 in (True, False):
        (jstream, jfac, jlam) = state
        tfac, tlam, tstream = convert.state_from_reference(
            [np.asarray(f) for f in jfac], np.asarray(jlam),
            tuple(np.asarray(a) for a in jstream), device="cpu")
        (i2, v2, m2), jfac2, jlam2, jfit = sweep(
            *jstream, np.broadcast_to(x2, (1,)).copy(), *jfac, jlam,
            jnp.asarray(sweep0))
        res = tcpals.als_sweep(tstream, tfac, tlam, torch.tensor(x2), rt,
                               sweep0=sweep0, backend="pallas_fused_gather")
        for a, b in zip(res.factors, jfac2):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **FAC_TOL)
        np.testing.assert_allclose(res.lam.numpy(), np.asarray(jlam2),
                                   **FAC_TOL)
        assert abs(float(res.fit) - float(jfit)) < FIT_TOL
        # The remapped stream is integer data: equal exactly.
        np.testing.assert_array_equal(res.stream[0].numpy(), np.asarray(i2)[0])
        np.testing.assert_array_equal(res.stream[1].numpy(), np.asarray(v2)[0])
        np.testing.assert_array_equal(res.stream[2].numpy(), np.asarray(m2)[0])
        assert len(res.mttkrp) == 3
        state = ((i2, v2, m2), jfac2, jlam2)


@pytest.mark.parametrize("backend", ["segsum", "pallas_fused_gather",
                                     "pallas_fused_gather_tiled"])
def test_cp_als_distributed_matches_jax(tensors, mesh, backend):
    ft, fj = tensors
    got = tcpals.cp_als_distributed(ft, RANK, device="cpu", iters=3, tol=0.0,
                                    backend=backend)
    want = jcpals.cp_als_distributed(fj, RANK, mesh, iters=3, tol=0.0,
                                     backend=backend)
    assert got.iters == want.iters == 3
    np.testing.assert_allclose(got.fits, want.fits, rtol=0, atol=FIT_TOL)
    for a, b in zip(got.factors, want.factors):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **FAC_TOL)
    np.testing.assert_allclose(got.lam, want.lam, **FAC_TOL)
    assert len(got.sweep_seconds) == 3


def test_cp_als_matches_jax():
    t = tten.random_sparse_tensor((30, 20, 10), 500, seed=4)
    tj = jten.random_sparse_tensor((30, 20, 10), 500, seed=4)
    got = tcpals.cp_als(t, 6, device="cpu", iters=5, seed=5)
    want = jcpals.cp_als(tj, 6, iters=5, seed=5)
    assert got.iters == want.iters
    np.testing.assert_allclose(got.fits, want.fits, rtol=0, atol=FIT_TOL)
    for a, b in zip(got.factors, want.factors):
        np.testing.assert_allclose(a, b, **FAC_TOL)


def test_fit_from_parts_matches_jax():
    rng = np.random.default_rng(6)
    lam = rng.random(4).astype(np.float32)
    grams = [(lambda a: a.T @ a)(rng.standard_normal((7, 4)).astype(
        np.float32)) for _ in range(3)]
    M, A = (rng.standard_normal((9, 4)).astype(np.float32) for _ in range(2))
    got = tcpals.fit_from_parts(torch.tensor(np.float32(50.0)),
                                torch.from_numpy(lam),
                                [torch.from_numpy(g) for g in grams],
                                torch.from_numpy(M), torch.from_numpy(A))
    want = jcpals.fit_from_parts(jnp.float32(50.0), jnp.asarray(lam),
                                 [jnp.asarray(g) for g in grams],
                                 jnp.asarray(M), jnp.asarray(A))
    assert abs(float(got) - float(want)) < FIT_TOL


def test_entry_points_need_cuda_unless_cpu_is_asked(tensors, monkeypatch):
    ft, _ = tensors
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcpals.cp_als_distributed(ft, RANK, iters=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcpals.cp_als(ft.tensor, RANK, iters=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.state_from_reference([np.zeros((2, 2), np.float32)],
                                     np.ones(2), device=None)
    with pytest.raises(RuntimeError):
        tcpals.cp_als_distributed(ft, RANK, device="cuda", iters=1)
    res = tcpals.cp_als_distributed(ft, RANK, device="cpu", iters=1)
    assert np.isfinite(res.fit)


def test_unported_options_raise(tensors):
    ft, _ = tensors
    ft2 = tfly.build_flycoo(ft.tensor, 2)
    with pytest.raises(NotImplementedError, match="A9"):
        tcpals.cp_als_distributed(ft2, RANK, device="cpu", iters=1)
    with pytest.raises(NotImplementedError, match="A6"):
        tcpals.cp_als_distributed(ft, RANK, device="cpu", iters=1,
                                  backend="auto")
    with pytest.raises(NotImplementedError, match="A6"):
        tcpals.cp_als_distributed(ft, RANK, device="cpu", iters=1,
                                  gather_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="A12"):
        tdist.prepare_runtime(ft, RANK, table=object())
    rt, _ = tdist.prepare_runtime(ft2, RANK)
    assert rt.num_workers == 2
    with pytest.raises(NotImplementedError, match="A9"):
        tdist.device_remap(torch.zeros(4, 3, dtype=torch.int32),
                           torch.zeros(4), torch.ones(4, dtype=torch.bool),
                           1, rt)
