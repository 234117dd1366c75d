"""Port parity: dynamic remap (exact) and the guarded solve (levels + values)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import flycoo as jfly  # noqa: E402
from repro.core import remap as jremap  # noqa: E402
from repro.core import tensors as jten  # noqa: E402
from repro.resilience import numerics as jnum  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import flycoo as tfly  # noqa: E402
from repro_torch.core import remap as tremap  # noqa: E402
from repro_torch.core import tensors as tten  # noqa: E402
from repro_torch.core.workers import LocalWorkers  # noqa: E402
from repro_torch.resilience import numerics as tnum  # noqa: E402

FLYCOO_KW = dict(m_bounds=(2, 8), g_bounds=(8, 64), cache_bytes=1 << 20)


@pytest.mark.parametrize("devices,cap", [(1, 40), (2, 25), (4, 9), (4, 4)])
def test_bucket_by_destination_equal(devices, cap):
    rng = np.random.default_rng(devices * 10 + cap)
    n = 60
    dest = rng.integers(0, devices + 1, n).astype(np.int32)  # D = invalid
    payload = rng.standard_normal((n, 4)).astype(np.float32)
    # The port carries columns as separate tensors; JAX one packed payload.
    pt = torch.from_numpy(payload)
    got = tremap.bucket_by_destination(torch.from_numpy(dest),
                                       (pt[:, :3], pt[:, 3]), devices, cap)
    want = jremap.bucket_by_destination(jnp.asarray(dest),
                                        jnp.asarray(payload), devices, cap)
    cols, last = got[0]
    np.testing.assert_array_equal(
        torch.cat([cols, last[..., None]], -1).numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_sorted_equal(seed):
    rng = np.random.default_rng(seed)
    n, out_cap = 50, 40
    payload = rng.standard_normal((n, 3)).astype(np.float32)
    mask = rng.random(n) < 0.7
    key = rng.integers(0, 12, n).astype(np.int32)   # many ties: stability
    pt = torch.from_numpy(payload)
    got = tremap.compact_sorted((pt[:, :2], pt[:, 2]),
                                torch.from_numpy(mask),
                                torch.from_numpy(key), out_cap)
    want = jremap.compact_sorted(jnp.asarray(payload), jnp.asarray(mask),
                                 jnp.asarray(key), out_cap)
    cols, last = got[0]
    np.testing.assert_array_equal(torch.cat([cols, last[:, None]], 1).numpy(),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_remap_capacities_equal(workers):
    kw = dict(seed=3, distribution="powerlaw")
    ft = tfly.build_flycoo(tten.random_sparse_tensor((40, 30, 20), 500, **kw),
                           workers, **FLYCOO_KW)
    fj = jfly.build_flycoo(jten.random_sparse_tensor((40, 30, 20), 500, **kw),
                           workers, **FLYCOO_KW)
    assert tremap.remap_capacities(ft) == jremap.remap_capacities(fj)


def test_exchange_is_identity_at_one_worker_and_raises_beyond():
    """One worker keeps its buckets; D in {2, 4} workers in one process
    exchange them as the reference's all_to_all does (run under
    ``jax.vmap`` over a named axis, the D workers of a mesh); buckets
    whose worker axes disagree with the workers raise."""
    b = torch.ones(1, 1, 3, 4)
    m = torch.ones(1, 1, 3, dtype=torch.bool)
    (out,), om = tremap.exchange((b,), m, LocalWorkers(1, "cpu"))
    assert torch.equal(out, b) and torch.equal(om, m)
    for D in (2, 4):
        rng = np.random.default_rng(D)
        bn = rng.standard_normal((D, D, 3, 4)).astype(np.float32)
        mn = rng.random((D, D, 3)) < 0.5
        (out,), om = tremap.exchange((torch.from_numpy(bn),),
                                     torch.from_numpy(mn),
                                     LocalWorkers(D, "cpu"))
        want, wmask = jax.vmap(lambda x, y: jremap.exchange(x, y, "w"),
                               axis_name="w")(jnp.asarray(bn),
                                              jnp.asarray(mn))
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
        np.testing.assert_array_equal(om.numpy(), np.asarray(wmask))
    with pytest.raises(ValueError, match="workers"):
        tremap.exchange((torch.ones(2, 2, 3, 4),),
                        torch.ones(2, 2, 3, dtype=torch.bool),
                        LocalWorkers(4, "cpu"))
    with pytest.raises(ValueError, match="destinations"):
        tremap.exchange((torch.ones(2, 3, 3, 4),),
                        torch.ones(2, 3, 3, dtype=torch.bool),
                        LocalWorkers(2, "cpu"))


@pytest.mark.parametrize("shape", [(30, 20, 10), (9, 8, 7, 6)])
def test_device_remap_equals_pack_mode(shape):
    """At one worker a remap is a stable re-sort by the next mode's row:
    after each transition the stream holds pack_mode(next)'s nonzeros,
    in the same row order (ties keep the previous mode's order)."""
    t = tten.random_sparse_tensor(shape, 400, seed=5)
    ft = tfly.build_flycoo(t, 1)
    rt, (idx, val, mask) = tdist.prepare_runtime(ft, 8)
    cur = (torch.from_numpy(idx), torch.from_numpy(val),
           torch.from_numpy(mask))
    for n in range(len(shape)):
        nxt = (n + 1) % len(shape)
        oidx, oval, omask, dropped = tdist.device_remap(
            *cur, nxt, rt, LocalWorkers(1, "cpu"))
        assert dropped.tolist() == [0]
        cur = (oidx, oval, omask)
        oidx, oval, omask = oidx[0], oval[0], omask[0]
        pidx, pval, pmask = tfly.pack_mode(ft, nxt)
        pidx = tdist._repad_indices(ft, pidx, rt.rows_cap)
        k = int(pmask[0].sum())
        assert int(omask.sum()) == k
        got_i, want_i = oidx.numpy()[:k], pidx[0, :k]
        np.testing.assert_array_equal(got_i[:, nxt], want_i[:, nxt])
        got_rows = np.concatenate(
            [got_i, oval.numpy()[:k, None].view(np.int32)], 1)
        want_rows = np.concatenate(
            [want_i, pval[0, :k, None].view(np.int32)], 1)
        np.testing.assert_array_equal(got_rows[np.lexsort(got_rows.T)],
                                      want_rows[np.lexsort(want_rows.T)])


def _healthy_vm(rng, r=6, rows=9):
    A = rng.standard_normal((r + 2, r)).astype(np.float32)
    V = (A.T @ A + np.eye(r, dtype=np.float32)).astype(np.float32)
    M = rng.standard_normal((rows, r)).astype(np.float32)
    return V, M


def _degrade(kind, V, M):
    V, M = V.copy(), M.copy()
    if kind == "nan":
        M[0, 0] = np.nan
    elif kind == "collapsed":
        V[2, :] = 0.0
        V[:, 2] = 0.0
    return V, M


@pytest.mark.parametrize("kind,level", [("clean", 0), ("nan", 1),
                                        ("collapsed", 1)])
def test_guarded_solve_matches_jax(kind, level):
    V, M = _degrade(kind, *_healthy_vm(np.random.default_rng(7)))
    X, lvl = tnum.guarded_solve(torch.from_numpy(V), torch.from_numpy(M))
    Xj, lj = jnum.guarded_solve(jnp.asarray(V), jnp.asarray(M))
    assert lvl == int(lj) == level
    assert tnum.GUARD_LEVELS == jnum.GUARD_LEVELS
    assert torch.isfinite(X).all()
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=1e-4,
                               atol=1e-5)


def test_guarded_solve_clean_is_the_plain_solve():
    V, M = _healthy_vm(np.random.default_rng(8))
    Vt, Mt = torch.from_numpy(V), torch.from_numpy(M)
    X, level = tnum.guarded_solve(Vt, Mt)
    assert level == 0
    plain = torch.linalg.solve(Vt + 1e-9 * torch.eye(V.shape[0]), Mt.T).T
    assert torch.equal(X, plain)


def test_guarded_solve_all_zero_hits_lstsq():
    V = torch.zeros(5, 5)
    M = torch.full((7, 5), 1e38)
    X, level = tnum.guarded_solve(V, M, ridge=0.0)
    Xj, lj = jnum.guarded_solve(jnp.zeros((5, 5)), jnp.full((7, 5), 1e38),
                                ridge=0.0)
    assert tnum.GUARD_LEVELS[level] == "lstsq" == jnum.GUARD_LEVELS[int(lj)]
    assert torch.isfinite(X).all()
    np.testing.assert_array_equal(X.numpy(), np.asarray(Xj))
