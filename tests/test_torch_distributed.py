"""Port parity: Dynasor on D > 1 workers against the JAX reference.

Three sources of truth:

* the reference's host-side pieces (``prepare_runtime``, ``init_factors``,
  ``remap_capacities``, ``bucket_by_destination``, ``remap_local``,
  ``even_split_pack``), called in this process at D in {2, 4}: equal
  exactly;
* the reference's collectives (``remap.exchange``, ``all_gather``,
  ``psum``, ``pmax``) under ``jax.vmap`` with a named axis, the D
  workers of a mesh without the devices;
* the reference's 4-device CPU mesh, run once in a subprocess (as
  ``tests/test_distributed.py`` runs it): ``make_spmttkrp_all_modes``
  with and without the remap, every remap transition,
  ``make_baseline_all_modes``, ALS sweeps and ``cp_als_distributed``
  (``segsum``). Layouts and ``dropped`` equal exactly, mode outputs at
  rtol 2e-5, factors at 1e-4, fits at 1e-5 absolute.

The port runs on the CPU as :class:`LocalWorkers` (D workers in one
process), and as :class:`GroupWorkers` over gloo in 2 and 4 spawned
processes, each rank held bitwise against its ``LocalWorkers`` slice.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import distributed as jdist  # noqa: E402
from repro.core import flycoo as jfly  # noqa: E402
from repro.core import remap as jremap  # noqa: E402
from repro.core import tensors as jten  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import cpals as tcpals  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import flycoo as tfly  # noqa: E402
from repro_torch.core import remap as tremap  # noqa: E402
from repro_torch.core import tensors as tten  # noqa: E402
from repro_torch.core.workers import LocalWorkers  # noqa: E402
from repro_torch.kernels.mttkrp import kernel as kk  # noqa: E402
from repro_torch.kernels.mttkrp import ops as kops  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANK, SWEEPS = 8, 3
OUT_TOL = dict(rtol=2e-5, atol=1e-5)
FAC_TOL = dict(rtol=1e-4, atol=1e-5)
FIT_TOL = 1e-5
# (tensor kwargs, build_flycoo kwargs). The powerlaw "pl" dedups to 25
# nonzeros: at R=8 its mode-2 normal equations have condition ~1e8, where
# two fp32 solves agree to no digit, so the ALS comparisons take the
# well-conditioned "m4" and "u3" (ALS_CASES); "pl" holds the layouts and
# mode outputs (skewed worker loads).
CASES = {
    "pl": (dict(shape=(60, 45, 30), nnz=500, seed=1,
                distribution="powerlaw"),
           dict(m_bounds=(4, 16), g_bounds=(8, 64), cache_bytes=1 << 20)),
    "m4": (dict(shape=(9, 8, 7, 6), nnz=400, seed=2),
           dict(m_bounds=(2, 8), g_bounds=(8, 64), cache_bytes=1 << 20)),
    "u3": (dict(shape=(30, 20, 10), nnz=500, seed=3),
           dict(m_bounds=(2, 8), g_bounds=(8, 64), cache_bytes=1 << 20)),
}
MESH_CASES = ("pl", "m4", "u3")
ALS_CASES = ("m4", "u3")
BACKENDS = ("auto", "pallas_fused_gather", "pallas_fused_gather_tiled",
            "pallas_fused", "pallas_fused_tiled", "pallas",
            "pallas_fused_gather_stream")

REFERENCE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.core import cpals, distributed as dist, flycoo, tensors

cases, als_cases, RANK, SWEEPS = json.loads(sys.argv[2])
out = {}
for D in (2, 4):
    mesh = Mesh(np.array(jax.devices()[:D]), (dist.AXIS,))
    for name, (tkw, fkw) in cases.items():
        key = f"D{D}_{name}_"
        t = tensors.random_sparse_tensor(**tkw)
        ft = flycoo.build_flycoo(t, D, **fkw)
        rt, (idx, val, mask) = dist.prepare_runtime(ft, RANK)
        fac = dist.init_factors(ft, rt, seed=0)
        for remap in (True, False):
            fn = dist.make_spmttkrp_all_modes(rt, mesh, remap=remap)
            outs, stream, dg = fn(idx, val, mask, *fac)
            tag = key + ("remap_" if remap else "case2_")
            for n, o in enumerate(outs):
                out[tag + f"out{n}"] = np.asarray(o)
            if remap:
                out[key + "dropped"] = np.asarray(dg["dropped"])
                for part, x in zip(("idx", "val", "mask"), stream):
                    out[key + "cycle_" + part] = np.asarray(x)
        _, remap_fns = cpals.make_instrumented_mode_fns(rt, mesh)
        cur = (idx, val, mask)
        for n in range(rt.nmodes):
            cur = remap_fns[n](*cur)
            for part, x in zip(("idx", "val", "mask"), cur):
                out[key + f"t{n}_{part}"] = np.asarray(x)
        bouts = dist.make_baseline_all_modes(rt, mesh)(
            *dist.even_split_pack(ft, rt), *fac)
        for n, o in enumerate(bouts):
            out[key + f"base_out{n}"] = np.asarray(o)
        if name not in als_cases:
            continue
        sweep = cpals.make_als_sweep(rt, mesh, backend="segsum")
        x2 = np.broadcast_to(np.float32(np.sum(
            ft.tensor.values.astype(np.float64) ** 2)), (D,)).copy()
        st, f, lam = (idx, val, mask), [jnp.asarray(a) for a in fac], \
            jnp.ones((RANK,), jnp.float32)
        for it in range(SWEEPS):
            st, f, lam, fit = sweep(*st, x2, *f, lam, jnp.asarray(it == 0))
            s = key + f"sweep{it}_"
            out[s + "fit"] = np.asarray(fit)
            out[s + "lam"] = np.asarray(lam)
            for n, a in enumerate(f):
                out[s + f"factor{n}"] = np.asarray(a)
        res = cpals.cp_als_distributed(ft, RANK, mesh, iters=SWEEPS, tol=0.0)
        out[key + "cp_fits"] = np.asarray(res.fits)
        out[key + "cp_lam"] = res.lam
        for n, a in enumerate(res.factors):
            out[key + f"cp_factor{n}"] = a
np.savez(sys.argv[1], **out)
print("REFERENCE-OK")
"""


@pytest.fixture(scope="module")
def mesh_ref(tmp_path_factory):
    """The reference on its 4-device CPU mesh (D = 2 and 4), once."""
    path = tmp_path_factory.mktemp("mesh_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    cases = {k: CASES[k] for k in MESH_CASES}
    out = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(path),
         json.dumps([cases, ALS_CASES, RANK, SWEEPS])],
        env=env, capture_output=True, text=True, timeout=600)
    assert "REFERENCE-OK" in out.stdout, out.stdout + out.stderr
    with np.load(path) as z:
        return dict(z)


def _tensors(name, D):
    tkw, fkw = CASES[name]
    t = tten.random_sparse_tensor(**tkw)
    tj = jten.random_sparse_tensor(**tkw)
    return tfly.build_flycoo(t, D, **fkw), jfly.build_flycoo(tj, D, **fkw)


def _port(name, D):
    """``(ft, rt, stream, factors, lam, x_norm_sq, workers)`` on the CPU."""
    ft, _ = _tensors(name, D)
    rt, packed = tdist.prepare_runtime(ft, RANK)
    wk = LocalWorkers(D, "cpu")
    return (ft, rt) + tcpals.device_state(ft, rt, packed, seed=0,
                                          workers=wk) + (wk,)


def _assert_stream_equal(got, ref, key):
    for part, x in zip(("idx", "val", "mask"), got):
        np.testing.assert_array_equal(x.numpy(), ref[key + part],
                                      err_msg=key + part)


_jax_bucket = jax.jit(jremap.bucket_by_destination, static_argnums=(2, 3))


def _by_rows(idx, val, mask):
    """One worker's valid nonzeros as sorted ``(coords, value bits)`` rows:
    the layout's content, whatever the order inside an output row."""
    rows = np.concatenate([idx[mask], val[mask, None].view(np.int32)], 1)
    return rows[np.lexsort(rows.T)]


# ---------------------------------------------------------------------------
# The reference's host-side pieces, in this process: equal exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("D", [2, 4])
def test_runtime_init_and_capacities_equal(name, D):
    ft, fj = _tensors(name, D)
    rt, packed = tdist.prepare_runtime(ft, RANK)
    rj, packed_j = jdist.prepare_runtime(fj, RANK)
    for f in ("num_workers", "nmodes", "rank", "rows_cap", "i_pad", "nnz_cap",
              "bucket_cap", "shape", "blk", "tile_rows", "bucket_caps"):
        assert getattr(rt, f) == getattr(rj, f), f
    assert rt.num_workers == D
    for a, b in zip(packed, packed_j):
        assert a.dtype == b.dtype and a.shape[0] == D
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tdist.init_factors(ft, rt, seed=0),
                    jdist.init_factors(fj, rj, seed=0)):
        np.testing.assert_array_equal(a, b)
    assert tremap.remap_capacities(ft) == jremap.remap_capacities(fj)
    assert tremap.remap_capacity(ft) == jremap.remap_capacity(fj)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("D", [2, 4])
def test_remap_local_and_even_split_pack_equal(name, D):
    ft, fj = _tensors(name, D)
    for n in range(ft.nmodes):
        for a, b in zip(tremap.remap_local(ft, n), jremap.remap_local(fj, n)):
            np.testing.assert_array_equal(a, b)
    rt, _ = tdist.prepare_runtime(ft, RANK)
    rj, _ = jdist.prepare_runtime(fj, RANK)
    for a, b in zip(tdist.even_split_pack(ft, rt),
                    jdist.even_split_pack(fj, rj)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("D", [2, 4])
def test_buckets_of_every_worker_equal(name, D):
    """Each worker's send buckets and ``dropped`` for every transition out
    of its ``remap_local`` layout, at the runtime's capacity and at one
    that overflows, against the reference's ``bucket_by_destination`` on
    its packed payload."""
    ft, _ = _tensors(name, D)
    rt, _ = tdist.prepare_runtime(ft, RANK)
    for n in range(ft.nmodes):
        nxt = (n + 1) % ft.nmodes
        idx, val, mask = tremap.remap_local(ft, n)
        idx = tdist._repad_indices(ft, idx, rt.rows_cap)
        for cap in (rt.bucket_cap_for(n), max(1, rt.bucket_cap_for(n) // 2)):
            # All D workers bucketed at once, as device_remap does.
            dest = torch.where(
                torch.from_numpy(mask),
                torch.from_numpy(idx[..., nxt] // rt.rows_cap[nxt]),
                D).to(torch.int32)
            (bidx, bval), bmask, bdrop = tremap.bucket_by_destination(
                dest, (torch.from_numpy(idx), torch.from_numpy(val)), D, cap)
            for d in range(D):
                got = bidx[d], bval[d], bmask[d], bdrop[d]
                # One worker's stream alone buckets the same.
                (oidx, oval), omask, odrop = tremap.bucket_by_destination(
                    dest[d], (torch.from_numpy(idx[d]),
                              torch.from_numpy(val[d])), D, cap)
                for x, y in zip(got, (oidx, oval, omask, odrop)):
                    assert torch.equal(x, y)
                want, wmask, wdrop = _jax_bucket(
                    jnp.asarray(dest[d].numpy()),
                    jdist._pack_payload(jnp.asarray(idx[d]),
                                        jnp.asarray(val[d])), D, cap)
                widx, wval = jdist._unpack_payload(
                    jnp.asarray(want).reshape(D * cap, -1), ft.nmodes)
                np.testing.assert_array_equal(
                    got[0].reshape(D * cap, -1).numpy(), np.asarray(widx))
                np.testing.assert_array_equal(
                    got[1].reshape(-1).numpy().view(np.int32),
                    np.asarray(wval).view(np.int32))
                np.testing.assert_array_equal(got[2].numpy(),
                                              np.asarray(wmask))
                assert int(got[3]) == int(wdrop)


@pytest.mark.parametrize("D", [2, 4])
def test_local_workers_collectives_match_jax(D):
    """all_to_all, all_gather, psum and pmax of :class:`LocalWorkers`
    against the reference's collectives under ``jax.vmap`` over a named
    axis (the D workers of a mesh)."""
    rng = np.random.default_rng(D)
    b = rng.standard_normal((D, D, 5, 3)).astype(np.float32)
    m = rng.random((D, D, 5)) < 0.5
    x = rng.standard_normal((D, 7, 4)).astype(np.float32)
    wk = LocalWorkers(D, "cpu")
    (got_b,), got_m = tremap.exchange((torch.from_numpy(b),),
                                      torch.from_numpy(m), wk)
    want_b, want_m = jax.vmap(lambda u, v: jremap.exchange(u, v, "w"),
                              axis_name="w")(jnp.asarray(b), jnp.asarray(m))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    tx = torch.from_numpy(x)
    gathered = jax.vmap(lambda u: jax.lax.all_gather(u, "w", axis=0,
                                                     tiled=True),
                        axis_name="w")(jnp.asarray(x))
    for d in range(D):
        np.testing.assert_array_equal(wk.all_gather(tx).numpy(),
                                      np.asarray(gathered[d]))
    psum = jax.vmap(lambda u: jax.lax.psum(u, "w"), axis_name="w")(x)
    np.testing.assert_allclose(wk.psum(tx).numpy(), np.asarray(psum[0]),
                               rtol=1e-6, atol=1e-6)
    pmax = jax.vmap(lambda u: jax.lax.pmax(u, "w"), axis_name="w")(x)
    np.testing.assert_array_equal(wk.pmax(tx).numpy(), np.asarray(pmax[0]))
    assert wk.sent_bytes == {"all_to_all": b.nbytes + m.nbytes,
                             "all_gather": D * x.nbytes,
                             "psum": x.nbytes, "pmax": x.nbytes}
    with pytest.raises(ValueError, match="workers"):
        wk.psum(tx[:1])


# ---------------------------------------------------------------------------
# The reference's 4-device mesh (subprocess)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remap", [True, False])
@pytest.mark.parametrize("name", MESH_CASES)
@pytest.mark.parametrize("D", [2, 4])
def test_spmttkrp_all_modes_matches_mesh(mesh_ref, D, name, remap):
    ft, rt, stream, factors, _, _, wk = _port(name, D)
    fn = tdist.make_spmttkrp_all_modes(rt, wk, remap=remap)
    outs, cycled, diags = fn(*stream, *factors)
    key = f"D{D}_{name}_"
    for n, o in enumerate(outs):
        assert o.shape == (rt.i_pad[n], RANK)
        np.testing.assert_allclose(
            o.numpy(), mesh_ref[key + ("remap_" if remap else "case2_")
                                + f"out{n}"], **OUT_TOL)
    if remap:
        _assert_stream_equal(cycled, mesh_ref, key + "cycle_")
        assert diags["dropped"].shape == (D,)
        assert int(diags["dropped"].sum()) == int(mesh_ref[key + "dropped"]) \
            == 0
    else:
        for a, b in zip(cycled, stream):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", MESH_CASES)
@pytest.mark.parametrize("D", [2, 4])
def test_every_remap_transition_matches_mesh(mesh_ref, D, name):
    ft, rt, stream, _, _, _, wk = _port(name, D)
    cur = stream
    for n in range(rt.nmodes):
        *cur, dropped = tdist.device_remap(*cur, (n + 1) % rt.nmodes, rt, wk)
        assert dropped.tolist() == [0] * D
        _assert_stream_equal(cur, mesh_ref, f"D{D}_{name}_t{n}_")
    # The wire bytes: one (D, D, cap) exchange of coordinates, values and
    # mask per transition.
    per_entry = 4 * rt.nmodes + 4 + 1
    assert wk.sent_bytes == {"all_to_all": sum(
        D * D * rt.bucket_cap_for(n) * per_entry for n in range(rt.nmodes))}


@pytest.mark.parametrize("name", MESH_CASES)
@pytest.mark.parametrize("D", [2, 4])
def test_baseline_matches_mesh(mesh_ref, D, name):
    ft, rt, _, factors, _, _, wk = _port(name, D)
    packed = [torch.from_numpy(a) for a in tdist.even_split_pack(ft, rt)]
    outs = tdist.make_baseline_all_modes(rt, wk)(*packed, *factors)
    for n, o in enumerate(outs):
        np.testing.assert_allclose(o.numpy(),
                                   mesh_ref[f"D{D}_{name}_base_out{n}"],
                                   **OUT_TOL)
    assert wk.sent_bytes == {"psum": D * sum(p * RANK * 4 for p in rt.i_pad)}


@pytest.mark.parametrize("name", ALS_CASES)
@pytest.mark.parametrize("D", [2, 4])
def test_als_sweeps_match_mesh(mesh_ref, D, name):
    ft, rt, stream, factors, lam, x2, wk = _port(name, D)
    for it in range(SWEEPS):
        res = tcpals.als_sweep(stream, factors, lam, x2, rt, sweep0=it == 0,
                               workers=wk)
        stream, factors, lam = res.stream, res.factors, res.lam
        key = f"D{D}_{name}_sweep{it}_"
        for n, f in enumerate(factors):
            np.testing.assert_allclose(f.numpy(), mesh_ref[key + f"factor{n}"],
                                       **FAC_TOL)
        np.testing.assert_allclose(lam.numpy(), mesh_ref[key + "lam"],
                                   **FAC_TOL)
        assert abs(float(res.fit) - float(mesh_ref[key + "fit"])) < FIT_TOL
        assert [m.shape for m in res.mttkrp] == [
            (D, rc, RANK) for rc in rt.rows_cap]
    # A sweep ends where it began: the mode-0 owners' layout.
    _assert_stream_equal(stream, mesh_ref, f"D{D}_{name}_cycle_")


@pytest.mark.parametrize("name", ALS_CASES)
@pytest.mark.parametrize("D", [2, 4])
def test_cp_als_distributed_matches_mesh(mesh_ref, D, name):
    ft, _ = _tensors(name, D)
    key = f"D{D}_{name}_"
    got = tcpals.cp_als_distributed(ft, RANK, device="cpu", iters=SWEEPS,
                                    tol=0.0)
    assert got.iters == SWEEPS
    np.testing.assert_allclose(got.fits, mesh_ref[key + "cp_fits"], rtol=0,
                               atol=FIT_TOL)
    for n, f in enumerate(got.factors):
        np.testing.assert_allclose(f, mesh_ref[key + f"cp_factor{n}"],
                                   **FAC_TOL)
    np.testing.assert_allclose(got.lam, mesh_ref[key + "cp_lam"], **FAC_TOL)
    one = tcpals.cp_als_distributed(ft, RANK, device="cpu", iters=1)
    rt, _ = tdist.prepare_runtime(ft, RANK)
    for n, f in enumerate(one.factors):
        want = tdist.unpermute_factor(ft, rt, n,
                                      mesh_ref[key + f"sweep0_factor{n}"])
        np.testing.assert_allclose(f, want, **FAC_TOL)
    assert abs(one.fit - float(mesh_ref[key + "sweep0_fit"])) < FIT_TOL


# ---------------------------------------------------------------------------
# The port's own contracts at D = 4 (plain versions on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["pl", "m4"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_backends_bitwise_at_four_workers(name, backend):
    """Every kernel backend (and ``auto``) gives the same outputs bit for
    bit at D=4: each worker's mode step runs on one aligned stream with
    its row offset; ``segsum`` (``index_add_`` in element order) agrees
    at the fp32 tolerance."""
    ft, rt, stream, factors, _, _, wk = _port(name, 4)
    want, _, _ = tdist.make_spmttkrp_all_modes(
        rt, wk, backend="pallas_fused_gather")(*stream, *factors)
    got, cycled, diags = tdist.make_spmttkrp_all_modes(
        rt, wk, backend=backend)(*stream, *factors)
    plain, _, _ = tdist.make_spmttkrp_all_modes(rt, wk)(*stream, *factors)
    for a, b, p in zip(got, want, plain):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), p.numpy(), **OUT_TOL)
    assert int(diags["dropped"].sum()) == 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_remap_cycle_returns_the_mode0_layout(name):
    """After one remap per mode every worker holds its mode-0 nonzeros
    again, in the same output rows (``remap_local`` is the oracle; ties
    inside a row may come back in another order)."""
    ft, rt, stream, _, _, _, wk = _port(name, 4)
    cur = stream
    for n in range(rt.nmodes):
        nxt = (n + 1) % rt.nmodes
        *cur, _ = tdist.device_remap(*cur, nxt, rt, wk)
        oidx, oval, omask = tremap.remap_local(ft, nxt)
        oidx = tdist._repad_indices(ft, oidx, rt.rows_cap)
        for d in range(4):
            i, v, m = (x[d].numpy() for x in cur)
            np.testing.assert_array_equal(m, omask[d])
            np.testing.assert_array_equal(i[m, nxt], oidx[d][omask[d], nxt])
            np.testing.assert_array_equal(_by_rows(i, v, m),
                                          _by_rows(oidx[d], oval[d], omask[d]))
    for d in range(4):
        np.testing.assert_array_equal(
            _by_rows(*(x[d].numpy() for x in cur)),
            _by_rows(*(x[d].numpy() for x in stream)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_four_workers_equal_one_in_natural_order(name):
    """``init_factors`` draws the same natural factors at every D, so the
    D=4 and D=1 outputs agree row for row once unpermuted."""
    nat = {}
    for D in (1, 4):
        ft, rt, stream, factors, _, _, wk = _port(name, D)
        outs, _, _ = tdist.make_spmttkrp_all_modes(
            rt, wk, backend="pallas_fused_gather")(*stream, *factors)
        nat[D] = [tdist.unpermute_factor(ft, rt, n, o.numpy())
                  for n, o in enumerate(outs)]
    for a, b in zip(nat[4], nat[1]):
        np.testing.assert_allclose(a, b, **OUT_TOL)


def test_padding_rows_of_worker_3_change_nothing():
    """Worker 3's mode-0 layout three ways: padding pointing at its own
    first row (``pack_mode``), at row 0 of every mode (after a remap; row
    0 is worker 0's), or cut off. B6's windows and every backend's output
    at worker 3's row offset are the same."""
    ft, _ = _tensors("u3", 4)
    rt, (idx, val, mask) = tdist.prepare_runtime(ft, RANK)
    i, v, m = idx[3], val[3], mask[3]
    assert (~m).any() and (i[~m, 0] == 3 * rt.rows_cap[0]).all()
    k = int(m.sum())
    variants = [(i, v, m), (np.where(m[:, None], i, 0), v, m),
                (i[:k], v[:k], m[:k])]
    factors = [torch.from_numpy(f) for f in tdist.init_factors(ft, rt)]
    kw = dict(mode=0, rows_cap=rt.rows_cap[0], row_offset=3 * rt.rows_cap[0],
              blk=rt.blk, tile_rows=rt.tile_rows)
    windows, outs = [], []
    for i, v, m in variants:
        i, v, m = (torch.from_numpy(np.ascontiguousarray(x))
                   for x in (i, v, m))
        args = kops.gather_operands(i, v, m, factors, slab=16, **kw)
        frows = [kops._pad_factor_rows(f, kk.FACTOR_ROW_TILE).shape[0]
                 for f in args[2]]
        windows.append(kops.stream_schedules(args[1], rt.blk, frows)[1])
        outs.append([kops.mttkrp_device_step(i, v, m, factors, backend=b,
                                             **kw) for b in BACKENDS])
    assert windows[0] == windows[1] == windows[2]
    for got in outs:
        for a in got:
            assert torch.equal(a, outs[0][1])


def test_state_from_reference_with_worker_axis():
    """The reference's ``(D, cap, ...)`` stream and factors, carried by
    ``convert``, give the sweep a run from ``prepare_runtime`` gives."""
    ft, rt, stream, factors, lam, x2, wk = _port("pl", 4)
    _, fj = _tensors("pl", 4)
    rj, packed_j = jdist.prepare_runtime(fj, RANK)
    tfac, tlam, tstream = convert.state_from_reference(
        jdist.init_factors(fj, rj, seed=0), np.ones(RANK, np.float32),
        packed_j, device="cpu")
    assert tstream[0].shape == (4, rt.nnz_cap, 3)
    want = tcpals.als_sweep(stream, factors, lam, x2, rt, workers=wk,
                            sweep0=True)
    got = tcpals.als_sweep(tstream, tfac, tlam, x2, rt, workers=wk,
                           sweep0=True)
    for a, b in zip(got.factors + list(got.stream), want.factors
                    + list(want.stream)):
        assert torch.equal(a, b)
    assert float(got.fit) == float(want.fit)
    with pytest.raises(ValueError, match="workers"):
        convert.state_from_reference(
            jdist.init_factors(fj, rj, seed=0), np.ones(RANK), packed_j,
            workers=LocalWorkers(2, "cpu"))


def test_cp_als_distributed_checks_its_workers():
    ft, _ = _tensors("pl", 4)
    with pytest.raises(ValueError, match="workers"):
        tcpals.cp_als_distributed(ft, RANK, workers=LocalWorkers(2, "cpu"),
                                  iters=1)


# ---------------------------------------------------------------------------
# GroupWorkers: one worker per process, gloo on the CPU
# ---------------------------------------------------------------------------

RANK_SCRIPT = r"""
import datetime, json, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as tdist
rank, world, rdv, out_path, case = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4],
                                    json.loads(sys.argv[5]))
tkw, fkw, R, sweeps = case
tdist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                         world_size=world,
                         timeout=datetime.timedelta(seconds=60))
try:
    from repro_torch import convert
    from repro_torch.core import cpals, distributed as dist, flycoo, tensors
    from repro_torch.core.workers import GroupWorkers
    ft = flycoo.build_flycoo(tensors.random_sparse_tensor(**tkw), world,
                             **fkw)
    rt, packed = dist.prepare_runtime(ft, R)
    wk = GroupWorkers(device="cpu")
    factors, lam, stream = convert.state_from_reference(
        dist.init_factors(ft, rt, seed=0), np.ones(R, np.float32), packed,
        workers=wk)
    out = {"stream_idx": stream[0].numpy()}
    wk.reset_bytes()
    outs, cyc, dg = dist.make_spmttkrp_all_modes(rt, wk)(*stream, *factors)
    out["bytes"] = np.array(json.dumps(wk.sent_bytes))
    for n, o in enumerate(outs):
        out[f"remap_out{n}"] = o.numpy()
    for part, x in zip(("idx", "val", "mask"), cyc):
        out["cycle_" + part] = x.numpy()
    out["dropped"] = dg["dropped"].numpy()
    cur = stream
    for n in range(rt.nmodes):
        cur = dist.device_remap(*cur, (n + 1) % rt.nmodes, rt, wk)[:3]
        for part, x in zip(("idx", "val", "mask"), cur):
            out[f"t{n}_{part}"] = x.numpy()
    outs = dist.make_spmttkrp_all_modes(rt, wk, remap=False)(
        *stream, *factors)[0]
    for n, o in enumerate(outs):
        out[f"case2_out{n}"] = o.numpy()
    base = [torch.from_numpy(a[rank:rank + 1])
            for a in dist.even_split_pack(ft, rt)]
    for n, o in enumerate(dist.make_baseline_all_modes(rt, wk)(*base,
                                                             *factors)):
        out[f"base_out{n}"] = o.numpy()
    res = cpals.als_sweep(stream, factors, lam, torch.tensor(np.float32(
        np.sum(ft.tensor.values.astype(np.float64) ** 2))), rt, sweep0=True,
        workers=wk)
    for n, m in enumerate(res.mttkrp):
        out[f"sweep_mttkrp{n}"] = m.numpy()
    out["sweep_fit"] = res.fit.numpy()
    cp = cpals.cp_als_distributed(ft, R, workers=wk, iters=sweeps, tol=0.0)
    out["cp_fits"] = np.asarray(cp.fits)
    for n, f in enumerate(cp.factors):
        out[f"cp_factor{n}"] = f
    np.savez(out_path, **out)
finally:
    tdist.destroy_process_group()
print("RANK-OK", rank)
"""


def _run_group(tmp_path, world, case):
    env = dict(os.environ, PYTHONPATH=SRC)
    rdv = str(tmp_path / "rendezvous")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(r), str(world), rdv,
         str(tmp_path / f"rank{r}.npz"), json.dumps(case)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (so, se)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RANK-OK {r}" in so, so + se
    out = []
    for r in range(world):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            out.append(dict(z))
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_group_workers_over_gloo_equal_local_workers(tmp_path, world):
    """Each gloo rank's layouts, local outputs and remapped streams are
    bitwise its :class:`LocalWorkers` slice; psummed outputs, fits and
    factors agree at the fp32 tolerance (``all_reduce`` adds in its own
    order); the bytes the ranks hand to the collectives in one all-modes
    call add up to ``LocalWorkers``'."""
    name = "u3"
    ranks = _run_group(tmp_path, world, list(CASES[name]) + [RANK, SWEEPS])
    ft, rt, stream, factors, lam, x2, wk = _port(name, world)
    outs, cyc, dg = tdist.make_spmttkrp_all_modes(rt, wk)(*stream, *factors)
    sent = dict(wk.sent_bytes)
    trans, cur = [], stream
    for n in range(rt.nmodes):
        cur = tdist.device_remap(*cur, (n + 1) % rt.nmodes, rt, wk)[:3]
        trans.append(cur)
    case2 = tdist.make_spmttkrp_all_modes(rt, wk, remap=False)(
        *stream, *factors)[0]
    base = tdist.make_baseline_all_modes(rt, wk)(
        *[torch.from_numpy(a) for a in tdist.even_split_pack(ft, rt)],
        *factors)
    sweep = tcpals.als_sweep(stream, factors, lam, x2, rt, sweep0=True,
                             workers=wk)
    cp = tcpals.cp_als_distributed(ft, RANK, device="cpu", iters=SWEEPS,
                                   tol=0.0)
    total = {}
    for r, got in enumerate(ranks):
        sl = slice(r, r + 1)
        np.testing.assert_array_equal(got["stream_idx"], stream[0][sl])
        for n in range(rt.nmodes):
            np.testing.assert_array_equal(got[f"remap_out{n}"], outs[n])
            # Mode 0 runs on the initial factors; later modes on factors
            # normalized by psummed norms, equal only to rounding.
            if n == 0:
                np.testing.assert_array_equal(got["sweep_mttkrp0"],
                                              sweep.mttkrp[0][sl])
            else:
                np.testing.assert_allclose(got[f"sweep_mttkrp{n}"],
                                           sweep.mttkrp[n][sl], **OUT_TOL)
            for part, x in zip(("idx", "val", "mask"), trans[n]):
                np.testing.assert_array_equal(got[f"t{n}_{part}"], x[sl])
            np.testing.assert_allclose(got[f"case2_out{n}"], case2[n],
                                       **OUT_TOL)
            np.testing.assert_allclose(got[f"base_out{n}"], base[n],
                                       **OUT_TOL)
            np.testing.assert_allclose(got[f"cp_factor{n}"], cp.factors[n],
                                       **FAC_TOL)
        for part, x in zip(("idx", "val", "mask"), cyc):
            np.testing.assert_array_equal(got["cycle_" + part], x[sl])
        np.testing.assert_array_equal(got["dropped"], dg["dropped"][sl])
        assert abs(float(got["sweep_fit"]) - float(sweep.fit)) < FIT_TOL
        np.testing.assert_allclose(got["cp_fits"], cp.fits, rtol=0,
                                   atol=FIT_TOL)
        for k, v in json.loads(str(got["bytes"])).items():
            total[k] = total.get(k, 0) + v
    assert total == sent
