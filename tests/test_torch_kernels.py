"""Port parity: the in-kernel-gather MTTKRP (B1, B2) and the engines around it.

On a CPU tensor the port's kernel wrappers run their plain PyTorch
versions; these are held against the JAX package's Pallas kernels run in
interpret mode, at small sizes (blk=32, tile_rows=8). The CUDA kernels
themselves are held against the same plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import mttkrp as jmt  # noqa: E402
from repro.kernels.mttkrp import kernel as jk  # noqa: E402
from repro.kernels.mttkrp import ops as jops  # noqa: E402
from repro.kernels.mttkrp import ref as jref  # noqa: E402
from repro_torch.core import mttkrp as tmt  # noqa: E402
from repro_torch.core.tensors import random_sparse_tensor  # noqa: E402
from repro_torch.kernels.mttkrp import kernel as tk  # noqa: E402
from repro_torch.kernels.mttkrp import ops as tops  # noqa: E402
from repro_torch.kernels.mttkrp import ref as tref  # noqa: E402

BLK, TILE = 32, 8
SHAPES = {3: (20, 16, 12), 4: (12, 10, 8, 6), 5: (8, 7, 6, 5, 4)}
RTOL, ATOL = 2e-5, 1e-5


def _case(nmodes, rank, nnz=150, seed=0):
    """Mode-0 block-aligned operands (numpy) + factors, from one seed."""
    shape = SHAPES[nmodes]
    t = random_sparse_tensor(shape, nnz, seed=seed)
    order = np.argsort(t.indices[:, 0], kind="stable")
    idx = t.indices[order].astype(np.int32)
    val = t.values[order].astype(np.float32)
    rng = np.random.default_rng(seed + 1)
    factors = [rng.standard_normal((d, rank)).astype(np.float32)
               for d in shape]
    rows_cap = -(-shape[0] // TILE) * TILE
    valid = np.ones(len(val), bool)
    slot, tob = jops.build_block_layout(
        jnp.asarray(idx[:, 0]), jnp.asarray(valid), rows_cap=rows_cap,
        blk=BLK, tile_rows=TILE)
    n_pad = jops.n_pad_for(len(val), rows_cap, BLK, TILE)
    al = lambda x: np.asarray(jops._align_to_blocks(jnp.asarray(x), slot,
                                                    n_pad))
    ops_np = dict(vals=al(val), idx=al(idx[:, 1:]), rows=al(idx[:, 0] % TILE),
                  tob=np.asarray(tob))
    return ops_np, factors[1:], rows_cap, (idx, val, factors)


def _jax_kernel(ops_np, factors, rows_cap, rank, tiled, out_init=None):
    fm = tuple(jops.pad_rank(jnp.asarray(f)) for f in factors)
    kw = dict(rows_cap=rows_cap, blk=BLK, tile_rows=TILE, interpret=True)
    if out_init is not None:
        kw["out_init"] = jops.pad_rank(jnp.asarray(out_init))
    kern = jk.fused_mttkrp_nmode_gather_tiled if tiled \
        else jk.fused_mttkrp_nmode_gather
    out = kern(jnp.asarray(ops_np["vals"]), jnp.asarray(ops_np["idx"]), fm,
               jnp.asarray(ops_np["rows"]), jnp.asarray(ops_np["tob"]), **kw)
    return np.asarray(out)[:, :rank]


def _port_args(ops_np, factors, slab):
    return (torch.from_numpy(ops_np["vals"]), torch.from_numpy(ops_np["idx"]),
            tuple(tops.pad_rank(torch.from_numpy(f), slab) for f in factors),
            torch.from_numpy(ops_np["rows"]), torch.from_numpy(ops_np["tob"]))


@pytest.mark.parametrize("nmodes", [3, 4, 5])
@pytest.mark.parametrize("rank", [8, 128, 256])
def test_gather_plain_matches_jax_kernel(nmodes, rank):
    ops_np, factors, rows_cap, _ = _case(nmodes, rank, seed=nmodes)
    kw = dict(rows_cap=rows_cap, blk=BLK, tile_rows=TILE)
    b1 = tk.fused_mttkrp_nmode_gather(
        *_port_args(ops_np, factors, tops.padded_rank(rank)), **kw)
    slab = tops.tiled_rank_slab(rank)
    b2 = tk.fused_mttkrp_nmode_gather_tiled(
        *_port_args(ops_np, factors, slab), rank_slab=slab, **kw)
    want1 = _jax_kernel(ops_np, factors, rows_cap, rank, tiled=False)
    want2 = _jax_kernel(ops_np, factors, rows_cap, rank, tiled=True)
    np.testing.assert_allclose(b1[:, :rank].numpy(), want1, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(b2[:, :rank].numpy(), want2, rtol=RTOL,
                               atol=ATOL)
    # Same columns, same arithmetic: B1-plain == B2-plain bitwise.
    assert torch.equal(b1[:, :rank], b2[:, :rank])


@pytest.mark.parametrize("tiled", [False, True])
def test_out_init_threading(tiled):
    rank = 16
    ops_np, factors, rows_cap, _ = _case(3, rank, seed=11)
    init = np.random.default_rng(5).standard_normal(
        (rows_cap, rank)).astype(np.float32)
    init_t = torch.from_numpy(init.copy())
    kw = dict(rows_cap=rows_cap, blk=BLK, tile_rows=TILE, out_init=init_t)
    if tiled:
        got = tk.fused_mttkrp_nmode_gather_tiled(
            *_port_args(ops_np, factors, 16), rank_slab=16, **kw)
    else:
        got = tk.fused_mttkrp_nmode_gather(
            *_port_args(ops_np, factors, 16), **kw)
    want = _jax_kernel(ops_np, factors, rows_cap, rank, tiled, out_init=init)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert np.array_equal(init_t.numpy(), init), "out_init was modified"
    # Splitting a stream into two halves threads the sum through out_init.
    nb = len(ops_np["tob"])
    halves = [{k: v[: nb // 2 * BLK] if k != "tob" else v[: nb // 2]
               for k, v in ops_np.items()},
              {k: v[nb // 2 * BLK:] if k != "tob" else v[nb // 2:]
               for k, v in ops_np.items()}]
    acc = None
    for h in halves:
        acc = tk.fused_mttkrp_nmode_gather(
            *_port_args(h, factors, 16), rows_cap=rows_cap, blk=BLK,
            tile_rows=TILE, out_init=acc)
    whole = tk.fused_mttkrp_nmode_gather(
        *_port_args(ops_np, factors, 16), rows_cap=rows_cap, blk=BLK,
        tile_rows=TILE)
    np.testing.assert_allclose(acc.numpy(), whole.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_cpu_tensors_never_count_launches():
    ops_np, factors, rows_cap, _ = _case(3, 16, seed=2)
    before = (tk.fused_mttkrp_nmode_gather.launches,
              tk.fused_mttkrp_nmode_gather_tiled.launches)
    args = _port_args(ops_np, factors, 16)
    kw = dict(rows_cap=rows_cap, blk=BLK, tile_rows=TILE)
    tk.fused_mttkrp_nmode_gather(*args, **kw)
    tk.fused_mttkrp_nmode_gather_tiled(*args, rank_slab=16, **kw)
    tk.fused_mttkrp_nmode_gather_plain(*args, **kw)
    assert (tk.fused_mttkrp_nmode_gather.launches,
            tk.fused_mttkrp_nmode_gather_tiled.launches) == before


def test_wrappers_reject_bad_operands():
    ops_np, factors, rows_cap, _ = _case(3, 16, seed=3)
    args = list(_port_args(ops_np, factors, 16))
    kw = dict(rows_cap=rows_cap, blk=BLK, tile_rows=TILE)
    bad_vals = args.copy()
    bad_vals[0] = args[0].double()
    with pytest.raises(ValueError):
        tk.fused_mttkrp_nmode_gather(*bad_vals, **kw)
    bad_idx = args.copy()
    bad_idx[1] = args[1].long()
    with pytest.raises(ValueError):
        tk.fused_mttkrp_nmode_gather(*bad_idx, **kw)
    with pytest.raises(ValueError):       # rank 16 is not a multiple of 128
        tk.fused_mttkrp_nmode_gather_tiled(*args, rank_slab=128, **kw)
    with pytest.raises(ValueError):       # rows_cap not a tile multiple
        tk.fused_mttkrp_nmode_gather(*args, rows_cap=rows_cap + 1, blk=BLK,
                                     tile_rows=TILE)
    odd = args.copy()
    odd[2] = tuple(f[:, :8] for f in args[2])
    with pytest.raises(ValueError):       # rank not padded to 16
        tk.fused_mttkrp_nmode_gather(*odd, **kw)


@pytest.mark.parametrize("nmodes", [3, 4])
@pytest.mark.parametrize("backend", ["ref", "pallas_fused_gather",
                                     "pallas_fused_gather_tiled"])
def test_device_step_matches_jax(nmodes, backend):
    rank = 8
    _, _, rows_cap, (idx, val, factors) = _case(nmodes, rank, seed=20)
    valid = np.ones(len(val), bool)
    valid[-7:] = False                       # trailing invalid elements
    kw = dict(mode=0, rows_cap=rows_cap, row_offset=0, blk=BLK,
              tile_rows=TILE, backend=backend)
    got = tops.mttkrp_device_step(
        torch.from_numpy(idx), torch.from_numpy(val),
        torch.from_numpy(valid), [torch.from_numpy(f) for f in factors],
        **kw)
    want = jops.mttkrp_device_step(
        jnp.asarray(idx), jnp.asarray(val), jnp.asarray(valid),
        [jnp.asarray(f) for f in factors], interpret=True, **kw)
    assert got.shape == (rows_cap, rank)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    ref = tmt.mttkrp_elementwise_ref(idx[valid], val[valid], factors, 0,
                                     out_rows=rows_cap)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("backend,kernel_backend", [
    ("pallas_fused_bf16", "pallas_fused"),
    ("pallas_fused_gather_bf16", "pallas_fused_gather"),
])
def test_unported_backends_raise(backend, kernel_backend):
    """The bf16 backend names run (B3 and B1 on bf16 factors) and match
    the JAX step on the same inputs; each is its kernel's backend with
    ``gather_dtype="bfloat16"`` bitwise."""
    _, _, rows_cap, (idx, val, factors) = _case(3, 8, seed=4)
    valid = np.ones(len(val), bool)
    kw = dict(mode=0, rows_cap=rows_cap, row_offset=0, blk=BLK,
              tile_rows=TILE)
    args = (torch.from_numpy(idx), torch.from_numpy(val),
            torch.from_numpy(valid), [torch.from_numpy(f) for f in factors])
    got = tops.mttkrp_device_step(*args, backend=backend, **kw)
    want = jops.mttkrp_device_step(
        jnp.asarray(idx), jnp.asarray(val), jnp.asarray(valid),
        [jnp.asarray(f) for f in factors], interpret=True, backend=backend,
        **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(got, tops.mttkrp_device_step(
        *args, backend=kernel_backend, gather_dtype="bfloat16", **kw))


def test_bf16_and_orderings_raise():
    _, _, rows_cap, (idx, val, factors) = _case(3, 8, seed=4)
    args = (torch.from_numpy(idx), torch.from_numpy(val),
            torch.ones(len(val), dtype=torch.bool),
            [torch.from_numpy(f) for f in factors])
    # bf16 gathers run and match the JAX bf16 step; an unknown gather
    # dtype raises ValueError, as in the reference.
    kw = dict(mode=0, rows_cap=rows_cap, row_offset=0, blk=BLK,
              tile_rows=TILE, gather_dtype="bfloat16")
    got = tops.mttkrp_device_step(*args, **kw)
    want = jops.mttkrp_device_step(
        jnp.asarray(idx), jnp.asarray(val), jnp.ones(len(val), bool),
        [jnp.asarray(f) for f in factors], interpret=True,
        backend="pallas_fused_gather", **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    with pytest.raises(ValueError, match="gather_dtype"):
        tops.mttkrp_device_step(*args, mode=0, rows_cap=rows_cap,
                                gather_dtype="float16")
    # The orderings are ported; an unknown one raises as in the reference.
    with pytest.raises(ValueError, match="unknown ordering"):
        tops.mttkrp_device_step(*args, mode=0, rows_cap=rows_cap,
                                ordering="hilbert")
    with pytest.raises(ValueError):
        tops.mttkrp_device_step(*args, mode=0, rows_cap=rows_cap,
                                backend="nope")


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_engines_match_jax(mode):
    t = random_sparse_tensor((15, 12, 9), 300, seed=8)
    rng = np.random.default_rng(9)
    factors = [rng.standard_normal((d, 6)).astype(np.float32)
               for d in t.shape]
    ti = torch.from_numpy(t.indices)
    tv = torch.from_numpy(t.values)
    tf = [torch.from_numpy(f) for f in factors]
    ji, jv = jnp.asarray(t.indices), jnp.asarray(t.values)
    jf = [jnp.asarray(f) for f in factors]
    np.testing.assert_allclose(
        tmt.hadamard_rows(ti, tv, tf, mode).numpy(),
        np.asarray(jmt.hadamard_rows(ji, jv, jf, mode)), rtol=1e-6)
    got = tmt.mttkrp(ti, tv, tf, mode, t.shape[mode])
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jmt.mttkrp(ji, jv, jf, mode, t.shape[mode])),
        rtol=RTOL, atol=ATOL)
    order = np.argsort(t.indices[:, mode], kind="stable")
    got_s = tmt.mttkrp_sorted(ti[order], tv[order], tf, mode, t.shape[mode])
    np.testing.assert_allclose(got_s.numpy(), got.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(
        got.numpy(), tmt.mttkrp_elementwise_ref(t.indices, t.values, factors,
                                                mode), rtol=1e-4, atol=1e-4)


def test_ref_oracles_match_jax():
    rng = np.random.default_rng(10)
    contrib = rng.standard_normal((40, 5)).astype(np.float32)
    rows = np.sort(rng.integers(0, 9, 40)).astype(np.int32)
    np.testing.assert_allclose(
        tref.segment_accumulate_ref(torch.from_numpy(contrib),
                                    torch.from_numpy(rows), 9).numpy(),
        np.asarray(jref.segment_accumulate_ref(jnp.asarray(contrib),
                                               jnp.asarray(rows), 9)),
        rtol=RTOL, atol=ATOL)
    vals = rng.standard_normal(40).astype(np.float32)
    blocks = [rng.standard_normal((40, 5)).astype(np.float32)
              for _ in range(3)]
    np.testing.assert_allclose(
        tref.fused_mttkrp_ref(torch.from_numpy(vals),
                              [torch.from_numpy(b) for b in blocks],
                              torch.from_numpy(rows), 9).numpy(),
        np.asarray(jref.fused_mttkrp_ref(jnp.asarray(vals),
                                         [jnp.asarray(b) for b in blocks],
                                         jnp.asarray(rows), 9)),
        rtol=RTOL, atol=ATOL)
