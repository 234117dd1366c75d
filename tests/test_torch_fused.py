"""Port parity: the fused kernels on pre-gathered rows (B3, B4) and the
blocked scatter (B5), and the mode steps that run them.

On a CPU tensor the port's wrappers run their plain PyTorch versions;
these are held against the JAX package's Pallas kernels in interpret
mode, at small sizes, at rtol 2e-5 (fp32 sums in another order). The
CUDA kernels are held against the same plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels.mttkrp import kernel as jk  # noqa: E402
from repro.kernels.mttkrp import ops as jops  # noqa: E402
from repro_torch.core import mttkrp as tmt  # noqa: E402
from repro_torch.core.tensors import random_sparse_tensor  # noqa: E402
from repro_torch.kernels.mttkrp import kernel as tk  # noqa: E402
from repro_torch.kernels.mttkrp import ops as tops  # noqa: E402

SHAPES = {1: (20, 16), 2: (20, 16, 12), 3: (12, 10, 8, 6)}
RTOL, ATOL = 2e-5, 1e-5
# (blk, tile_rows, rank)
GEOMETRIES = [(32, 8, 16), (64, 8, 40), (32, 4, 128)]


def _case(k, blk, tile_rows, rank, nnz=200, seed=0):
    """Mode-0 block-aligned stream (numpy) for K=k input modes: values,
    local rows, tile_of_block, the pre-gathered rows of each input factor
    (zero on padding, as the reference aligns them) and the rank."""
    shape = SHAPES[k]
    t = random_sparse_tensor(shape, nnz, seed=seed)
    order = np.argsort(t.indices[:, 0], kind="stable")
    idx = t.indices[order].astype(np.int32)
    val = t.values[order].astype(np.float32)
    rng = np.random.default_rng(seed + 1)
    factors = [rng.standard_normal((d, rank)).astype(np.float32)
               for d in shape]
    rows_cap = -(-shape[0] // tile_rows) * tile_rows
    valid = np.ones(len(val), bool)
    slot, tob = jops.build_block_layout(
        jnp.asarray(idx[:, 0]), jnp.asarray(valid), rows_cap=rows_cap,
        blk=blk, tile_rows=tile_rows)
    n_pad = jops.n_pad_for(len(val), rows_cap, blk, tile_rows)
    al = lambda x: np.array(jops._align_to_blocks(jnp.asarray(x), slot,
                                                    n_pad))
    pre = [al(factors[w][idx[:, w]]) for w in range(1, k + 1)]
    return dict(vals=al(val), rows=al(idx[:, 0] % tile_rows),
                tob=np.array(tob), pre=pre, rows_cap=rows_cap,
                blk=blk, tile_rows=tile_rows)


def _pad(x, multiple):
    return np.pad(x, ((0, 0), (0, (-x.shape[1]) % multiple)))


def _jax_fused(c, rank, tiled, out_init=None):
    kw = dict(rows_cap=c["rows_cap"], blk=c["blk"], tile_rows=c["tile_rows"],
              interpret=True)
    if out_init is not None:
        kw["out_init"] = jnp.asarray(_pad(out_init, 128))
    kern = jk.fused_mttkrp_nmode_tiled if tiled else jk.fused_mttkrp_nmode
    out = kern(jnp.asarray(c["vals"]),
               tuple(jnp.asarray(_pad(p, 128)) for p in c["pre"]),
               jnp.asarray(c["rows"]), jnp.asarray(c["tob"]), **kw)
    return np.asarray(out)[:, :rank]


def _port(c, rank):
    """The port's operands: rows padded to the port's rank multiple."""
    rpad = tops.padded_rank(rank)
    return (torch.from_numpy(c["vals"]),
            tuple(torch.from_numpy(_pad(p, rpad)) for p in c["pre"]),
            torch.from_numpy(c["rows"]), torch.from_numpy(c["tob"]))


def _kw(c):
    return dict(rows_cap=c["rows_cap"], blk=c["blk"],
                tile_rows=c["tile_rows"])


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("blk,tile_rows,rank", GEOMETRIES)
@pytest.mark.parametrize("with_init", [False, True])
def test_fused_plain_matches_jax_kernel(k, blk, tile_rows, rank, with_init):
    c = _case(k, blk, tile_rows, rank, seed=k + blk + rank)
    init = None
    if with_init:
        init = np.random.default_rng(rank).standard_normal(
            (c["rows_cap"], rank)).astype(np.float32)
    args = _port(c, rank)
    rpad = tops.padded_rank(rank)
    init_t = None if init is None else torch.from_numpy(_pad(init, rpad))
    keep = None if init_t is None else init_t.clone()
    b3 = tk.fused_mttkrp_nmode(*args, out_init=init_t, **_kw(c))
    b3_plain = tk.fused_mttkrp_nmode_plain(*args, out_init=init_t, **_kw(c))
    b4 = tk.fused_mttkrp_nmode_tiled(*args, rank_slab=tk.RANK_MULTIPLE,
                                     out_init=init_t, **_kw(c))
    b4_plain = tk.fused_mttkrp_nmode_tiled_plain(
        *args, rank_slab=tk.RANK_MULTIPLE, out_init=init_t, **_kw(c))
    want3 = _jax_fused(c, rank, tiled=False, out_init=init)
    want4 = _jax_fused(c, rank, tiled=True, out_init=init)
    for got, want in ((b3, want3), (b3_plain, want3), (b4, want4),
                      (b4_plain, want4)):
        assert got.shape == (c["rows_cap"], rpad)
        np.testing.assert_allclose(got[:, :rank].numpy(), want, rtol=RTOL,
                                   atol=ATOL)
    # Same columns, same arithmetic: B3 == B4 bitwise, as on the card.
    assert torch.equal(b3, b4)
    if keep is not None:
        assert torch.equal(init_t, keep), "out_init was modified"


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("blk,tile_rows,rank", GEOMETRIES)
def test_segment_accumulate_plain_matches_jax_kernel(k, blk, tile_rows,
                                                     rank):
    c = _case(k, blk, tile_rows, rank, seed=10 + k + blk + rank)
    contrib = c["vals"][:, None]
    for p in c["pre"]:
        contrib = contrib * p
    want = np.asarray(jk.segment_accumulate(
        jnp.asarray(_pad(contrib, 128)), jnp.asarray(c["rows"]),
        jnp.asarray(c["tob"]), interpret=True, **_kw(c)))[:, :rank]
    rpad = tops.padded_rank(rank)
    args = (torch.from_numpy(_pad(contrib, rpad)),
            torch.from_numpy(c["rows"]), torch.from_numpy(c["tob"]))
    got = tk.segment_accumulate(*args, **_kw(c))
    plain = tk.segment_accumulate_plain(*args, **_kw(c))
    for out in (got, plain):
        assert out.shape == (c["rows_cap"], rpad)
        np.testing.assert_allclose(out[:, :rank].numpy(), want, rtol=RTOL,
                                   atol=ATOL)
    # B5 on B3's products is B3 (the same products, the same adds).
    b3 = tk.fused_mttkrp_nmode(*_port(c, rank), **_kw(c))
    np.testing.assert_allclose(got.numpy(), b3.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("rank,slab", [(16, 16), (48, 48), (144, 48),
                                       (1024, 128)])
def test_segment_slab(rank, slab):
    """B5 splits any padded rank into slabs of at most RANK_SLAB columns,
    and its shared memory stays under the card's limit."""
    assert tk.segment_slab(rank) == slab
    assert tk.segment_smem_bytes(rank, 8) <= tk.SMEM_LIMIT_BYTES


def test_smem_byte_counts():
    """The launch checks and the planner read these counts; they follow
    the kernels' layouts (csrc/*.cu)."""
    g = tk._groups(8)
    assert tk.gather_smem_bytes(2, 16, 8) == 4 * (g * 8 * 16 + 2048 * 4)
    assert tk.gather_smem_bytes(3, 256, 8, rank_slab=128) \
        == tk.gather_smem_bytes(3, 128, 8)
    # B3/B4: partials, a ring of K rows per slot (one 16-slot stage by
    # default: the ladder's question), the meta ring, headers, mbarriers.
    meta, hdr, bars = 4 * 1024 * 8, (1 + 4) * 8 * 4, 8 * 2 * (1 + 4)
    # Each partial tile padded to an odd multiple of 16 floats (128 -> 144).
    assert tk.fused_smem_bytes(2, 16, 8) \
        == 4 * g * 144 + 2 * 16 * 16 * 4 + meta + hdr + bars
    assert tk.fused_smem_bytes(2, 16, 8, gather_itemsize=2) \
        == 4 * g * 144 + 2 * 16 * 16 * 2 + meta + hdr + bars
    assert tk.fused_smem_bytes(3, 1024, 8, rank_slab=128) \
        == tk.fused_smem_bytes(3, 128, 8)
    assert tk.fused_smem_bytes(2, 304, 8) <= tk.SMEM_LIMIT_BYTES \
        < tk.fused_smem_bytes(2, 320, 8)
    assert tk.segment_smem_bytes(16, 8) == 4 * (g * 8 * 16 + 512 * 16
                                                + 512)


def test_fused_wrappers_reject_bad_operands():
    c = _case(2, 32, 8, 16, seed=3)
    vals, pre, rows, tob = _port(c, 16)
    kw = _kw(c)
    with pytest.raises(ValueError):
        tk.fused_mttkrp_nmode(vals.double(), pre, rows, tob, **kw)
    with pytest.raises(ValueError):           # ranks differ
        tk.fused_mttkrp_nmode(vals, (pre[0], pre[1][:, :8]), rows, tob,
                              **kw)
    with pytest.raises(ValueError):           # rank 16 not a multiple of 32
        tk.fused_mttkrp_nmode_tiled(vals, pre, rows, tob, rank_slab=32,
                                    **kw)
    with pytest.raises(ValueError):           # rows_cap not a tile multiple
        tk.fused_mttkrp_nmode(vals, pre, rows, tob, rows_cap=kw["rows_cap"]
                              + 1, blk=32, tile_rows=8)
    with pytest.raises(ValueError):           # rank not padded to 16
        tk.segment_accumulate(pre[0][:, :8].contiguous(), rows, tob, **kw)
    with pytest.raises(ValueError):           # out_init of another shape
        tk.fused_mttkrp_nmode(vals, pre, rows, tob,
                              out_init=torch.zeros(3, 16), **kw)


def test_cpu_tensors_never_count_launches():
    c = _case(2, 32, 8, 16, seed=2)
    args = _port(c, 16)
    before = (tk.fused_mttkrp_nmode.launches,
              tk.fused_mttkrp_nmode_tiled.launches,
              tk.segment_accumulate.launches)
    tk.fused_mttkrp_nmode(*args, **_kw(c))
    tk.fused_mttkrp_nmode_tiled(*args, rank_slab=16, **_kw(c))
    tk.segment_accumulate(args[1][0], args[2], args[3], **_kw(c))
    assert (tk.fused_mttkrp_nmode.launches,
            tk.fused_mttkrp_nmode_tiled.launches,
            tk.segment_accumulate.launches) == before


def _step_case(nmodes, rank, seed):
    shape = {3: (20, 16, 12), 4: (12, 10, 8, 6)}[nmodes]
    t = random_sparse_tensor(shape, 150, seed=seed)
    order = np.argsort(t.indices[:, 0], kind="stable")
    idx = t.indices[order].astype(np.int32)
    val = t.values[order].astype(np.float32)
    rng = np.random.default_rng(seed + 1)
    factors = [rng.standard_normal((d, rank)).astype(np.float32)
               for d in shape]
    valid = np.ones(len(val), bool)
    valid[-7:] = False                       # trailing invalid elements
    return idx, val, valid, factors, -(-shape[0] // 8) * 8


@pytest.mark.parametrize("nmodes", [3, 4])
@pytest.mark.parametrize("backend,ordering", [
    ("pallas", "none"), ("pallas_fused", "none"),
    ("pallas_fused", "morton"), ("pallas_fused_tiled", "none"),
    ("pallas_fused_tiled", "morton")])
def test_device_step_matches_jax(nmodes, backend, ordering):
    rank = 8
    idx, val, valid, factors, rows_cap = _step_case(nmodes, rank, seed=30)
    kw = dict(mode=0, rows_cap=rows_cap, row_offset=0, blk=32, tile_rows=8,
              backend=backend, ordering=ordering)
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


def test_blocked_operands_cut_only_padding():
    """B5's operands end at the last tile's run; what is cut held only
    padding, so the scatter equals the reference's over the whole
    stream."""
    rank = 16
    idx, val, valid, factors, rows_cap = _step_case(3, rank, seed=31)
    ti = torch.from_numpy(idx)
    ell = tmt.hadamard_rows(ti, torch.from_numpy(val),
                            [torch.from_numpy(f) for f in factors], 0)
    tvalid = torch.from_numpy(valid)
    contrib, rows, tob = tops.blocked_operands(
        ell, ti[:, 0], tvalid, rows_cap=rows_cap, blk=32, tile_rows=8)
    n_pad = tops.n_pad_for(len(val), rows_cap, 32, 8)
    assert contrib.shape[0] % 32 == 0 and contrib.shape[0] < n_pad
    assert tob.shape == (contrib.shape[0] // 32,)
    got = tops.mttkrp_blocked(ell, ti[:, 0], tvalid, rows_cap=rows_cap,
                              blk=32, tile_rows=8)
    want = jops.mttkrp_blocked(
        jnp.asarray(ell.numpy()), jnp.asarray(idx[:, 0]), jnp.asarray(valid),
        rows_cap=rows_cap, blk=32, tile_rows=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    ref = tops.mttkrp_blocked(ell, ti[:, 0], tvalid, rows_cap=rows_cap,
                              blk=32, tile_rows=8, use_ref=True)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL,
                               atol=ATOL)
