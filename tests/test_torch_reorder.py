"""Port parity: locality reordering (``repro_torch.reorder``) and the
ordering paths of FLYCOO and the block layout.

Every key, permutation and layout must equal the JAX package's exactly,
given the same inputs and the same ``frow_tile`` (the tests pass the
reference's 128; the port's own default is 8). Inputs come from seeded
numpy generators: no unseeded draws.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import flycoo as jfly  # noqa: E402
from repro.core import tensors as jten  # noqa: E402
from repro.kernels.mttkrp import ops as jops  # noqa: E402
from repro.reorder import ordering as jo  # noqa: E402
from repro_torch.core import flycoo as tfly  # noqa: E402
from repro_torch.core import tensors as tten  # noqa: E402
from repro_torch.kernels.mttkrp import ops as tops  # noqa: E402
from repro_torch.reorder import ordering as to  # noqa: E402

JAX_FROW = 128
ORDERINGS = ("none", "tile", "morton")
BLK, TILE = 32, 8


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _equal(jax_out, port_out):
    np.testing.assert_array_equal(np.asarray(port_out), np.asarray(jax_out))


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("max_tiles", [None, 3000, 200_000])
def test_morton_key_words_equal(seed, k, max_tiles):
    rng = np.random.default_rng(seed)
    top = (1 << 16) if max_tiles is None else max_tiles
    tiles = rng.integers(0, top, (300, k))
    want = jo.morton_key_words(tiles, max_tiles=max_tiles)
    got = to.morton_key_words(_t(tiles), max_tiles=max_tiles)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        _equal(a, b)
        assert int(b.max()) < (1 << 30)


def test_morton_overflow_raises_like_reference():
    tiles = np.array([[1 << 16, 0]])
    with pytest.raises(ValueError):
        jo.morton_key_words(tiles)
    with pytest.raises(ValueError, match="Morton budget"):
        to.morton_key_words(_t(tiles))


@pytest.mark.parametrize("max_tiles", [0, 1, 2, 65536, 65537, 1 << 20])
@pytest.mark.parametrize("bits", [4, 16])
def test_morton_bits_for_equal(max_tiles, bits):
    assert to.morton_bits_for(max_tiles, bits) \
        == jo.morton_bits_for(max_tiles, bits)


@pytest.mark.parametrize("ordering", ORDERINGS)
@pytest.mark.parametrize("frow_tile", [8, JAX_FROW])
@pytest.mark.parametrize("max_rows", [None, 50_000])
def test_locality_keys_equal(ordering, frow_tile, max_rows):
    rng = np.random.default_rng(7)
    idx_in = rng.integers(0, 50_000, (400, 3))
    want = jo.locality_keys(idx_in, ordering, frow_tile=frow_tile,
                            max_rows=max_rows)
    got = to.locality_keys(_t(idx_in), ordering, frow_tile=frow_tile,
                           max_rows=max_rows)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        _equal(a, b)


def test_validate_ordering():
    for o in ORDERINGS:
        assert to.validate_ordering(o) == jo.validate_ordering(o)
    assert to.ORDERINGS == jo.ORDERINGS
    with pytest.raises(ValueError):
        to.validate_ordering("hilbert")


# ---------------------------------------------------------------------------
# Sorts and permutations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lexsort_equals_numpy(seed):
    rng = np.random.default_rng(seed)
    keys = [rng.integers(0, hi, 500) for hi in (3, 7, 50)]
    want = np.lexsort((np.arange(500),) + tuple(reversed(keys)))
    _equal(want, to.lexsort(tuple(_t(k) for k in keys)))


@pytest.mark.parametrize("ordering", ORDERINGS)
@pytest.mark.parametrize("seed", [0, 1])
def test_locality_lexsort_equal(ordering, seed):
    rng = np.random.default_rng(seed)
    idx_in = rng.integers(0, 900, (600, 2))
    prim = (rng.integers(0, 4, 600), rng.integers(0, 30, 600))
    want = jo.locality_lexsort(idx_in, ordering, primaries=prim,
                               max_rows=900)
    got = to.locality_lexsort(_t(idx_in), ordering,
                              primaries=tuple(_t(p) for p in prim),
                              frow_tile=JAX_FROW, max_rows=900)
    _equal(want, got)


def _sorted_stream(shape, nnz, mode, seed, invalid_tail=5):
    t = jten.random_sparse_tensor(shape, nnz, seed=seed,
                                  distribution="powerlaw")
    order = np.argsort(t.indices[:, mode], kind="stable")
    idx = t.indices[order].astype(np.int32)
    val = t.values[order].astype(np.float32)
    valid = np.arange(len(val)) < len(val) - invalid_tail
    return idx, np.where(valid, val, 0.0).astype(np.float32), valid


@pytest.mark.parametrize("ordering", ORDERINGS)
@pytest.mark.parametrize("shape,mode", [((40, 300, 170), 0),
                                        ((300, 40, 170), 1),
                                        ((12, 300, 170, 6), 2)])
def test_reorder_stream_equal(ordering, shape, mode):
    idx, val, valid = _sorted_stream(shape, 400, mode, seed=len(shape) + mode)
    want = jo.reorder_stream(idx, val, valid, mode=mode, ordering=ordering,
                             tile_rows=TILE)
    got = to.reorder_stream(_t(idx), _t(val), _t(valid), mode=mode,
                            ordering=ordering, tile_rows=TILE,
                            frow_tile=JAX_FROW)
    for a, b in zip(want, got):
        _equal(a, b)
    # A true permutation that keeps valid-first and tile runs ascending.
    perm = got[3].numpy()
    assert np.array_equal(np.sort(perm), np.arange(len(val)))
    nv = int(valid.sum())
    assert got[2][:nv].all() and not got[2][nv:].any()
    assert np.all(np.diff(got[0][:nv, mode].numpy() // TILE) >= 0)


# ---------------------------------------------------------------------------
# The ordering paths of the block layout and of FLYCOO
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ordering", ORDERINGS)
@pytest.mark.parametrize("seed", [0, 1])
def test_build_block_layout_order_keys_equal(ordering, seed):
    idx, _, valid = _sorted_stream((40, 300, 170), 300, 0, seed=seed)
    idx_in = np.where(valid[:, None], idx[:, 1:], 0).astype(np.int32)
    kw = dict(rows_cap=40, blk=BLK, tile_rows=TILE)
    want = jops.build_block_layout(
        jnp.asarray(idx[:, 0]), jnp.asarray(valid),
        order_keys=jo.locality_keys(jnp.asarray(idx_in), ordering,
                                    max_rows=300), **kw)
    got = tops.build_block_layout(
        _t(idx[:, 0]), _t(valid),
        order_keys=to.locality_keys(_t(idx_in), ordering,
                                    frow_tile=JAX_FROW, max_rows=300), **kw)
    for a, b in zip(want, got):
        _equal(a, b)


def test_order_keys_layout_equals_host_permutation():
    """Ranking in the layout == permuting the stream first (port only)."""
    idx, _, valid = _sorted_stream((40, 300, 170), 300, 0, seed=4)
    idx_in = _t(np.where(valid[:, None], idx[:, 1:], 0))
    kw = dict(rows_cap=40, blk=BLK, tile_rows=TILE)
    slot, tob = tops.build_block_layout(
        _t(idx[:, 0]), _t(valid), order_keys=to.locality_keys(
            idx_in, "morton", max_rows=300), **kw)
    pidx, _, pvalid, perm = to.reorder_stream(
        _t(idx), _t(np.zeros(len(idx), np.float32)), _t(valid), mode=0,
        ordering="morton", tile_rows=TILE, max_rows=300)
    pslot, ptob = tops.build_block_layout(pidx[:, 0], pvalid, **kw)
    assert torch.equal(slot[perm], pslot) and torch.equal(tob, ptob)


FLYCOO_KW = dict(m_bounds=(2, 8), g_bounds=(8, 64), cache_bytes=1 << 20)


@pytest.mark.parametrize("ordering", ["tile", "morton"])
@pytest.mark.parametrize("workers", [1, 2, 4])
def test_build_flycoo_and_pack_mode_ordering_equal(ordering, workers):
    t = tten.random_sparse_tensor((40, 300, 170), 700, seed=workers)
    tj = jten.random_sparse_tensor((40, 300, 170), 700, seed=workers)
    ft = tfly.build_flycoo(t, workers, ordering=ordering, **FLYCOO_KW)
    fj = jfly.build_flycoo(tj, workers, ordering=ordering, **FLYCOO_KW)
    assert ft.ordering == fj.ordering == ordering
    np.testing.assert_array_equal(ft.perm_indices, fj.perm_indices)
    for mode in range(3):
        got = tfly.pack_mode(ft, mode, frow_tile=JAX_FROW)
        want = jfly.pack_mode(fj, mode)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_pack_mode_ordering_keeps_rows_sorted_at_port_geometry():
    t = tten.random_sparse_tensor((40, 300, 170), 700, seed=9)
    ft = tfly.build_flycoo(t, 2, ordering="morton", **FLYCOO_KW)
    plain = tfly.build_flycoo(t, 2, **FLYCOO_KW)
    for mode in range(3):
        idx, val, mask = tfly.pack_mode(ft, mode)
        pidx, pval, pmask = tfly.pack_mode(plain, mode)
        np.testing.assert_array_equal(mask, pmask)
        for d in range(2):
            rows = idx[d, mask[d], mode]
            assert np.all(np.diff(rows) >= 0)
            # The same nonzeros per worker, in another order within rows.
            np.testing.assert_array_equal(
                np.sort(val[d, mask[d]]), np.sort(pval[d, pmask[d]]))


def test_build_flycoo_rejects_unknown_ordering():
    t = tten.random_sparse_tensor((10, 8, 6), 50, seed=0)
    with pytest.raises(ValueError):
        tfly.build_flycoo(t, 1, ordering="hilbert")
