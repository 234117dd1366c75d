"""Port parity: block layout (n_pad_for, build_block_layout, alignment).

The slots and ``tile_of_block`` the port computes must equal the JAX
package's exactly for the same geometry.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels.mttkrp import ops as jops  # noqa: E402
from repro_torch.kernels.mttkrp import ops as tops  # noqa: E402

# (cap, valid count, rows_cap, blk, tile_rows)
CASES = [
    (200, 200, 64, 32, 8),
    (500, 430, 128, 32, 8),
    (37, 20, 16, 8, 4),
    (64, 0, 32, 32, 8),        # all invalid
    (300, 300, 8, 32, 8),      # one tile
    (129, 100, 256, 16, 16),   # many empty tiles
]


def _stream(cap, n_valid, rows_cap, seed):
    rng = np.random.default_rng(seed)
    local_row = np.zeros(cap, np.int32)
    local_row[:n_valid] = np.sort(rng.integers(0, rows_cap, n_valid))
    valid = np.arange(cap) < n_valid
    return local_row, valid


@pytest.mark.parametrize("case", CASES)
def test_n_pad_for_equal(case):
    cap, _, rows_cap, blk, tile_rows = case
    assert tops.n_pad_for(cap, rows_cap, blk, tile_rows) \
        == jops.n_pad_for(cap, rows_cap, blk, tile_rows)


@pytest.mark.parametrize("case", CASES)
def test_build_block_layout_equal(case):
    cap, n_valid, rows_cap, blk, tile_rows = case
    local_row, valid = _stream(cap, n_valid, rows_cap, seed=cap)
    kw = dict(rows_cap=rows_cap, blk=blk, tile_rows=tile_rows)
    slot_t, tob_t = tops.build_block_layout(
        torch.from_numpy(local_row), torch.from_numpy(valid), **kw)
    slot_j, tob_j = jops.build_block_layout(
        jnp.asarray(local_row), jnp.asarray(valid), **kw)
    assert slot_t.dtype == torch.int32 and tob_t.dtype == torch.int32
    np.testing.assert_array_equal(slot_t.numpy(), np.asarray(slot_j))
    np.testing.assert_array_equal(tob_t.numpy(), np.asarray(tob_j))
    # Invariants the kernels rely on.
    n_pad = tops.n_pad_for(cap, rows_cap, blk, tile_rows)
    s = slot_t.numpy()[valid]
    assert len(np.unique(s)) == len(s) and (s < n_pad).all()
    tob = tob_t.numpy()
    assert (np.diff(tob) >= 0).all()
    assert (tob[s // blk] == local_row[valid] // tile_rows).all()


@pytest.mark.parametrize("case", CASES[:3])
def test_align_to_blocks_equal(case):
    cap, n_valid, rows_cap, blk, tile_rows = case
    local_row, valid = _stream(cap, n_valid, rows_cap, seed=1)
    kw = dict(rows_cap=rows_cap, blk=blk, tile_rows=tile_rows)
    slot_j, _ = jops.build_block_layout(jnp.asarray(local_row),
                                        jnp.asarray(valid), **kw)
    slot_t = torch.from_numpy(np.array(slot_j))
    n_pad = tops.n_pad_for(cap, rows_cap, blk, tile_rows)
    rng = np.random.default_rng(2)
    for x in (rng.standard_normal(cap).astype(np.float32),
              rng.integers(0, 99, (cap, 3)).astype(np.int32)):
        got = tops._align_to_blocks(torch.from_numpy(x), slot_t, n_pad)
        want = jops._align_to_blocks(jnp.asarray(x), slot_j, n_pad)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_operands_match_reference_alignment():
    """The operands the port hands its kernels are the reference's
    block-aligned streams (ops.mttkrp_device_step's gather path)."""
    rng = np.random.default_rng(3)
    cap, rows_cap, blk, tile_rows = 90, 24, 16, 8
    idx = np.stack([np.sort(rng.integers(0, rows_cap, cap)),
                    rng.integers(0, 11, cap), rng.integers(0, 7, cap)],
                   1).astype(np.int32)
    val = rng.standard_normal(cap).astype(np.float32)
    valid = np.arange(cap) < 80
    factors = [torch.zeros(rows_cap, 5), torch.ones(11, 5), torch.ones(7, 5)]
    v, ix, fm, lr, tob = tops.gather_operands(
        torch.from_numpy(idx), torch.from_numpy(val),
        torch.from_numpy(valid), factors, mode=0, rows_cap=rows_cap,
        row_offset=0, blk=blk, tile_rows=tile_rows, slab=16)
    slot, tob_j = jops.build_block_layout(
        jnp.asarray(idx[:, 0]) * jnp.asarray(valid), jnp.asarray(valid),
        rows_cap=rows_cap, blk=blk, tile_rows=tile_rows)
    n_pad = tops.n_pad_for(cap, rows_cap, blk, tile_rows)
    np.testing.assert_array_equal(tob.numpy(), np.asarray(tob_j))
    np.testing.assert_array_equal(
        v.numpy(), np.asarray(jops._align_to_blocks(
            jnp.where(jnp.asarray(valid), jnp.asarray(val), 0.0), slot,
            n_pad)))
    np.testing.assert_array_equal(
        ix.numpy(), np.asarray(jops._align_to_blocks(
            jnp.where(jnp.asarray(valid)[:, None], jnp.asarray(idx[:, 1:]),
                      0), slot, n_pad)))
    np.testing.assert_array_equal(
        lr.numpy(), np.asarray(jops._align_to_blocks(
            jnp.where(jnp.asarray(valid), jnp.asarray(idx[:, 0]), 0)
            % tile_rows, slot, n_pad)))
    assert [f.shape for f in fm] == [(11, 16), (7, 16)]


def test_pad_rank_and_slabs():
    x = torch.ones(3, 8)
    assert tops.pad_rank(x).shape == (3, 16)
    assert tops.pad_rank(torch.ones(3, 32)).shape == (3, 32)
    assert tops.pad_rank(x, 128).shape == (3, 128)
    assert torch.equal(tops.pad_rank(x)[:, 8:], torch.zeros(3, 8))
    assert [tops.padded_rank(r) for r in (1, 8, 16, 17, 256)] \
        == [16, 16, 16, 32, 256]
    assert [tops.tiled_rank_slab(r) for r in (8, 16, 100, 128, 256, 300)] \
        == [16, 16, 112, 128, 128, 128]
