"""Port parity: host preprocessing (generators, schedules, FLYCOO, pack_mode).

Every integer and host-side result of ``repro_torch.core`` must equal the
JAX package's exactly, for any worker count.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import flycoo as jfly  # noqa: E402
from repro.core import schedule as jsch  # noqa: E402
from repro.core import tensors as jten  # noqa: E402
from repro_torch.core import flycoo as tfly  # noqa: E402
from repro_torch.core import schedule as tsch  # noqa: E402
from repro_torch.core import tensors as tten  # noqa: E402

GENERATORS = {
    "uniform": lambda m: m.random_sparse_tensor((30, 20, 10), 600, seed=3),
    "powerlaw": lambda m: m.random_sparse_tensor(
        (40, 30, 20), 800, seed=4, distribution="powerlaw"),
    "zipf_4d": lambda m: m.zipf_4d((12, 10, 8, 6), 500, seed=5),
    "low_rank": lambda m: m.low_rank_sparse_tensor((20, 15, 10), 3, 700,
                                                   seed=6)[0],
    "enron": lambda m: m.frostt_like("enron", scale=0.05, seed=7),
}

# Small intervals and shards, so partitions have many super-shards.
FLYCOO_KW = dict(m_bounds=(2, 8), g_bounds=(8, 64), cache_bytes=1 << 20)


def _assert_tensor_equal(a, b):
    assert a.shape == b.shape
    assert a.indices.dtype == b.indices.dtype
    assert a.values.dtype == b.values.dtype
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.values, b.values)


@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_generators_bit_equal(gen):
    _assert_tensor_equal(GENERATORS[gen](tten), GENERATORS[gen](jten))


def test_low_rank_truth_factors_equal():
    tt, tf = tten.low_rank_sparse_tensor((9, 8, 7), 2, 100, seed=1,
                                         noise=0.1)
    jt, jf = jten.low_rank_sparse_tensor((9, 8, 7), 2, 100, seed=1,
                                         noise=0.1)
    _assert_tensor_equal(tt, jt)
    for a, b in zip(tf, jf):
        np.testing.assert_array_equal(a, b)


def test_frostt_profiles_equal():
    assert tten.FROSTT_PROFILES == jten.FROSTT_PROFILES


@pytest.mark.parametrize("gen", sorted(GENERATORS))
@pytest.mark.parametrize("workers", [1, 2, 4])
def test_flycoo_and_pack_mode_equal(gen, workers):
    t = GENERATORS[gen](tten)
    ft = tfly.build_flycoo(t, workers, **FLYCOO_KW)
    fj = jfly.build_flycoo(GENERATORS[gen](jten), workers, **FLYCOO_KW)
    assert dataclasses.asdict(ft.params) == dataclasses.asdict(fj.params)
    assert ft.ordering == fj.ordering == "none"
    for mt, mj in zip(ft.modes, fj.modes):
        for field in dataclasses.fields(mt):
            a, b = getattr(mt, field.name), getattr(mj, field.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, field.name
                np.testing.assert_array_equal(a, b, err_msg=field.name)
            else:
                assert a == b, field.name
    np.testing.assert_array_equal(ft.perm_indices, fj.perm_indices)
    assert ft.perm_indices.dtype == fj.perm_indices.dtype
    assert ft.nnz_cap == fj.nnz_cap
    for mode in range(t.nmodes):
        np.testing.assert_array_equal(ft.owner_of(mode), fj.owner_of(mode))
        for a, b in zip(tfly.pack_mode(ft, mode), jfly.pack_mode(fj, mode)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert ft.bits_per_nonzero() == fj.bits_per_nonzero()


@pytest.mark.parametrize("shape,nnz,workers,fused", [
    ((12_100, 9_200, 28_800), 76_900_000, 1, False),
    ((2_900, 2_100, 25_500), 143_600, 4, True),
    ((6_066, 5_699, 244_268, 1_176), 54_202_099, 8, False),
    ((3, 2, 50), 40, 4, True),
])
def test_choose_partition_params_equal(shape, nnz, workers, fused):
    a = tfly.choose_partition_params(shape, nnz, workers, fused_gather=fused)
    b = jfly.choose_partition_params(shape, nnz, workers, fused_gather=fused)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_schedules_equal():
    rng = np.random.default_rng(0)
    sizes = rng.integers(1, 50, 37)
    for bins in (1, 3, 8):
        a = tsch.lpt_schedule(sizes, bins)
        b = jsch.lpt_schedule(sizes, bins)
        np.testing.assert_array_equal(a, b)
        assert tsch.makespan(sizes, a, bins) == jsch.makespan(sizes, b, bins)
        assert tsch.load_imbalance(sizes, a, bins) \
            == jsch.load_imbalance(sizes, b, bins)
        np.testing.assert_array_equal(
            tsch.block_cyclic_schedule(37, bins, 2),
            jsch.block_cyclic_schedule(37, bins, 2))


def test_cyclic_schedule_flycoo_equal():
    t = GENERATORS["powerlaw"](tten)
    ft = tfly.build_flycoo(t, 2, schedule="cyclic", **FLYCOO_KW)
    fj = jfly.build_flycoo(GENERATORS["powerlaw"](jten), 2,
                           schedule="cyclic", **FLYCOO_KW)
    np.testing.assert_array_equal(ft.perm_indices, fj.perm_indices)


def test_orderings_other_than_none_raise():
    t = GENERATORS["uniform"](tten)
    with pytest.raises(NotImplementedError, match="A7"):
        tfly.build_flycoo(t, 1, ordering="tile")


@pytest.mark.parametrize("bad", ["negative", "too_large", "nan"])
def test_validation_rejects_like_reference(bad):
    idx = np.array([[0, 1], [2, 3]], np.int32)
    vals = np.array([1.0, 2.0], np.float32)
    if bad == "negative":
        idx[1, 0] = -1
    elif bad == "too_large":
        idx[1, 1] = 9
    else:
        vals[0] = np.nan
    for mod, fly in ((tten, tfly), (jten, jfly)):
        t = mod.SparseTensor(idx.copy(), vals.copy(), (4, 5))
        with pytest.raises(ValueError):
            fly.build_flycoo(t, 1)
