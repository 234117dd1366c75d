"""Port parity: FROSTT ``.tns`` I/O (``repro_torch.core.tensors.load_tns`` /
``save_tns``) against ``repro.core.tensors``.

``save_tns`` writes the reference's bytes for the same tensor; a file
written by either package loads in the port as the reference loads it
(indices, values and shape exactly); ``one_indexed=False`` round-trips.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import tensors as jten  # noqa: E402
from repro_torch.core import tensors as tten  # noqa: E402

CASES = {
    "uniform3": lambda m: m.random_sparse_tensor((30, 20, 10), 200, seed=0),
    "powerlaw3": lambda m: m.random_sparse_tensor(
        (400, 300, 50), 500, seed=1, distribution="powerlaw"),
    "zipf4": lambda m: m.zipf_4d((60, 40, 30, 8), 300, seed=2),
    "lowrank": lambda m: m.low_rank_sparse_tensor((20, 16, 12), 4, 400,
                                                  seed=3)[0],
}


def _equal(a, b):
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.values, b.values)
    assert a.values.dtype == b.values.dtype
    assert tuple(a.shape) == tuple(b.shape)


@pytest.mark.parametrize("one_indexed", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_save_tns_bytes_equal_reference(tmp_path, case, one_indexed):
    t = CASES[case](tten)
    tten.save_tns(t, str(tmp_path / "port.tns"), one_indexed=one_indexed)
    jten.save_tns(CASES[case](jten), str(tmp_path / "ref.tns"),
                  one_indexed=one_indexed)
    assert (tmp_path / "port.tns").read_bytes() \
        == (tmp_path / "ref.tns").read_bytes()


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_load_tns_equals_reference(tmp_path, case, writer):
    path = str(tmp_path / "t.tns")
    if writer == "port":
        tten.save_tns(CASES[case](tten), path)
    else:
        jten.save_tns(CASES[case](jten), path)
    _equal(tten.load_tns(path), jten.load_tns(path))


@pytest.mark.parametrize("case", sorted(CASES))
def test_zero_indexed_round_trip(tmp_path, case):
    t = CASES[case](tten)
    path = str(tmp_path / "t.tns")
    tten.save_tns(t, path, one_indexed=False)
    back = tten.load_tns(path, one_indexed=False)
    # The shape loads as the largest index + 1 per mode; the nonzeros
    # and their order are the tensor's own (it is canonical COO).
    np.testing.assert_array_equal(back.indices, t.indices)
    np.testing.assert_allclose(back.values, t.values, rtol=1e-7, atol=0)
    assert back.shape == tuple(int(m) + 1 for m in t.indices.max(axis=0))
    _equal(back, jten.load_tns(path, one_indexed=False))


def test_duplicate_coordinates_are_summed(tmp_path):
    path = tmp_path / "dup.tns"
    path.write_text("1 1 1 1.5\n2 3 1 2\n1 1 1 0.25\n")
    t = tten.load_tns(str(path))
    _equal(t, jten.load_tns(str(path)))
    assert t.nnz == 2 and float(t.values[0]) == 1.75
