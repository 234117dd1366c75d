"""The port's copy of the synthetic LM data pipeline
(``repro_torch.data``) against ``repro.data``: batches equal bit for bit
for several (seed, step, shard, num_shards), the iterator resumable at
``start_step``, and the labels the tokens shifted by one — with the
reference's own data tests mirrored on the port."""
import itertools

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import SyntheticLMData as JData  # noqa: E402
from repro.data import make_batch_iterator as j_iter  # noqa: E402
from repro_torch.data import SyntheticLMData, make_batch_iterator  # noqa: E402


def _equal(a, b):
    assert set(a) == set(b) == {"tokens", "labels", "loss_mask"}
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed,step,shard,num_shards", [
    (0, 0, 0, 1), (3, 5, 0, 1), (7, 123, 1, 2), (11, 2**20 + 3, 3, 4),
    (2**31 - 1, 9, 0, 8)])
def test_batches_equal_reference_bitwise(seed, step, shard, num_shards):
    for vocab, seq, gb in ((1000, 16, 8), (32064, 33, 16)):
        got = SyntheticLMData(vocab, seq, gb, seed=seed).batch(
            step, shard=shard, num_shards=num_shards)
        want = JData(vocab, seq, gb, seed=seed).batch(
            step, shard=shard, num_shards=num_shards)
        _equal(got, want)


@pytest.mark.parametrize("start_step,shard,num_shards", [
    (0, 0, 1), (5, 1, 2), (17, 0, 4)])
def test_iterator_resumes_as_reference(start_step, shard, num_shards):
    kw = dict(seed=3, start_step=start_step, shard=shard,
              num_shards=num_shards)
    got = list(itertools.islice(make_batch_iterator(1000, 16, 8, **kw), 3))
    want = list(itertools.islice(j_iter(1000, 16, 8, **kw), 3))
    for (gs, gb), (ws, wb) in zip(got, want):
        assert gs == ws
        _equal(gb, wb)
    assert [s for s, _ in got] == [start_step + i for i in range(3)]
    fresh = SyntheticLMData(1000, 16, 8, seed=3).batch(
        start_step, shard=shard, num_shards=num_shards)
    _equal(got[0][1], fresh)


def test_labels_shift_tokens():
    b = SyntheticLMData(1000, 16, 4, seed=0).batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert b["tokens"].dtype == b["labels"].dtype == np.int32
    assert (b["tokens"] >= 0).all() and (b["tokens"] < 1000).all()


def test_sharding_partitions_global_batch():
    src = SyntheticLMData(1000, 16, 8, seed=1)
    full = src.batch(2)
    sh0 = src.batch(2, shard=0, num_shards=2)
    sh1 = src.batch(2, shard=1, num_shards=2)
    np.testing.assert_array_equal(
        np.concatenate([sh0["tokens"], sh1["tokens"]]), full["tokens"])
