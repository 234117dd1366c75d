"""Deterministic, shardable synthetic LM data pipeline.

A copy of ``repro/data/pipeline.py`` (numpy only): the port's batches are
the reference's, bit for bit.

Production posture without a corpus dependency: every (step, shard) cell of
the token stream is a pure function of ``(seed, step, global_example_id)``
via a counter-based hash (splitmix64), so:

* any host can generate exactly its shard — no data server, no files;
* restart/resume replays the exact stream from the checkpointed step
  (fault-tolerance requirement: step replay is bit-exact);
* elastic re-sharding (different host count after restart) still yields the
  same global batch order.

Tokens follow a Zipf-like marginal with a deterministic n-gram-ish
structure (next token depends on previous via a mixing hash) so models have
learnable signal — the quickstart example's loss visibly drops.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticLMData", "make_batch_iterator"]


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@dataclasses.dataclass(frozen=True)
class SyntheticLMData:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.2

    def _tokens(self, step: int, example_ids: np.ndarray) -> np.ndarray:
        """(len(example_ids), seq_len+1) int32 token stream."""
        n = len(example_ids)
        base = (np.uint64(self.seed) * np.uint64(0x100000001B3)
                + np.uint64(step) * np.uint64(0x1000193))
        pos = np.arange(self.seq_len + 1, dtype=np.uint64)[None, :]
        eid = example_ids.astype(np.uint64)[:, None]
        h = _splitmix64(base + eid * np.uint64(1 << 20) + pos)
        u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        # Zipf-ish marginal via inverse CDF u^(1/(alpha-1)) flavor
        ranks = np.minimum(
            (self.vocab * u ** self.zipf_alpha).astype(np.int64),
            self.vocab - 1)
        # inject structure: token_t also depends on token_{t-1} bucket
        prev = np.roll(ranks, 1, axis=1)
        prev[:, 0] = 0
        mixed = (ranks + (prev % 17) * 31) % self.vocab
        return mixed.astype(np.int32)

    def batch(self, step: int, *, shard: int = 0, num_shards: int = 1):
        """Host-sharded batch: dict(tokens, labels, loss_mask)."""
        per = self.global_batch // num_shards
        ids = np.arange(per, dtype=np.int64) + shard * per \
            + np.int64(step) * self.global_batch
        stream = self._tokens(step, ids)
        return {
            "tokens": stream[:, :-1],
            "labels": stream[:, 1:].astype(np.int32),
            "loss_mask": np.ones((per, self.seq_len), np.float32),
        }


def make_batch_iterator(vocab: int, seq_len: int, global_batch: int, *,
                        seed: int = 0, start_step: int = 0,
                        shard: int = 0, num_shards: int = 1):
    """Infinite deterministic iterator, resumable at ``start_step``."""
    src = SyntheticLMData(vocab, seq_len, global_batch, seed=seed)
    step = start_step
    while True:
        yield step, src.batch(step, shard=shard, num_shards=num_shards)
        step += 1
