"""Super-shard scheduling (paper Alg. 3) and baselines.

The port's own copy of ``repro/core/schedule.py`` (numpy only).

The paper assigns super-shards to CPU threads with an LPT greedy rule
(sort descending by shard count, assign to least-loaded bin), which gives
Graham's ``max_load <= 4/3 * OPT`` guarantee. We use the identical algorithm
to balance super-shards across mesh devices (and Pallas grid blocks), and
ship the block-cyclic distribution the paper compares against (Fig. 6).
"""
from __future__ import annotations

import heapq

import numpy as np

__all__ = [
    "lpt_schedule",
    "block_cyclic_schedule",
    "makespan",
    "load_imbalance",
]


def lpt_schedule(sizes: np.ndarray, num_bins: int) -> np.ndarray:
    """Longest-Processing-Time greedy (paper Alg. 3).

    Args:
      sizes: per-super-shard work (shard / nnz counts), shape ``(S,)``.
      num_bins: number of workers (threads on CPU, devices on TPU).

    Returns:
      ``assign[(S,)]`` — bin id per super-shard. Guarantees
      ``makespan(assign) <= 4/3 * OPT`` (Graham 1969).
    """
    sizes = np.asarray(sizes)
    order = np.argsort(-sizes, kind="stable")  # descending, stable => deterministic
    assign = np.empty(len(sizes), dtype=np.int32)
    # (load, bin) heap; bin index tiebreak keeps determinism.
    heap = [(0, b) for b in range(num_bins)]
    heapq.heapify(heap)
    for s in order:
        load, b = heapq.heappop(heap)
        assign[s] = b
        heapq.heappush(heap, (load + int(sizes[s]), b))
    return assign


def block_cyclic_schedule(num_items: int, num_bins: int, block: int = 1) -> np.ndarray:
    """Block-cyclic distribution (state-of-the-art baseline, paper §V-D)."""
    item = np.arange(num_items)
    return ((item // block) % num_bins).astype(np.int32)


def makespan(sizes: np.ndarray, assign: np.ndarray, num_bins: int) -> int:
    """Largest per-bin load under ``assign``."""
    return int(np.bincount(assign, weights=sizes, minlength=num_bins).max())


def load_imbalance(sizes: np.ndarray, assign: np.ndarray, num_bins: int) -> float:
    """makespan / mean-load; 1.0 == perfectly balanced."""
    loads = np.bincount(assign, weights=sizes, minlength=num_bins)
    mean = loads.sum() / num_bins
    return float(loads.max() / mean) if mean > 0 else 1.0
