"""Sparse tensor containers and seeded synthetic generators.

The port's own copy of ``repro/core/tensors.py`` (numpy, and torch's
stable sort in :func:`_dedup`): the same seed gives the same tensor bit
for bit, so the CPU parity tests can feed one generator's output to both
packages, and :func:`save_tns` writes the reference's bytes for the same
tensor.

The paper evaluates on FROSTT tensors (Nell-1/2, Flickr, Delicious, Vast).
Those are multi-GB downloads, so the benchmark suite uses *FROSTT-scaled
synthetic* tensors: same mode counts, same qualitative index distributions
(power-law "hub" indices, as in web/NLP tensors), scaled nnz.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "SparseTensor",
    "random_sparse_tensor",
    "zipf_4d",
    "low_rank_sparse_tensor",
    "frostt_like",
    "FROSTT_PROFILES",
    "load_tns",
    "save_tns",
]


@dataclasses.dataclass(frozen=True)
class SparseTensor:
    """COO sparse tensor: ``indices[(nnz, N)]``, ``values[(nnz,)]``."""

    indices: np.ndarray  # (nnz, N) int32/int64
    values: np.ndarray   # (nnz,) float
    shape: tuple[int, ...]

    def __post_init__(self):
        assert self.indices.ndim == 2
        assert self.indices.shape[1] == len(self.shape)
        assert self.values.shape == (self.indices.shape[0],)

    @property
    def nnz(self) -> int:
        return self.indices.shape[0]

    @property
    def nmodes(self) -> int:
        return len(self.shape)

    def to_dense(self) -> np.ndarray:
        """Densify (tests only — small tensors)."""
        out = np.zeros(self.shape, dtype=np.float64)
        np.add.at(out, tuple(self.indices.T), self.values.astype(np.float64))
        return out

    def norm(self) -> float:
        return float(np.linalg.norm(self.values))

    def permuted_rows(self, perms: Sequence[np.ndarray]) -> "SparseTensor":
        """Relabel mode-n indices through ``perms[n]`` (natural -> permuted)."""
        idx = np.stack(
            [perms[n][self.indices[:, n]] for n in range(self.nmodes)], axis=1
        )
        return SparseTensor(idx.astype(self.indices.dtype), self.values, self.shape)


def _dedup(indices: np.ndarray, values: np.ndarray, shape) -> SparseTensor:
    """Sum duplicate coordinates (canonical COO), each coordinate's values
    in their drawn order. The stable sort is torch's (the same permutation
    as numpy's stable ``argsort``, which is several times slower on the
    host at tens of millions of keys)."""
    flat = np.ravel_multi_index(tuple(indices.T), shape)
    key, order = torch.sort(torch.from_numpy(flat), stable=True)
    key, order = key.numpy(), order.numpy()
    start = np.flatnonzero(np.concatenate(([key.size > 0],
                                           key[1:] != key[:-1])))
    summed = np.add.reduceat(values[order], start)
    return SparseTensor(indices[order[start]].astype(np.int32),
                        summed.astype(values.dtype), tuple(shape))


def random_sparse_tensor(
    shape: Sequence[int],
    nnz: int,
    *,
    seed: int = 0,
    distribution: str = "uniform",
    alpha: float = 1.1,
    dtype=np.float32,
) -> SparseTensor:
    """Random COO tensor.

    ``distribution='powerlaw'`` skews indices toward small ids (hub structure
    seen in FROSTT web/NLP tensors) — this is what makes super-shard loads
    *unbalanced* and the LPT schedule matter (paper Fig. 6).
    """
    rng = np.random.default_rng(seed)
    if distribution == "powerlaw":
        indices = _powerlaw_columns(rng, shape, nnz, alpha)
    else:
        indices = np.stack([rng.integers(0, dim, size=nnz) for dim in shape],
                           axis=1)
    values = rng.standard_normal(nnz).astype(dtype)
    values[values == 0] = 1.0
    return _dedup(indices, values, tuple(shape))


def _powerlaw_columns(rng, shape, n: int, alpha: float) -> np.ndarray:
    """(n, N) skewed coordinates via inverse-CDF on a truncated Pareto.

    The single source of the Zipf-like hub draw — used by
    ``random_sparse_tensor``, ``zipf_4d`` and the ``repro.tune``
    microbenchmark case generator.
    """
    cols = []
    for dim in shape:
        u = rng.random(n)
        raw = (1.0 - u) ** (-1.0 / alpha) - 1.0
        cols.append(np.minimum((raw * dim / max(raw.max(), 1e-12))
                               .astype(np.int64), dim - 1))
    return np.stack(cols, axis=1)


def zipf_4d(
    shape: Sequence[int],
    nnz: int,
    *,
    alpha: float = 1.3,
    seed: int = 0,
    max_rounds: int = 64,
    dtype=np.float32,
) -> SparseTensor:
    """Skewed (Zipf-like) tensor that keeps its nnz by rejecting duplicates.

    ``random_sparse_tensor(distribution='powerlaw')`` draws coordinates
    independently and then dedups — on small high-order (e.g. scaled
    4-mode) grids the hub coordinates collide so often that almost
    nothing survives, which is why the ``enron`` profile had to fall
    back to uniform indices. This generator instead
    *rejects duplicates during sampling*: it keeps drawing skewed
    batches, keeps only coordinates not seen yet, and tops up with
    uniform draws if the hubs saturate — so skewed 4-mode tensors with
    full nnz exist for calibration and remap benchmarks.

    Named for its motivating use; works for any order.
    """
    shape = tuple(shape)
    capacity = math.prod(int(d) for d in shape)   # exact, unlike float prod
    if nnz > capacity:
        raise ValueError(f"nnz={nnz} exceeds tensor capacity {capacity}")
    rng = np.random.default_rng(seed)
    seen: set[int] = set()
    rows: list[np.ndarray] = []
    rounds = 0
    while len(seen) < nnz and rounds < max_rounds:
        rounds += 1
        want = nnz - len(seen)
        batch = _powerlaw_columns(rng, shape, max(want * 2, 64), alpha)
        flat = np.ravel_multi_index(tuple(batch.T), shape)
        # first occurrence within the batch, then against everything seen
        _, first = np.unique(flat, return_index=True)
        for i in np.sort(first):
            f = int(flat[i])
            if f not in seen:
                seen.add(f)
                rows.append(batch[i])
                if len(seen) >= nnz:
                    break
    if len(seen) < nnz:     # hubs saturated: vectorized uniform top-up
        missing = nnz - len(seen)
        seen_arr = np.fromiter(seen, np.int64, len(seen))
        if capacity <= max(4 * nnz, 1 << 20):
            # dense regime (nnz ~ capacity): enumerate the complement
            free = np.setdiff1d(np.arange(capacity, dtype=np.int64),
                                seen_arr, assume_unique=True)
            pick = rng.choice(free, size=missing, replace=False)
        else:
            # sparse regime: batched rejection, ≥ 3/4 hit rate per draw
            picks: list[np.ndarray] = []
            while missing > 0:
                cand = np.unique(rng.integers(0, capacity,
                                              size=max(2 * missing, 1024)))
                cand = cand[~np.isin(cand, seen_arr)][:missing]
                picks.append(cand)
                seen_arr = np.concatenate([seen_arr, cand])
                missing -= len(cand)
            pick = np.concatenate(picks)
        rows.extend(np.stack(np.unravel_index(pick, shape), axis=1))
    indices = np.stack(rows, axis=0).astype(np.int32)
    values = rng.standard_normal(nnz).astype(dtype)
    values[values == 0] = 1.0
    order = np.argsort(np.ravel_multi_index(tuple(indices.T), shape),
                       kind="stable")
    return SparseTensor(indices[order], values[order], shape)


def low_rank_sparse_tensor(
    shape: Sequence[int],
    rank: int,
    nnz: int,
    *,
    seed: int = 0,
    noise: float = 0.0,
    dtype=np.float32,
) -> tuple[SparseTensor, list[np.ndarray]]:
    """Sparse sample of a ground-truth rank-``rank`` tensor.

    Returns ``(tensor, true_factors)``; CP-ALS on the samples should recover
    factors congruent with the truth (test_cpals uses this).
    """
    rng = np.random.default_rng(seed)
    factors = [rng.standard_normal((dim, rank)).astype(np.float64) for dim in shape]
    idx = np.stack([rng.integers(0, dim, size=nnz) for dim in shape], axis=1)
    vals = np.ones(nnz, dtype=np.float64)
    for n, dim in enumerate(shape):
        pass
    prod = np.ones((nnz, rank), dtype=np.float64)
    for n in range(len(shape)):
        prod *= factors[n][idx[:, n]]
    vals = prod.sum(axis=1)
    if noise:
        vals = vals + noise * rng.standard_normal(nnz)
    t = _dedup(idx, vals.astype(dtype), tuple(shape))
    return t, [f.astype(dtype) for f in factors]


# FROSTT dataset profiles from paper Table II, scaled for a CPU container.
FROSTT_PROFILES: dict[str, dict] = {
    # name: (true shape, true nnz) -> scaled synthetic stand-in
    "nell-1": dict(shape=(2_900_000, 2_100_000, 25_500_000), nnz=143_600_000,
                   scaled_shape=(2900, 2100, 25500), scaled_nnz=143_600,
                   distribution="powerlaw"),
    "nell-2": dict(shape=(12_100, 9_200, 28_800), nnz=76_900_000,
                   scaled_shape=(1210, 920, 2880), scaled_nnz=76_900,
                   distribution="uniform"),
    "flickr": dict(shape=(319_600, 28_200_000, 1_600_000), nnz=112_900_000,
                   scaled_shape=(3196, 28200, 1600), scaled_nnz=112_900,
                   distribution="powerlaw"),
    "delicious": dict(shape=(532_900, 17_300_000, 2_500_000, 1_400), nnz=140_100_000,
                      scaled_shape=(5329, 17300, 2500, 140), scaled_nnz=140_100,
                      distribution="powerlaw"),
    # 4-mode FROSTT tensor (sender × receiver × word × date). Compact mode
    # sizes make it the N-mode fused-kernel benchmark target: every mode is
    # eligible for the fused gather-Hadamard-scatter path. Uniform indices:
    # the scaled-down power-law generator dedups 4-mode tensors to almost
    # nothing, and this tensor must keep its nnz to measure kernel traffic.
    "enron": dict(shape=(6_066, 5_699, 244_268, 1_176), nnz=54_202_099,
                  scaled_shape=(606, 569, 2442, 117), scaled_nnz=54_202,
                  distribution="uniform"),
    # Skewed variant of enron: same profile through the duplicate-rejecting
    # zipf_4d generator, so a 4-mode tensor with hub structure AND full nnz
    # exists (the plain power-law generator dedups 4-mode grids to almost
    # nothing). This is the per-transition remap-savings benchmark target.
    "enron-skew": dict(shape=(6_066, 5_699, 244_268, 1_176), nnz=54_202_099,
                       scaled_shape=(606, 569, 2442, 117), scaled_nnz=54_202,
                       distribution="zipf"),
    "vast": dict(shape=(165_400, 11_400, 2, 100, 89), nnz=26_000_000,
                 scaled_shape=(16540, 1140, 2, 100, 89), scaled_nnz=26_000,
                 distribution="uniform"),
}


def frostt_like(name: str, *, seed: int = 0, scale: float = 1.0) -> SparseTensor:
    """Synthetic stand-in for a FROSTT tensor (paper Table II), scaled."""
    prof = FROSTT_PROFILES[name]
    shape = tuple(max(2, int(d * scale)) if scale != 1.0 else d
                  for d in prof["scaled_shape"])
    nnz = max(16, int(prof["scaled_nnz"] * scale))
    if prof["distribution"] == "zipf":
        return zipf_4d(shape, min(nnz, math.prod(shape)), seed=seed)
    return random_sparse_tensor(shape, nnz, seed=seed, distribution=prof["distribution"])


def load_tns(path: str, *, one_indexed: bool = True) -> SparseTensor:
    """Load a FROSTT ``.tns`` text file (coords then value per line)."""
    data = np.loadtxt(path, dtype=np.float64, ndmin=2)
    idx = data[:, :-1].astype(np.int64)
    if one_indexed:
        idx -= 1
    vals = data[:, -1].astype(np.float32)
    shape = tuple(int(m) + 1 for m in idx.max(axis=0))
    return _dedup(idx, vals, shape)


def save_tns(t: SparseTensor, path: str, *, one_indexed: bool = True) -> None:
    """Write ``t`` as a FROSTT ``.tns`` text file, one nonzero per line."""
    off = 1 if one_indexed else 0
    with open(path, "w") as f:
        for i in range(t.nnz):
            coords = " ".join(str(int(c) + off) for c in t.indices[i])
            f.write(f"{coords} {float(t.values[i]):.9g}\n")
