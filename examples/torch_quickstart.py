"""Quickstart of the PyTorch/CUDA port: sparse CP decomposition with Dynasor.

The counterpart of ``examples/quickstart.py`` on ``repro_torch``, with
the same steps and asserts: a FROSTT-like synthetic sparse tensor, its
FLYCOO format (super-shards + LPT schedule) for 8 workers, CP-ALS with
the single-device oracle, exact recovery of a dense rank-4 tensor, and
the tuning workflow (calibrate the backends on this host, then the
static against the calibrated ``auto`` and a tuned runtime with its
per-transition exchange caps).

  PYTHONPATH=src python examples/torch_quickstart.py               # CUDA
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # plain versions
"""
import argparse
import itertools

import numpy as np

from repro_torch import tune
from repro_torch.core import distributed as dist
from repro_torch.core.cpals import cp_als
from repro_torch.core.flycoo import build_flycoo, choose_partition_params
from repro_torch.core.tensors import SparseTensor, frostt_like
from repro_torch.kernels.mttkrp import ops as kops
from repro_torch.runtime.device import resolve_device


def main(device=None):
    """Run the quickstart on ``device`` (``None``: CUDA; ``"cpu"``: the
    kernels' plain versions)."""
    dev = resolve_device(device)
    print(f"=== Dynasor quickstart (PyTorch port, {dev}) ===")
    # 1. a FROSTT-profile synthetic tensor (power-law hubs, like Flickr)
    t = frostt_like("flickr", scale=0.1)
    print(f"tensor: shape={t.shape} nnz={t.nnz}")

    # 2. FLYCOO preprocessing: partition params via Eq. 2/3, super-shards,
    #    LPT schedule baked into a device-major row permutation
    params = choose_partition_params(t.shape, t.nnz, num_workers=8, rank=16)
    print(f"partition: m={params.m} g={params.g} (Eq.2/3 satisfied="
          f"{params.satisfied})")
    ft = build_flycoo(t, num_workers=8, params=params)
    print(f"bits/nnz in FLYCOO: {ft.bits_per_nonzero():.1f} "
          f"(COO would be {32 * (t.nmodes + 1)})")
    for n, mp in enumerate(ft.modes):
        loads = np.bincount(mp.super_to_device,
                            weights=mp.shard_counts, minlength=8)
        print(f"  mode {n}: {mp.num_super} super-shards, "
              f"load imbalance {loads.max() / loads.mean():.3f}")

    # 3. CP-ALS on the sparse samples
    res = cp_als(t, rank=16, iters=10, seed=0, device=dev)
    print("CP-ALS fits:", " ".join(f"{f:.4f}" for f in res.fits))

    # 4. sanity: exact recovery of a dense rank-4 tensor stored as COO
    rng = np.random.default_rng(1)
    shape2, R = (20, 16, 12), 4
    facs = [rng.standard_normal((d, R)) for d in shape2]
    dense = np.einsum("ir,jr,kr->ijk", *facs)
    idx = np.array(list(itertools.product(*map(range, shape2))), np.int32)
    t2 = SparseTensor(idx, dense.reshape(-1).astype(np.float32), shape2)
    res2 = cp_als(t2, rank=R, iters=25, seed=2, device=dev)
    print(f"low-rank recovery fit: {res2.fit:.4f}")
    assert res2.fit > 0.99

    # 5. tuning workflow: calibrate -> decompose with a tuned runtime.
    #    (`python -m repro_torch.tune calibrate` does this once per host
    #    and saves the table under bench_torch/tune/; here the
    #    reference's two-point micro-grid keeps the example short.)
    grid = [tune.GridPoint(nmodes=3, rank=r, blk=32, tile_rows=8,
                           density=1.0) for r in (16, 128)]
    table = tune.find_table(device=dev) or tune.calibrate(grid=grid,
                                                          device=dev)
    for rank in (16, 128):
        static = kops.select_backend("auto", nmodes=3, rank=rank,
                                     blk=32, tile_rows=8)
        tuned = kops.select_backend("auto", nmodes=3, rank=rank,
                                    blk=32, tile_rows=8, table=table)
        print(f"auto dispatch @rank={rank}: static={static} "
              f"calibrated={tuned}")
    # A huge rank stays on a fused kernel, by rank slabs (B4).
    print("auto dispatch @nmodes=5, rank=8192:",
          kops.select_backend("auto", nmodes=5, rank=8192))
    rt, _ = dist.prepare_runtime(ft, rank=16, table=table)
    print("tuned per-mode plans:", rt.mode_plans)
    print("per-transition exchange caps:", rt.bucket_caps,
          f"(uniform cap would be {rt.bucket_cap})")
    # The same table feeds the distributed solver:
    #   cp_als_distributed(ft, 16, backend="auto", table=table)
    print("OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    main(ap.parse_args().device)
