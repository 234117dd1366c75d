"""``python -m repro_torch.oocore [--device cpu|cuda]``: the
forced-multi-chunk out-of-core smoke.

Port of ``python -m repro.oocore``, with the reference's tensor, seed,
rank and mode: a (20000, 40, 9000, 30) power-law tensor of 600 draws
(seed 3), R=256, mode 1, blk=32, 8-row output tiles. One mode step runs
through the chunked stream executor (B6) under a byte budget that forces
several chunks, and the checks are:

* the budget forces at least :data:`MIN_CHUNKS` chunks;
* the streamed, chunked result is bitwise the factor-resident gather
  result on the same stream (B1, ``pallas_fused_gather``, which takes
  R=256 at this geometry: 172 KB of shared memory per CTA);
* at a budget of exactly the static stream window
  (``kernel.gather_stream_smem_bytes``, the counterpart of the
  reference's ``gather_stream_vmem_bytes``), the residency planner
  chooses the stream rung.

The reference's budget (2000 bytes) is a number about its own 128-row
windows; here it is re-derived from the port's geometry
(:func:`chunk_budget`). ``--device`` defaults to ``cuda`` (the kernels;
raises without a card); ``cpu`` runs their plain versions. Exit status 0
iff every check passes.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

BLK, TILE_ROWS, RANK, MODE = 32, 8, 256, 1
SHAPE = (20000, 40, 9000, 30)
MIN_CHUNKS = 3


def inputs():
    """The smoke's mode-1 stream (sorted by output row, all valid), its
    factors (numpy float32) and ``rows_cap``."""
    from ..core.tensors import random_sparse_tensor

    t = random_sparse_tensor(SHAPE, 600, seed=3, distribution="powerlaw")
    order = np.argsort(t.indices[:, MODE], kind="stable")
    idx = t.indices[order].astype(np.int32)
    val = t.values[order].astype(np.float32)
    valid = np.ones(len(val), bool)
    rng = np.random.default_rng(0)
    factors = [rng.standard_normal((d, RANK)).astype(np.float32)
               for d in SHAPE]
    rows_cap = -(-SHAPE[MODE] // TILE_ROWS) * TILE_ROWS
    return idx, val, valid, factors, rows_cap


def in_rows() -> tuple[int, ...]:
    return tuple(d for w, d in enumerate(SHAPE) if w != MODE)


def chunk_budget(idx, valid, rows_cap: int) -> int:
    """A chunk budget that splits the stream into more than
    :data:`MIN_CHUNKS` chunks at the port's geometry: the aligned bytes of
    a quarter of the blocks (``planner.stream_chunk_bytes`` at the
    measured windows)."""
    import torch

    from . import planner

    pred = planner.predict_stream_traffic(
        torch.as_tensor(idx), torch.as_tensor(valid), mode=MODE,
        rows_cap=rows_cap, blk=BLK, tile_rows=TILE_ROWS, rank=RANK,
        factor_rows=in_rows())
    per_block = planner.stream_chunk_bytes(BLK, len(SHAPE) - 1,
                                           pred.window_tiles)
    return per_block * max(1, pred.num_blocks // (MIN_CHUNKS + 1))


def check(device=None):
    """Run the smoke on ``device``. Returns ``(failures, stats)``."""
    import torch

    from ..kernels.mttkrp import kernel as _kernel
    from ..kernels.mttkrp import ops as kops
    from ..runtime.device import resolve_device
    from . import planner
    from .executor import mttkrp_out_of_core

    dev = resolve_device(device)
    idx, val, valid, factors, rows_cap = inputs()
    budget = chunk_budget(idx, valid, rows_cap)
    resident = kops.mttkrp_device_step(
        torch.from_numpy(idx).to(dev), torch.from_numpy(val).to(dev),
        torch.from_numpy(valid).to(dev),
        [torch.from_numpy(f).to(dev) for f in factors], mode=MODE,
        rows_cap=rows_cap, row_offset=0, blk=BLK, tile_rows=TILE_ROWS,
        backend="pallas_fused_gather")
    out, stats = mttkrp_out_of_core(
        idx, val, valid, factors, mode=MODE, rows_cap=rows_cap, blk=BLK,
        tile_rows=TILE_ROWS, max_chunk_bytes=budget, device=dev)

    failures = []
    if stats.chunks < MIN_CHUNKS:
        failures.append(f"budget did not force multi-chunk: {stats.chunks}")
    if not torch.equal(out, resident):
        failures.append("streamed chunked result != resident gather result")
    # At a budget exactly the static stream window, the planner must
    # certify the stream rung (B1 and B2 both overflow it).
    windows_static = tuple(planner.stream_window_tiles(BLK, r)
                           for r in in_rows())
    window_budget = _kernel.gather_stream_smem_bytes(
        len(windows_static), kops.padded_rank(RANK), BLK, TILE_ROWS,
        windows_static)
    plan = planner.plan_residency(
        nmodes=len(SHAPE), rank=RANK, blk=BLK, tile_rows=TILE_ROWS,
        factor_rows=in_rows(), smem_budget=window_budget)
    if plan.backend != planner.STREAM_BACKEND:
        failures.append(
            f"planner at window-sized budget chose {plan.backend}")
    return failures, stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.oocore",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; default) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)
    failures, stats = check(args.device)
    for f in failures:
        print(f"FAIL {f}")
    if failures:
        return 1
    print(
        f"oocore smoke passed: {stats.chunks} chunks "
        f"(blocks per chunk {stats.chunk_block_counts}), windows "
        f"{stats.window_tiles}, streamed ≡ resident bit-exact; counted "
        f"{stats.pipelined_tile_bytes} B tiles + "
        f"{stats.index_stream_bytes} B index streams for {stats.nnz} nnz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
