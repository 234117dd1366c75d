"""``python -m repro_torch.reorder [--device cpu|cuda]``: the
locality-ordering smoke.

Port of ``python -m repro.reorder``, with the reference's tensor, mode
and rank: ``zipf_4d((3000, 1400, 900, 50), 3000, alpha=1.3, seed=7)``,
mode 3, R=16, blk=32, 8-row output tiles. For every ordering of
``reorder.ORDERINGS`` one mode step runs through the chunked stream
executor (B6) under a budget that forces several chunks, and the checks
are:

* at least :data:`MIN_CHUNKS` chunks;
* the streamed result is bitwise the factor-resident gather result (B1)
  on the same permuted stream (a reorder is a permutation: it never
  changes what one kernel call computes);
* ``planner.predict_stream_traffic`` equals the executor's counted
  ``StreamStats`` exactly (scheduled and distinct bytes, windows,
  chunks);
* the stats' presort fields reproduce an unsorted prediction;
* at a budget of exactly the measured post-sort windows, the residency
  planner chooses the stream rung.

The budget is the reference's formula (24 blocks of 8-tile windows at
``planner.stream_chunk_bytes``), counted in the port's 8-row tiles.
``--device`` defaults to ``cuda``; ``cpu`` runs the plain versions. Exit
status 0 iff every check passes.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

BLK, TILE_ROWS, RANK, MODE = 32, 8, 16, 3
SHAPE = (3000, 1400, 900, 50)
MIN_CHUNKS = 3


def inputs():
    """The smoke's mode-3 stream (sorted by output row, all valid), its
    factors (numpy float32) and ``rows_cap``."""
    from ..core.tensors import zipf_4d

    t = zipf_4d(SHAPE, 3000, alpha=1.3, seed=7)
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


def chunk_budget() -> int:
    """The reference's budget: 24 blocks of 8-tile windows."""
    from ..oocore import planner

    k = len(SHAPE) - 1
    return 24 * planner.stream_chunk_bytes(BLK, k, (8,) * k)


def check(device=None):
    """Run the smoke on ``device``. Returns ``(failures, ratios)``: the
    failed checks and each ordering's scheduled/distinct tile ratio."""
    import torch

    from ..kernels.mttkrp import kernel as _kernel
    from ..kernels.mttkrp import ops as kops
    from ..oocore import planner
    from ..oocore.executor import mttkrp_out_of_core
    from ..runtime.device import resolve_device
    from . import ORDERINGS, reorder_stream

    dev = resolve_device(device)
    idx, val, valid, factors, rows_cap = inputs()
    idx, val, valid = (torch.from_numpy(idx), torch.from_numpy(val),
                       torch.from_numpy(valid))
    fdev = [torch.from_numpy(f).to(dev) for f in factors]
    frows, k, budget = in_rows(), len(SHAPE) - 1, chunk_budget()
    pkw = dict(mode=MODE, rows_cap=rows_cap, blk=BLK, tile_rows=TILE_ROWS,
               rank=RANK, factor_rows=frows, max_chunk_bytes=budget)

    failures, ratios = [], {}
    for ordering in ORDERINGS:
        out, stats = mttkrp_out_of_core(
            idx, val, valid, factors, mode=MODE, rows_cap=rows_cap, blk=BLK,
            tile_rows=TILE_ROWS, max_chunk_bytes=budget, ordering=ordering,
            device=dev)
        if stats.chunks < MIN_CHUNKS:
            failures.append(f"[{ordering}] budget did not force "
                            f"multi-chunk: {stats.chunks}")
        if ordering == "none":
            i2, v2, m2 = idx, val, valid
        else:
            i2, v2, m2, _ = reorder_stream(idx, val, valid, mode=MODE,
                                           ordering=ordering,
                                           tile_rows=TILE_ROWS)
        resident = kops.mttkrp_device_step(
            i2.to(dev), v2.to(dev), m2.to(dev), fdev, mode=MODE,
            rows_cap=rows_cap, row_offset=0, blk=BLK, tile_rows=TILE_ROWS,
            backend="pallas_fused_gather")
        if not torch.equal(out, resident):
            failures.append(
                f"[{ordering}] streamed result != resident gather result")
        predicted = planner.predict_stream_traffic(i2, m2, ordering=ordering,
                                                   **pkw)
        if (predicted.scheduled_tile_bytes != stats.scheduled_tile_bytes
                or predicted.distinct_tile_bytes != stats.distinct_tile_bytes
                or predicted.window_tiles != stats.window_tiles
                or predicted.chunks != stats.chunks):
            failures.append(f"[{ordering}] predicted != counted: "
                            f"{predicted} vs {stats}")
        ratios[ordering] = predicted.scheduled_over_distinct
        if ordering != "none":
            pre = planner.predict_stream_traffic(idx, valid, ordering="none",
                                                 **pkw)
            if (stats.presort_scheduled_tile_bytes != pre.scheduled_tile_bytes
                    or stats.presort_distinct_tile_bytes
                    != pre.distinct_tile_bytes):
                failures.append(
                    f"[{ordering}] presort fields != unsorted prediction")
            # The measured post-sort windows must certify the stream rung
            # at a budget sized exactly to them.
            wbudget = _kernel.gather_stream_smem_bytes(
                k, kops.padded_rank(RANK), BLK, TILE_ROWS,
                predicted.window_tiles)
            plan = planner.plan_residency(
                nmodes=len(SHAPE), rank=RANK, blk=BLK, tile_rows=TILE_ROWS,
                factor_rows=frows, smem_budget=wbudget,
                window_tiles=predicted.window_tiles)
            if plan.backend != planner.STREAM_BACKEND:
                failures.append(f"[{ordering}] planner at measured-window "
                                f"budget chose {plan.backend}")
    return failures, ratios


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.reorder",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; default) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)
    failures, ratios = check(args.device)
    for f in failures:
        print(f"FAIL {f}")
    if failures:
        return 1
    print("reorder smoke passed: "
          + ", ".join(f"{o}: sched/dist={r:.3f}" for o, r in ratios.items())
          + "; streamed ≡ resident bit-exact per policy, predicted ≡ "
            "counted exactly, stream rung certified at measured windows")
    return 0


if __name__ == "__main__":
    sys.exit(main())
