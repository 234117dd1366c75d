"""``python -m repro_torch.resilience [--device cpu|cuda] [--seed N]``:
the seeded chaos smoke.

Port of ``python -m repro.resilience``: one deterministic program, three
acceptance checks, with the reference's workload (a (60, 50, 40)
power-law tensor of 600 nonzeros as FLYCOO for 4 workers, CP-ALS R=8,
``backend="auto"``, 3 sweeps; a forced-multichunk out-of-core step). The
4 workers run in this process (``LocalWorkers(4)``, the port's
counterpart of the reference's 4-device mesh), on ``--device`` (default
``cuda``; ``cpu`` runs the plain versions of the kernels).

1. **Chaos completes and converges.** The stepped CP-ALS run under a
   seeded fault schedule (one fault at every registered site: kernel
   dispatch, route decision and remap during the sweeps, chunk launch in
   the out-of-core step, and a corrupt calibration-table load for
   ``tune.table_load``, which the registry skips and counts) finishes
   with fits allclose to the fault-free run.
2. **Zero silent fallbacks.** Every scheduled fault fired
   (``pending() == ()``), every firing is counted
   (``resilience.injected`` == schedule size), and every recovery is
   visible (retries + degradations + table fallbacks >= injected).
3. **Resume is exact.** A run checkpointed at sweep 1 and resumed to 4
   gives bitwise the fits and factors of the same run left
   uninterrupted (the checkpoint carries the remapped stream).

The sites fire per call, not per trace as in the reference, so the same
schedule hits other calls than the reference's (``resilience.faults``).
Exit status 0 iff every check holds.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np


def _workload():
    from ..core.flycoo import build_flycoo
    from ..core.tensors import random_sparse_tensor

    t = random_sparse_tensor((60, 50, 40), 600, seed=0,
                             distribution="powerlaw")
    return build_flycoo(t, 4, m_bounds=(2, 8), g_bounds=(8, 64))


def _run_cpals(ft, device, *, resilience=None, checkpoint_dir=None,
               iters=3):
    from ..core.cpals import cp_als_distributed
    from ..core.workers import LocalWorkers

    return cp_als_distributed(
        ft, 8, workers=LocalWorkers(4, device), iters=iters, seed=0,
        tol=0.0, backend="auto", resilience=resilience,
        checkpoint_dir=checkpoint_dir)


def _run_oocore(device):
    """Forced-multichunk out-of-core step: the ``oocore.chunk`` site."""
    from ..core.tensors import random_sparse_tensor
    from ..oocore.executor import mttkrp_out_of_core

    rng = np.random.default_rng(0)
    t = random_sparse_tensor((20000, 40, 9000, 30), 600, seed=3,
                             distribution="powerlaw")
    mode, tile_rows = 1, 8
    order = np.argsort(t.indices[:, mode], kind="stable")
    idx = t.indices[order].astype(np.int32)
    val = t.values[order].astype(np.float32)
    valid = np.ones(len(val), bool)
    factors = [np.asarray(rng.standard_normal((d, 256)), np.float32)
               for d in t.shape]
    rows_cap = -(-t.shape[mode] // tile_rows) * tile_rows
    out, stats = mttkrp_out_of_core(
        idx, val, valid, factors, mode=mode, rows_cap=rows_cap, blk=32,
        tile_rows=tile_rows, max_chunk_bytes=2000, device=device)
    return out, stats.chunks


def _run_table_probes(tmpdir: str, calls: int):
    """``tune.table_load`` site: a valid table found ``calls`` times."""
    from ..tune.table import CalibrationTable, find_table

    CalibrationTable(entries=[], meta={}).save(
        os.path.join(tmpdir, "table.json"))
    return [find_table(tmpdir) is not None for _ in range(calls)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.resilience")
    ap.add_argument("--seed", type=int, default=20240809,
                    help="fault-schedule seed (the reference's default)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where the workers run (cpu: plain versions)")
    args = ap.parse_args(argv)

    from ..obs import counters as _obs
    from . import RetryPolicy, inject, seeded_schedule, use_policy
    from .faults import SITES

    failures: list[str] = []

    def check(ok: bool, what: str):
        print(("ok   " if ok else "FAIL ") + what)
        if not ok:
            failures.append(what)

    ft = _workload()
    horizon = 3

    # -- fault-free, same (stepped) driver --------------------------------
    with _obs.use_registry():
        ref = _run_cpals(ft, args.device, resilience=RetryPolicy())
        ref_oocore, chunks = _run_oocore(args.device)
    print(f"fault-free fits: {[round(f, 6) for f in ref.fits]}; "
          f"out-of-core step in {chunks} chunks")

    # -- chaos: every registered site scheduled ---------------------------
    specs = seeded_schedule(args.seed, sites=SITES, per_site=1,
                            horizon=horizon)
    print(f"schedule (seed {args.seed}): "
          + ", ".join(f"{s.site}#{s.index}:{s.kind}" for s in specs))
    with _obs.use_registry() as reg, inject(specs) as inj, \
            tempfile.TemporaryDirectory() as td:
        chaos = _run_cpals(ft, args.device, resilience=RetryPolicy())
        with use_policy():   # chunk retries need an active policy scope
            chaos_oocore, _ = _run_oocore(args.device)
        probes = _run_table_probes(td, calls=horizon)

        check(len(chaos.fits) == len(ref.fits), "chaos run completed")
        check(bool(np.allclose(chaos.fits, ref.fits, rtol=1e-4, atol=1e-5)),
              f"chaos fit {chaos.fit:.6f} allclose to fault-free "
              f"{ref.fit:.6f}")
        check(bool(np.array_equal(chaos_oocore.cpu().numpy(),
                                  ref_oocore.cpu().numpy())),
              "chunk replayed: out-of-core result bitwise the fault-free one")
        check(inj.pending() == (),
              f"all {len(specs)} scheduled faults fired "
              f"(pending: {inj.pending()})")
        injected = reg.total("resilience.injected")
        check(injected == len(specs),
              f"injected counter == schedule size ({injected} == "
              f"{len(specs)})")
        handled = (reg.total("resilience.retries")
                   + reg.total("resilience.degradations")
                   + reg.total("resilience.table_fallbacks"))
        check(handled >= len(specs),
              f"every fault visibly handled (recoveries {int(handled)} >= "
              f"injected {len(specs)}) — zero silent fallbacks")
        check(probes.count(False) == 1,
              "corrupt table skipped exactly once, valid loads otherwise "
              f"({probes})")
        for k, v in sorted(reg.snapshot().items()):
            if k.startswith("resilience.") and "site_calls" not in k:
                print(f"  {k} = {int(v)}")

    # -- checkpoint/resume exactness --------------------------------------
    with _obs.use_registry() as reg, \
            tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        _run_cpals(ft, args.device, checkpoint_dir=d1, iters=2)
        resumed = _run_cpals(ft, args.device, checkpoint_dir=d1, iters=4)
        full = _run_cpals(ft, args.device, checkpoint_dir=d2, iters=4)
        check(reg.get("resilience.checkpoint.restores") == 1,
              "resumed run restored exactly one checkpoint")
        check(resumed.fits == full.fits
              and all(np.array_equal(a, b)
                      for a, b in zip(resumed.factors, full.factors)),
              f"resume is exact: {[round(f, 6) for f in resumed.fits]} == "
              f"{[round(f, 6) for f in full.fits]}")

    if failures:
        print(f"\nchaos smoke FAILED ({len(failures)}): {failures}")
        return 1
    print("\nchaos smoke passed: faults injected at every site, all "
          "recoveries counted, resume exact")
    return 0


if __name__ == "__main__":
    sys.exit(main())
