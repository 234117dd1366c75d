"""``python -m repro_torch.tune`` — calibrate / show / check.

  calibrate   time every backend over the grid, save a table JSON
  show        print a saved table (meta, per-config best + timings)
  check       verify dispatch decisions against the measured argmin

The reference's flags and exit codes, plus ``--device``: ``cuda`` (the
default) times the hand-written kernels on the card, ``cpu`` their plain
versions; for ``show`` and ``check`` it is the host a table found by the
registry must match.
"""
from __future__ import annotations

import argparse
import sys

from ..kernels.mttkrp import ops as kops
from . import microbench
from .model import compare_dispatch
from .table import (DEFAULT_TABLE_DIR, CalibrationTable, aggregate_timings,
                    default_table_path, find_table, load_table,
                    measured_best)


def _load(path: str | None, device: str) -> CalibrationTable | None:
    if path is not None:
        return load_table(path)
    return find_table(device=device)


def cmd_calibrate(args) -> int:
    measure = microbench.stub_measure if args.stub else None
    table = microbench.calibrate(quick=not args.full, seed=args.seed,
                                 iters=args.iters, measure=measure,
                                 meta_extra=dict(stub=True) if args.stub
                                 else None, verbose=True,
                                 device=args.device)
    path = args.out or default_table_path(device=args.device)
    table.save(path)
    kind = "stubbed " if args.stub else ""
    print(f"calibrated {len(table.entries)} {kind}grid points "
          f"({'full' if args.full else 'quick'} grid, {args.device}) -> "
          f"{path}")
    return 0


def cmd_show(args) -> int:
    table = _load(args.table, args.device)
    if table is None:
        print("no calibration table found (run `python -m repro_torch.tune "
              "calibrate` first); dispatch uses the static residency ladder")
        return 1
    print(f"schema_version={table.schema_version}")
    for k, v in sorted(table.meta.items()):
        print(f"meta.{k}={v}")
    for key in table.shape_keys():
        nmodes, rank, blk, tile_rows = key
        agg = aggregate_timings(table, key)
        timings = " ".join(f"{b}={agg[b] * 1e3:.4f}ms"
                           for b in sorted(agg))
        print(f"nmodes={nmodes} rank={rank} blk={blk} "
              f"tile_rows={tile_rows} best={measured_best(agg)} {timings}")
    return 0


def check_lines(table: CalibrationTable):
    """``(ok, line, cmp)`` per dispatch key: the table's model argmin
    against the measured one, the calibrated dispatch against the oracle
    (the measured argmin over ``AUTO_BACKENDS``), the empty-table fallback
    against the static rung, and each policy's regret (its measured
    seconds above the oracle's)."""
    empty = CalibrationTable(entries=[])
    for key in table.shape_keys():
        nmodes, rank, blk, tile_rows = key
        cmp = compare_dispatch(table, key)
        kw = dict(nmodes=nmodes, rank=rank, blk=blk, tile_rows=tile_rows)
        model_best = table.best_backend(**kw)
        want_model = measured_best(cmp["agg"])
        fallback = kops.select_backend(
            "auto", table=empty, factor_rows=cmp["factor_rows"], **kw)
        ok = (model_best == want_model
              and cmp["calibrated"] == cmp["oracle"]
              and fallback == cmp["static"])
        agg = cmp["agg"]

        def regret(b):
            if b not in agg or cmp["oracle"] not in agg:
                return "n/a"
            return f"{(agg[b] - agg[cmp['oracle']]) * 1e3:.4f}ms"

        line = (f"{'ok ' if ok else 'BAD'} nmodes={nmodes} rank={rank} "
                f"blk={blk} tile_rows={tile_rows}: model={model_best} "
                f"(measured {want_model}), dispatch={cmp['calibrated']} "
                f"(measured {cmp['oracle']}), static={cmp['static']} "
                f"(empty-table fallback {fallback}); regret static "
                f"{regret(cmp['static'])}, calibrated "
                f"{regret(cmp['calibrated'])}")
        yield ok, line, cmp


def cmd_check(args) -> int:
    table = _load(args.table, args.device)
    if table is None:
        print("no calibration table found; nothing to check")
        return 1
    bad = 0
    for ok, line, _ in check_lines(table):
        bad += not ok
        print(line)
    print(f"{len(table.shape_keys()) - bad}/{len(table.shape_keys())} "
          "dispatch keys consistent")
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tune",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device_flag(p, what):
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help=what)

    c = sub.add_parser("calibrate", help="time backends, save a table")
    c.add_argument("--quick", action="store_true", default=True,
                   help="small grid (default)")
    c.add_argument("--full", action="store_true", help="full grid")
    c.add_argument("--stub", action="store_true",
                   help="deterministic traffic-model pseudo-timings "
                        "instead of running kernels (schema/CLI smoke)")
    c.add_argument("--out", default=None,
                   help=f"output path (default: {DEFAULT_TABLE_DIR}/"
                        "calibration_<schema>_<machine>_<device>.json)")
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--iters", type=int, default=2)
    device_flag(c, "cuda: the kernels on the card (default); cpu: their "
                   "plain versions")
    c.set_defaults(fn=cmd_calibrate)

    s = sub.add_parser("show", help="print a saved calibration table")
    s.add_argument("--table", default=None,
                   help=f"table path (default: newest in {DEFAULT_TABLE_DIR})")
    device_flag(s, "the host a registry table must match")
    s.set_defaults(fn=cmd_show)

    k = sub.add_parser("check",
                       help="verify dispatch matches the measured argmin")
    k.add_argument("--table", default=None,
                   help=f"table path (default: newest in {DEFAULT_TABLE_DIR})")
    device_flag(k, "the host a registry table must match")
    k.set_defaults(fn=cmd_check)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
