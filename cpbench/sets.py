"""Run a cell several times, one process after another, and give each
metric's median and spread (the quartiles' distance over the median, by
``statistics.quantiles(values, n=4)``).

    python3 cpbench/sets.py --workload nell2-r16 --seeds 11 12 13 \
        --seconds 30 [--trace 1] [--out chiprun_out/sets.jsonl]

Each run's result line, with its seed, its exit code and its standard
error's last lines, is appended to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def spread(values) -> float | None:
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default="chiprun_out/sets.jsonl")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    values: dict[str, list] = {}
    failed = 0
    for seed in args.seeds:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(HERE / "run.py"), "--workload",
             args.workload, "--seed", str(seed), "--seconds",
             str(args.seconds), "--trace", str(args.trace)],
            capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1]) if proc.returncode == 0 else None
        except (IndexError, json.JSONDecodeError):
            res = None
        row = {"workload": args.workload, "seed": seed,
               "trace": args.trace, "rc": proc.returncode, "wall_s": wall,
               "result": res, "stderr": proc.stderr[-4000:]}
        with out.open("a") as f:
            f.write(json.dumps(row) + "\n")
        if res is None or not res["correct"]:
            failed += 1
            print(f"seed {seed}: rc {proc.returncode}, not correct\n"
                  f"{proc.stderr[-3000:]}", flush=True)
            continue
        for name, m in res["metrics"].items():
            values.setdefault(name, []).append(m["value"])
        print(f"seed {seed} wall {wall:.1f} s: " + ", ".join(
            f"{k} {m['value']:.6g}" for k, m in res["metrics"].items())
            + " | " + ", ".join(f"{k} {c['value']:.3e}"
                                for k, c in res["checks"].items()),
            flush=True)
    for name, vals in values.items():
        s = spread(vals)
        print(f"{args.workload} {name}: n {len(vals)} median "
              f"{statistics.median(vals):.6g} spread "
              f"{'-' if s is None else f'{s:.5f}'} values {vals}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
