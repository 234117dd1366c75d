"""``python -m repro_torch.obs.prof`` — run / report / gate.

Port of ``python -m repro.obs.prof``. Subcommands:

* ``run``    — profile the pinned baseline workload
  (:mod:`repro_torch.obs.baseline`) to steady state on ``--device``
  (default: CUDA): noise calibration, ``--warmup`` un-timed collects,
  then ``--repeats`` timed collects, each fenced with
  ``torch.cuda.synchronize`` on CUDA. Emits a versioned PROF artifact
  (``bench_torch/obs/PROF_run.json``, or ``PROF_baseline.json`` with
  ``--update-baseline``) plus a collapsed-stack flamegraph and a
  Chrome-trace JSON from the last repeat.
* ``report`` — pretty-print a PROF artifact: phase stats, self-time
  tables, the achieved-bandwidth roofline and the per-mode breakdown.
  No torch import.
* ``gate``   — the noise-aware timed regression gate: ``PROF_run.json``
  against the committed ``PROF_baseline.json``. ``--report-only`` prints
  verdicts but always exits 0. A baseline from another host, another card
  or another power limit SKIPs on its fingerprint.

The timed artifact is separate from the *counted* baseline (``python -m
repro_torch.obs baseline``): counted bytes gate strictly because they are
exact; timed medians gate with MAD-scaled tolerance and a host-noise skip
because they are not. The committed ``PROF_baseline.json`` is the card's:
its fingerprint names the card and its power limit. ``chip_smoke.py``'s
``[obs]`` phase runs ``run`` in a fresh process and gates the result
against it: in a process that has run a ``torch.profiler`` session, the
pinned run's host-bound phases time slower and vary from run to run
(``bench_torch/profiler_after_effect.py``).
"""
import argparse
import functools
import json
import os
import sys
import time

from . import gate as _gate
from . import harness as _harness
from . import roofline as _roofline
from . import selftime as _selftime

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))))
PROF_DIR = os.path.join(_REPO_ROOT, "bench_torch", "obs")
RUN_PATH = os.path.join(PROF_DIR, "PROF_run.json")
BASELINE_PATH = os.path.join(PROF_DIR, "PROF_baseline.json")
FLAME_PATH = os.path.join(PROF_DIR, "PROF_flame.folded")
TRACE_PATH = os.path.join(PROF_DIR, "PROF_trace.json")


def run_profile(*, repeats: int = 3, warmup: int = 1, collect=None,
                clock=time.perf_counter, device=None) -> tuple[dict, list]:
    """Profile the baseline workload; return ``(PROF dict, last records)``.

    ``collect`` is injectable (tests swap in a fast fake taking
    ``tracer=``); the default is the counted baseline's pinned workload
    on ``device`` (``None``: CUDA), so the timed and counted gates
    describe the very same run. Each collect is fenced
    (``harness.measure_steady``'s ``"auto"`` fence: a CUDA synchronize
    once the process uses CUDA) before its time is read.
    """
    from .. import baseline as _baseline
    from .. import tracer as _tracer_mod

    if repeats < 1:
        raise ValueError("run_profile needs repeats >= 1")
    collect_fn = collect or functools.partial(_baseline.collect,
                                              device=device)
    fence = _harness._cuda_fence
    noise = _harness.noise_calibration(clock=clock)
    for _ in range(warmup):
        fence(collect_fn(tracer=_tracer_mod.Tracer()))
    runs = []
    for _ in range(repeats):
        tracer = _tracer_mod.Tracer()
        t0 = clock()
        current = fence(collect_fn(tracer=tracer))
        runs.append((tracer.records, current, clock() - t0))

    # Per-phase samples: one number per repeat per span name (inclusive,
    # recursion-guarded bottom-up totals), plus the end-to-end run time.
    per_name: dict[str, list[float]] = {}
    for records, _cur, elapsed in runs:
        for row in _selftime.bottomup_table(records):
            per_name.setdefault(row["name"], []).append(row["total_s"])
        per_name.setdefault("run.total", []).append(elapsed)
    phases = {name: _harness.robust_stats(samples).to_json()
              for name, samples in sorted(per_name.items())
              if len(samples) == len(runs)}   # present in every repeat

    records, current, _ = runs[-1]
    prof = {
        "meta": {
            "schema": _gate.PROF_SCHEMA,
            "fingerprint": _harness.env_fingerprint(device),
            "noise": noise,
            "workload": _baseline.WORKLOAD,
            "repeats": repeats,
            "warmup": warmup,
            "update_with": "PYTHONPATH=src python -m repro_torch.obs.prof "
                           "run --update-baseline",
        },
        "phases": phases,
        "selftime": {
            "top_down": _selftime.topdown_table(records),
            "bottom_up": _selftime.bottomup_table(records),
        },
        "roofline": _roofline.bandwidth_rows(records),
        "breakdown": _roofline.mode_breakdown(records),
        "counters": {k: int(v)
                     for k, v in sorted(current.get("counters", {}).items())},
    }
    return prof, records


def _write_json(obj: dict, path: str) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def _load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def cmd_run(args) -> int:
    from .. import tracer as _tracer_mod

    prof, records = run_profile(repeats=args.repeats, warmup=args.warmup,
                                device=args.device)
    errors = _gate.validate_prof(prof)
    if errors:   # a malformed emission must never land on disk silently
        for e in errors:
            print(f"FAIL emitted artifact invalid: {e}")
        return 1
    out = args.out or (BASELINE_PATH if args.update_baseline else RUN_PATH)
    path = _write_json(prof, out)
    flame = _selftime.write_flamegraph(records, FLAME_PATH, overwrite=True)
    tr = _tracer_mod.Tracer()
    tr.records.extend(records)
    trace = tr.write_chrome_trace(
        TRACE_PATH, meta={"prof": os.path.basename(path)}, overwrite=True)
    rel = os.path.relpath(path, _REPO_ROOT)
    print(f"wrote {rel}: {len(prof['phases'])} phases, "
          f"{len(prof['roofline'])} roofline rows, "
          f"noise mad_frac {prof['meta']['noise']['mad_frac']:.4f}")
    print(f"wrote {os.path.relpath(flame, _REPO_ROOT)} "
          f"({len(records)} spans)")
    print(f"wrote {os.path.relpath(trace, _REPO_ROOT)}")
    if args.update_baseline:
        print("timed baseline updated — commit it")
    return 0


def _fmt_time(s: float) -> str:
    return f"{s * 1e3:9.3f} ms"


def cmd_report(args) -> int:
    prof = _load_json(args.path)
    errors = _gate.validate_prof(prof)
    for e in errors:
        print(f"FAIL {e}")
    if errors:
        return 1
    meta = prof["meta"]
    fp = meta["fingerprint"]
    print(f"PROF schema {meta['schema']} | host {fp.get('platform')}/"
          f"{fp.get('machine')} cpu={fp.get('cpu_count')} "
          f"devices={fp.get('devices')} power_limit="
          f"{fp.get('power_limit', 'absent')} | noise mad_frac "
          f"{meta['noise']['mad_frac']:.4f}")
    print(f"workload: {meta['workload'].get('tensor')} "
          f"x{meta['workload'].get('tensor_scale')} rank "
          f"{meta['workload'].get('rank')} | repeats {meta['repeats']} "
          f"warmup {meta['warmup']}")
    print("\nphases (median ± sigma-equivalent MAD):")
    for name, ph in sorted(prof["phases"].items(),
                           key=lambda kv: -kv[1]["median_s"]):
        print(f"  {name:<24} {_fmt_time(ph['median_s'])} "
              f"± {100 * ph['mad_frac']:5.1f}%  (n={ph['n']}, "
              f"rejected {ph['rejected']})")
    print("\ntop-down self time (last repeat):")
    for row in prof["selftime"]["top_down"][:args.limit]:
        print(f"  {100 * row['self_frac']:5.1f}%  "
              f"{_fmt_time(row['self_s'])}  x{row['calls']:<4} "
              f"{row['path']}")
    print("\nbottom-up by span name:")
    for row in prof["selftime"]["bottom_up"][:args.limit]:
        print(f"  {100 * row['self_frac']:5.1f}%  self "
              f"{_fmt_time(row['self_s'])}  total "
              f"{_fmt_time(row['total_s'])}  x{row['calls']:<4} "
              f"{row['name']}")
    if prof["roofline"]:
        print("\nachieved bandwidth (measured time x counted bytes):")
        for row in prof["roofline"]:
            where = "/".join(x for x in (row["backend"], row["rung"],
                                         row["ordering"]) if x)
            print(f"  {row['achieved_gbps']:8.3f} GB/s  "
                  f"{row['moved_bytes']:>12} B ({row['basis']})  "
                  f"x{row['calls']:<3} {row['span']}"
                  + (f" [{where}]" if where else ""))
    if prof["breakdown"]:
        print("\nper-mode breakdown:")
        for row in prof["breakdown"]:
            print(f"  mode {row['mode']}: {_fmt_time(row['total_s'])} "
                  f"({100 * row['share_frac']:4.1f}%) = mttkrp "
                  f"{_fmt_time(row['mttkrp_s'])} + solve "
                  f"{_fmt_time(row['solve_s'])} + remap "
                  f"{_fmt_time(row['remap_s'])} + other "
                  f"{_fmt_time(row['other_s'])}")
    return 0


def cmd_gate(args) -> int:
    if not os.path.exists(args.baseline):
        print(f"SKIP no timed baseline at "
              f"{os.path.relpath(args.baseline, _REPO_ROOT)} — create one "
              "with `python -m repro_torch.obs.prof run --update-baseline`")
        return 0
    if not os.path.exists(args.current):
        print(f"FAIL no current profile at "
              f"{os.path.relpath(args.current, _REPO_ROOT)} — run "
              "`python -m repro_torch.obs.prof run` first")
        return 1
    result = _gate.compare(_load_json(args.current),
                           _load_json(args.baseline),
                           max_ratio=args.max_ratio, noise_bar=args.noise_bar)
    for m in result.messages:
        print(m)
    if args.report_only and result.status == "fail":
        print("(report-only: regression reported, exit forced to 0)")
        return 0
    return result.exit_status


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs.prof")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="profile the baseline workload")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--update-baseline", action="store_true",
                   help="write PROF_baseline.json instead of PROF_run.json")
    p.add_argument("--out", default=None,
                   help="explicit output path (overrides the defaults)")
    p.add_argument("--device", default=None,
                   help="device to run on (default: CUDA; 'cpu' runs the "
                        "plain versions)")

    p = sub.add_parser("report", help="pretty-print a PROF artifact")
    p.add_argument("path", nargs="?", default=RUN_PATH)
    p.add_argument("--limit", type=int, default=12,
                   help="rows per self-time table")

    p = sub.add_parser("gate", help="timed regression gate")
    p.add_argument("--current", default=RUN_PATH)
    p.add_argument("--baseline", default=BASELINE_PATH)
    p.add_argument("--max-ratio", type=float, default=_gate.MAX_RATIO)
    p.add_argument("--noise-bar", type=float, default=_gate.NOISE_BAR)
    p.add_argument("--report-only", action="store_true",
                   help="print verdicts but always exit 0")

    args = ap.parse_args(argv)
    return {"run": cmd_run, "report": cmd_report,
            "gate": cmd_gate}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
