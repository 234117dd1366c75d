"""``python -m repro_torch.obs`` — report / export / validate / baseline.

Port of ``python -m repro.obs``. Subcommands:

* ``report``   — run the instrumented pinned workload (the counted
  baseline's, :mod:`repro_torch.obs.baseline`) and print the span tree
  with per-span counter deltas, then the counters.
* ``export``   — the same run, written as Chrome-trace JSON
  (``--out trace.json``; load it in ``chrome://tracing`` or Perfetto).
* ``validate`` — schema-check an exported trace (stdlib only, no torch
  import); ``--expect sweep,mode,mttkrp`` also requires those span names.
* ``baseline`` — the counted baseline gate (``--check``, the default) or
  a rewrite of the committed file (``--update-baseline``).

``report``, ``export`` and ``baseline`` run on ``--device`` (default:
CUDA; ``cpu`` runs the kernels' plain versions). Counted metrics do not
depend on the device, so one committed baseline serves both.
"""
import argparse
import json
import sys


def _run_instrumented(device):
    from . import baseline as _baseline
    from . import tracer as _tracer_mod

    tracer = _tracer_mod.Tracer()
    current = _baseline.collect(tracer=tracer, device=device)
    return tracer, current


def cmd_report(args) -> int:
    tracer, current = _run_instrumented(args.device)
    print(tracer.render())
    print()
    print("counters:")
    for k, v in sorted(current["counters"].items()):
        print(f"  {k} = {v}")
    return 0


def cmd_export(args) -> int:
    from . import baseline as _baseline

    tracer, current = _run_instrumented(args.device)
    path = tracer.write_chrome_trace(
        args.out, meta={"workload": _baseline.WORKLOAD,
                        "counters": current["counters"]})
    print(f"wrote {path}: {len(tracer.records)} spans, "
          f"{len(current['counters'])} counted metrics")
    return 0


def cmd_validate(args) -> int:
    from .tracer import validate_chrome_trace

    with open(args.path, encoding="utf-8") as f:
        trace = json.load(f)
    expect = [s for s in (args.expect or "").split(",") if s]
    errors = validate_chrome_trace(trace, expect_names=expect)
    for e in errors:
        print(f"FAIL {e}")
    if errors:
        return 1
    n = len(trace["traceEvents"])
    print(f"trace valid: {n} events"
          + (f", all expected span names present ({args.expect})"
             if expect else ""))
    return 0


def cmd_baseline(args) -> int:
    from . import baseline as _baseline

    status, messages = _baseline.run_gate(
        update=args.update_baseline,
        path=args.path or _baseline.BASELINE_PATH, device=args.device)
    for m in messages:
        print(m)
    return status


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    sub = ap.add_subparsers(dest="cmd", required=True)
    device_help = "device to run on (default: CUDA; 'cpu' runs the plain " \
                  "versions)"

    p = sub.add_parser("report", help="print the instrumented run's span tree")
    p.add_argument("--device", default=None, help=device_help)

    p = sub.add_parser("export", help="export a Chrome-trace JSON")
    p.add_argument("--out", default="obs_trace.json")
    p.add_argument("--device", default=None, help=device_help)

    p = sub.add_parser("validate", help="schema-check a trace file")
    p.add_argument("path")
    p.add_argument("--expect", default="",
                   help="comma-separated span names that must appear")

    p = sub.add_parser("baseline", help="counter-baseline gate")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--check", action="store_true", default=True)
    g.add_argument("--update-baseline", action="store_true")
    p.add_argument("--path", default=None,
                   help="baseline artifact path (default: the committed "
                        "bench_torch/obs/BASELINE_counters.json)")
    p.add_argument("--device", default=None, help=device_help)

    args = ap.parse_args(argv)
    return {"report": cmd_report, "export": cmd_export,
            "validate": cmd_validate, "baseline": cmd_baseline}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
