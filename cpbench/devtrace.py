"""Reduce a ``torch.profiler`` Chrome trace of the timed window to the
numbers the per-layer metrics read.

The harness marks the window with ``record_function`` ranges: one
``cpbench.sweep`` per sweep, and inside it one range per layer it wraps
(``cpbench.<layer>``, one for each file under ``layers/``). A device
operation (kernel, memcpy, memset) counts for every layer whose range
holds the host call that launched it (matched by the trace's correlation
id), so a layer added inside another leaves the outer one's time as it
was; it is named by the innermost of them, and by the sweep when none
holds it. Times in the trace are microseconds on one clock.
"""
from __future__ import annotations

import bisect
import collections

SWEEP = "cpbench.sweep"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NAME_CHARS = 120


class _Ranges:
    """Sorted, non-overlapping host intervals of one range name."""

    def __init__(self, spans):
        spans = sorted(spans)
        self.starts = [s for s, _ in spans]
        self.ends = [e for _, e in spans]

    def start_holding(self, t: float) -> float | None:
        """Start of the interval that holds ``t``, if one does."""
        i = bisect.bisect_right(self.starts, t) - 1
        return self.starts[i] if i >= 0 and t <= self.ends[i] else None


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(trace: dict, layers) -> dict | None:
    """The window's numbers, or ``None`` when it holds no sweep or no
    device operation."""
    events = trace.get("traceEvents", [])
    spans = collections.defaultdict(list)
    launch, ops = {}, {}
    device = []
    for ev in events:
        cat = ev.get("cat")
        if ev.get("ph") != "X":
            continue
        args = ev.get("args") or {}
        if cat == "user_annotation" and ev["name"].startswith("cpbench."):
            spans[ev["name"]].append((ev["ts"], ev["ts"] + ev["dur"]))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launch[args["correlation"]] = (ev["ts"], args.get("External id"))
        elif cat == "cpu_op" and "External id" in args:
            ops[args["External id"]] = ev["name"]
        elif cat in DEVICE_CATS:
            device.append(ev)
    sweeps = spans.get(SWEEP, [])
    if not sweeps:
        return None
    w0 = min(s for s, _ in sweeps)
    w1 = max(e for _, e in sweeps)
    ranges = {name: _Ranges(spans.get(f"cpbench.{name}", ()))
              for name in layers}
    layer_us = dict.fromkeys(layers, 0.0)
    by_name = collections.defaultdict(float)
    intervals = []
    where = []
    for ev in device:
        s, e = ev["ts"], ev["ts"] + ev["dur"]
        if e <= w0 or s >= w1:
            continue
        s, e = max(s, w0), min(e, w1)
        by_name[ev["name"][:NAME_CHARS]] += e - s
        host_t, ext = launch.get((ev.get("args") or {}).get("correlation"),
                                 (None, None))
        layer, latest = "sweep", None
        if host_t is not None:
            for name in layers:
                start = ranges[name].start_holding(host_t)
                if start is None:
                    continue
                layer_us[name] += e - s
                if latest is None or start > latest:
                    layer, latest = name, start
        intervals.append((s, e))
        where.append((s, f"{layer}: {ops.get(ext, 'host')}"))
    if not intervals:
        return None
    busy = _union(intervals)
    busy_us = sum(e - s for s, e in busy)
    # Each gap is named by the layer and the host op that launched the
    # device operation ending it: what the device waited for.
    where.sort()
    starts = [s for s, _ in where]
    gaps = []
    edges = [(w0, w0)] + [tuple(b) for b in busy] + [(w1, w1)]
    for (_, prev_end), (nxt, _) in zip(edges, edges[1:]):
        if nxt > prev_end:
            i = bisect.bisect_left(starts, nxt)
            name = where[i][1] if i < len(where) else "window end"
            gaps.append((name, (nxt - prev_end) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "sweeps": len(sweeps),
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "layer_device_s": {k: v / 1e6 for k, v in layer_us.items()},
        "device_ops": [[n, us / 1e6] for n, us in top],
        "idle_gaps": [[n, s] for n, s in gaps[:10]],
    }
