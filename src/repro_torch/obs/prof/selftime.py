"""Span self-time attribution: top-down / bottom-up tables, flamegraphs.

Port of ``repro/obs/prof/selftime.py``.

The tracer records *inclusive* span durations — a ``sweep`` span's time
contains its ``mode`` children, which contain ``mttkrp``/``solve``/
``remap``. Attribution turns that forest into the two classic profiler
views plus a flamegraph:

* **self time** — a span's duration minus its direct children's
  durations: the share its own body (host glue, un-spanned work) is
  responsible for. Self times sum exactly to the roots' total, so a
  table of them is a partition of the wall clock, never a double count.
* **top-down** — one row per *path* (``sweep;mode;mttkrp``): where did
  the time go, structurally.
* **bottom-up** — one row per span *name*, aggregated across every
  path it appears under: which phase is expensive overall. Inclusive
  totals here skip spans nested under a same-named ancestor (a
  recursive/retried phase must not count its own tail twice); self
  times need no such care.
* **collapsed stacks** — ``path<space>self_µs`` lines, the format
  flamegraph.pl / speedscope / inferno all consume, written next to
  the Chrome-trace export.

stdlib-only; operates on any iterable of ``SpanRecord``-shaped objects.
"""
from __future__ import annotations

from ..tracer import sanitize_span_name, unique_path

__all__ = [
    "bottomup_table",
    "flamegraph_lines",
    "self_times_s",
    "span_paths",
    "topdown_table",
    "write_flamegraph",
]


def _by_sid(records) -> dict:
    return {r.sid: r for r in records}


def self_times_s(records) -> dict[int, float]:
    """``{sid: self seconds}`` — duration minus direct children's.

    Clamped at 0: with microsecond-scale spans, float rounding can make
    children sum to epsilon more than the parent.
    """
    child_sum: dict[int, float] = {}
    for r in records:
        child_sum[r.parent] = child_sum.get(r.parent, 0.0) + r.duration_s
    return {r.sid: max(0.0, r.duration_s - child_sum.get(r.sid, 0.0))
            for r in records}


def span_paths(records) -> dict[int, str]:
    """``{sid: "root;child;...;name"}`` with sanitized components."""
    by_sid = _by_sid(records)
    cache: dict[int, str] = {}

    def path(sid: int) -> str:
        if sid in cache:
            return cache[sid]
        r = by_sid[sid]
        name = sanitize_span_name(r.name)
        p = name if r.parent == -1 or r.parent not in by_sid \
            else f"{path(r.parent)};{name}"
        cache[sid] = p
        return p

    return {r.sid: path(r.sid) for r in records}


def _merge_counters(acc: dict, delta: dict) -> None:
    for k, v in delta.items():
        acc[k] = acc.get(k, 0) + v


def topdown_table(records) -> list[dict]:
    """One row per path: calls, inclusive total, self time, self counters.

    Sorted by self time descending — the first row is where the wall
    clock actually went. ``self_frac`` is relative to the forest's
    root total (the profiled wall time).
    """
    selfs = self_times_s(records)
    paths = span_paths(records)
    total = sum(r.duration_s for r in records if r.parent == -1) or 1.0
    rows: dict[str, dict] = {}
    for r in records:
        row = rows.setdefault(paths[r.sid], {
            "path": paths[r.sid], "calls": 0, "total_s": 0.0,
            "self_s": 0.0, "self_counters": {}})
        row["calls"] += 1
        row["total_s"] += r.duration_s
        row["self_s"] += selfs[r.sid]
        _merge_counters(row["self_counters"],
                        getattr(r, "self_counters", {}) or {})
    out = sorted(rows.values(), key=lambda x: -x["self_s"])
    for row in out:
        row["self_frac"] = row["self_s"] / total
    return out


def bottomup_table(records) -> list[dict]:
    """One row per span *name*, aggregated across all paths.

    ``total_s`` counts a span only when no ancestor shares its name —
    the standard recursion guard, without which a retried
    ``oocore.mode_step`` inside an ``oocore.mode_step`` would inflate
    its own inclusive total. ``self_s`` needs no guard (self times
    partition the wall clock by construction).
    """
    selfs = self_times_s(records)
    by_sid = _by_sid(records)
    rows: dict[str, dict] = {}
    for r in records:
        name = sanitize_span_name(r.name)
        row = rows.setdefault(name, {
            "name": name, "calls": 0, "total_s": 0.0, "self_s": 0.0,
            "self_counters": {}})
        row["calls"] += 1
        row["self_s"] += selfs[r.sid]
        _merge_counters(row["self_counters"],
                        getattr(r, "self_counters", {}) or {})
        anc, nested = r.parent, False
        while anc != -1 and anc in by_sid:
            if by_sid[anc].name == r.name:
                nested = True
                break
            anc = by_sid[anc].parent
        if not nested:
            row["total_s"] += r.duration_s
    out = sorted(rows.values(), key=lambda x: -x["self_s"])
    total = sum(r.duration_s for r in records if r.parent == -1) or 1.0
    for row in out:
        row["self_frac"] = row["self_s"] / total
    return out


def flamegraph_lines(records, *, unit: float = 1e6) -> list[str]:
    """Collapsed-stack lines: ``root;child;... <self time in µs>``.

    Zero-self-time paths are kept (count 0 lines are legal and preserve
    structure); values are integers as the collapsed-stack consumers
    expect.
    """
    selfs = self_times_s(records)
    paths = span_paths(records)
    acc: dict[str, float] = {}
    for r in records:
        acc[paths[r.sid]] = acc.get(paths[r.sid], 0.0) + selfs[r.sid]
    return [f"{p} {int(round(v * unit))}" for p, v in sorted(acc.items())]


def write_flamegraph(records, path: str, *, overwrite: bool = False) -> str:
    """Write collapsed stacks to ``path`` (uniquified unless asked not
    to); returns the path actually written."""
    if not overwrite:
        path = unique_path(path)
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(flamegraph_lines(records)))
        f.write("\n")
    return path
