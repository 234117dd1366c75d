"""Achieved-bandwidth roofline: measured span time × counted bytes.

Port of ``repro/obs/prof/roofline.py``.

The repo's byte counters (``oocore.dma.*``, ``reorder.dma.*``,
``remap.a2a.*``, ``ops.step.model_bytes``) are *counted* — exact,
host-independent — and its spans are *measured*. Joining the two per
span gives the number neither has alone: **achieved GB/s**, the
paper-style roofline coordinate for every kernel backend and residency
rung, with no hardware counters. Spans measure host time: a span covers
its device work only where the code it wraps synchronizes before it
closes (the stepped CP-ALS driver's phases, the executor's chunks under
an enabled tracer, ``ops.timed_device_step``).

The join reads each span's ``self_counters`` (double-count-free even
under same-name nesting) and divides the moved
bytes by the span's *inclusive* duration (the DMA time lives in child
``oocore.chunk`` spans; the bytes are recorded by the parent).

What counts as "moved":

* ``oocore.mode_step`` — ``pipelined + index_stream`` bytes: what a
  pipeline that keeps unchanged window slots transfers (``scheduled`` is the
  naive bound, ``distinct`` the lower bound; both are reported per-key).
* ``ops.device_step`` — the first-order counted traffic model
  (:func:`repro_torch.kernels.mttkrp.ops.step_traffic_bytes`) emitted as
  ``ops.step.model_bytes`` by the timed wrapper.
* anything else — the sum of its ``*_bytes`` self-counters.

stdlib-only; rows are plain dicts ready for the PROF artifact.
"""
from __future__ import annotations

from ..counters import split_key
from ..tracer import sanitize_span_name

__all__ = [
    "RUNG_BY_BACKEND",
    "bandwidth_rows",
    "mode_breakdown",
    "moved_bytes",
]

# Kernel backend -> rung of the residency ladder
# (``oocore.planner.LADDER``), the bf16 names with their fp32 kernel's.
RUNG_BY_BACKEND = {
    "pallas_fused_gather": "whole",
    "pallas_fused_gather_bf16": "whole",
    "pallas_fused_gather_tiled": "slab",
    "pallas_fused_gather_stream": "stream",
    "pallas_fused": "fused",
    "pallas_fused_bf16": "fused",
    "pallas_fused_tiled": "tiled",
    "pallas": "materialized",
    "ref": "reference",
    "segsum": "reference",
}


def _byte_counters(self_counters: dict) -> dict[str, int]:
    """Sum *moved*-``_bytes`` self-counters by base name (labels folded).

    ``planner.*`` bytes (``planner.smem.plan_bytes``,
    ``planner.l2.plan_bytes``) are excluded: they size a *plan*, emitted
    inside whatever span dispatches, not traffic — dividing a span's time
    by them would fabricate a bandwidth.
    """
    out: dict[str, int] = {}
    for key, v in (self_counters or {}).items():
        base, _ = split_key(key)
        if base.endswith("_bytes") and not base.startswith("planner."):
            out[base] = out.get(base, 0) + v
    return out


def moved_bytes(by_base: dict[str, int]) -> tuple[int, str]:
    """``(bytes actually moved, basis string)`` for one span's counters.

    Prefers the physically-meaningful combination when the oocore
    counters are present; falls back to the plain sum otherwise.
    """
    if "oocore.dma.pipelined_bytes" in by_base:
        moved = (by_base["oocore.dma.pipelined_bytes"]
                 + by_base.get("oocore.dma.index_stream_bytes", 0))
        return moved, "pipelined+index_stream"
    if "ops.step.model_bytes" in by_base:
        return by_base["ops.step.model_bytes"], "model"
    return sum(by_base.values()), "sum"


def bandwidth_rows(records) -> list[dict]:
    """Achieved-GB/s rows, one per (span name, backend, rung, ordering).

    Only spans carrying ``*_bytes`` self-counters contribute. Byte
    counts aggregate from ``self_counters`` (never double-counted);
    durations aggregate inclusively (the transfer happens inside the
    span, children included). Per-counter GB/s rides along so the
    scheduled/distinct/pipelined spread stays visible.
    """
    groups: dict[tuple, dict] = {}
    for r in records:
        by_base = _byte_counters(getattr(r, "self_counters", None)
                                 or r.counters)
        if not by_base:
            continue
        args = r.args or {}
        backend = str(args.get("backend", ""))
        rung = str(args.get("rung", "")) or RUNG_BY_BACKEND.get(backend, "")
        key = (sanitize_span_name(r.name), backend, rung,
               str(args.get("ordering", "")))
        g = groups.setdefault(key, {
            "span": key[0], "backend": backend, "rung": rung,
            "ordering": key[3], "calls": 0, "time_s": 0.0, "bytes": {}})
        g["calls"] += 1
        g["time_s"] += r.duration_s
        for base, v in by_base.items():
            g["bytes"][base] = g["bytes"].get(base, 0) + v
    rows = []
    for g in groups.values():
        moved, basis = moved_bytes(g["bytes"])
        t = g["time_s"]
        rows.append({
            **{k: g[k] for k in ("span", "backend", "rung", "ordering",
                                 "calls", "time_s")},
            "moved_bytes": moved,
            "basis": basis,
            "achieved_gbps": (moved / t / 1e9) if t > 0 else 0.0,
            "per_counter_gbps": {
                base: (v / t / 1e9) if t > 0 else 0.0
                for base, v in sorted(g["bytes"].items())},
            "counted_bytes": dict(sorted(g["bytes"].items())),
        })
    rows.sort(key=lambda x: -x["achieved_gbps"])
    return rows


def mode_breakdown(records) -> list[dict]:
    """Paper-style per-mode total-time table for the CP-ALS driver.

    One row per ``mode`` span argument value: inclusive total plus the
    mttkrp/solve/remap child split (the figure the source paper reports
    per mode and per method). ``share_frac`` is each mode's share of
    the summed mode time.
    """
    by_sid = {r.sid: r for r in records}
    rows: dict = {}
    for r in records:
        if r.name != "mode":
            continue
        mode = r.args.get("mode", "?")
        row = rows.setdefault(mode, {
            "mode": mode, "calls": 0, "total_s": 0.0,
            "mttkrp_s": 0.0, "solve_s": 0.0, "remap_s": 0.0})
        row["calls"] += 1
        row["total_s"] += r.duration_s
    for r in records:
        p = by_sid.get(r.parent)
        if p is None or p.name != "mode" or r.name not in (
                "mttkrp", "solve", "remap"):
            continue
        rows[p.args.get("mode", "?")][f"{r.name}_s"] += r.duration_s
    out = sorted(rows.values(), key=lambda x: str(x["mode"]))
    total = sum(r["total_s"] for r in out) or 1.0
    for row in out:
        row["other_s"] = max(0.0, row["total_s"] - row["mttkrp_s"]
                             - row["solve_s"] - row["remap_s"])
        row["share_frac"] = row["total_s"] / total
    return out
