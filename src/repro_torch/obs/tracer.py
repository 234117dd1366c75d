"""Nested span tracing with counter attachment and Chrome-trace export.

Port of ``repro/obs/tracer.py``. A :class:`Tracer` records a forest of
wall-time spans::

    with tracer.span("sweep", sweep=0):
        with tracer.span("mode", mode=2):
            with tracer.span("mttkrp"):
                ...

Spans carry an ``args`` dict and, on exit, the *delta* of the active
:mod:`repro_torch.obs.counters` registry across their lifetime, so a
``mode`` span shows exactly the retries and degradations its children
emitted. Enter pushes a frame (one ``perf_counter`` read + one registry
snapshot), exit appends one record; the process-default tracer is the
:data:`NULL` no-op whose ``span`` returns a shared inert context manager.

Spans measure host wall time. CUDA work is asynchronous: a span covers
the device work it launched only if the caller waits for that work
before the span closes (the stepped CP-ALS driver ends each phase with
``torch.cuda.synchronize``). The tracer itself never synchronizes.

Export targets the Chrome trace-event format (complete ``"X"`` events,
microsecond ``ts``/``dur``), loadable in ``chrome://tracing`` and
Perfetto; :func:`validate_chrome_trace` is its schema check.

Not thread-safe by design: one tracer models one logical instruction
stream (the drivers it instruments are single-threaded Python loops).
Scope a fresh tracer per thread if you need more.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time

from . import counters as _counters

__all__ = [
    "NULL",
    "NullTracer",
    "SpanRecord",
    "Tracer",
    "get_tracer",
    "sanitize_span_name",
    "set_tracer",
    "unique_path",
    "use_tracer",
    "validate_chrome_trace",
]

# Characters that break downstream span-name consumers: semicolons are
# the collapsed-stack (flamegraph) separator, braces collide with the
# counter-key label syntax, and control characters corrupt the rendered
# tree / confuse trace viewers even when JSON-escaped.
_NAME_BAD = {ord(c): "_" for c in ";{}"}
_NAME_BAD.update({c: "_" for c in range(0x20)})
_NAME_BAD[0x7F] = "_"


def sanitize_span_name(name) -> str:
    """A span name safe for Chrome-trace, flamegraph, and table exports.

    Non-strings are stringified; semicolons/braces/control characters
    become ``_``. Empty names render as ``"?"`` so a blank never
    produces an unlabeled frame.
    """
    out = str(name).translate(_NAME_BAD)
    return out if out else "?"


def unique_path(path: str) -> str:
    """``path`` if free, else the first ``stem-N.ext`` that is.

    Repeated exports must never silently overwrite an earlier trace —
    callers use the *returned* path as the artifact location.
    """
    if not os.path.exists(path):
        return path
    stem, ext = os.path.splitext(path)
    n = 2
    while os.path.exists(f"{stem}-{n}{ext}"):
        n += 1
    return f"{stem}-{n}{ext}"


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One closed span. ``sid``/``parent`` link the forest (-1 = root).

    ``counters`` is the *inclusive* counter delta over the span's
    lifetime (children included); ``self_counters`` excludes every
    direct child's inclusive delta — the share this span's own body
    emitted. Aggregating ``self_counters`` by name is double-count-free
    even when spans nest under the same name (``oocore.mode_step``
    inside a retried ``oocore.mode_step``, recursive phases, …), which
    is what the profiler's roofline join relies on.
    """

    sid: int
    parent: int
    depth: int
    name: str
    args: dict
    t0: float
    t1: float
    counters: dict
    self_counters: dict = dataclasses.field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0


class _Frame:
    __slots__ = ("sid", "parent", "depth", "name", "args", "t0", "snap",
                 "child_delta")

    def __init__(self, sid, parent, depth, name, args, t0, snap):
        self.sid, self.parent, self.depth = sid, parent, depth
        self.name, self.args, self.t0, self.snap = name, args, t0, snap
        self.child_delta: dict = {}


class _SpanCM:
    """Reusable-shape context manager returned by :meth:`Tracer.span`."""

    __slots__ = ("_tracer", "_name", "_args")

    def __init__(self, tracer, name, args):
        self._tracer, self._name, self._args = tracer, name, args

    def __enter__(self):
        self._tracer._enter(self._name, self._args)
        return self

    def __exit__(self, exc_type, exc, tb):
        # Close on exception too — a failed phase still records its span
        # (the exception propagates; nesting never corrupts).
        self._tracer._exit()
        return False


class Tracer:
    """Collects nested spans; see module docstring."""

    enabled = True

    def __init__(self, *, clock=time.perf_counter, attach_counters=True):
        self._clock = clock
        self._attach = attach_counters
        self._stack: list[_Frame] = []
        self._next_sid = 0
        self.records: list[SpanRecord] = []

    # -- recording ---------------------------------------------------------

    def span(self, name: str, **args) -> _SpanCM:
        return _SpanCM(self, name, args)

    def _enter(self, name: str, args: dict) -> None:
        sid, self._next_sid = self._next_sid, self._next_sid + 1
        parent = self._stack[-1].sid if self._stack else -1
        snap = _counters.get_registry().snapshot() if self._attach else None
        # Clock AFTER the snapshot: registry-copy cost stays outside the
        # measured interval.
        self._stack.append(
            _Frame(sid, parent, len(self._stack), name, args,
                   self._clock(), snap))

    def _exit(self) -> None:
        if not self._stack:
            raise RuntimeError("span exit with no open span")
        t1 = self._clock()
        f = self._stack.pop()
        delta: dict = {}
        self_delta: dict = {}
        if f.snap is not None:
            cur = _counters.get_registry().snapshot()
            delta = {k: v - f.snap.get(k, 0)
                     for k, v in cur.items() if v != f.snap.get(k, 0)}
            # Self-delta: the inclusive delta minus what this frame's
            # direct children already claimed. Same-name nesting is the
            # case that used to double-count — each child's inclusive
            # delta was folded into the parent's only record — so the
            # children's deltas are accumulated per frame on their exit
            # and subtracted here, never re-derived from names.
            self_delta = {k: v - f.child_delta.get(k, 0)
                          for k, v in delta.items()
                          if v != f.child_delta.get(k, 0)}
            if self._stack:
                parent_acc = self._stack[-1].child_delta
                for k, v in delta.items():
                    parent_acc[k] = parent_acc.get(k, 0) + v
        self.records.append(SpanRecord(
            sid=f.sid, parent=f.parent, depth=f.depth, name=f.name,
            args=f.args, t0=f.t0, t1=t1, counters=delta,
            self_counters=self_delta))

    @property
    def open_spans(self) -> int:
        return len(self._stack)

    def reset(self) -> None:
        if self._stack:
            raise RuntimeError(
                f"reset with {len(self._stack)} open span(s): "
                + " > ".join(fr.name for fr in self._stack))
        self.records.clear()
        self._next_sid = 0

    # -- export ------------------------------------------------------------

    def chrome_trace(self, *, meta: dict | None = None) -> dict:
        """The recorded forest as a Chrome trace-event JSON object.

        Complete (``ph="X"``) events with microsecond timestamps
        rebased to the earliest span; span args and the per-span
        counter deltas ride in ``args``. Raises if spans are still
        open — a partial forest would export misleading durations.
        """
        if self._stack:
            raise RuntimeError(
                f"cannot export with {len(self._stack)} open span(s): "
                + " > ".join(fr.name for fr in self._stack))
        pid = os.getpid()
        base = min((r.t0 for r in self.records), default=0.0)
        events = []
        for r in sorted(self.records, key=lambda r: (r.t0, r.depth)):
            args = {str(k): v for k, v in r.args.items()}
            if r.counters:
                args["counters"] = dict(r.counters)
            if r.self_counters and r.self_counters != r.counters:
                args["self_counters"] = dict(r.self_counters)
            events.append({
                "name": sanitize_span_name(r.name),
                "cat": "repro_torch",
                "ph": "X",
                "ts": (r.t0 - base) * 1e6,
                "dur": max(0.0, (r.t1 - r.t0) * 1e6),
                "pid": pid,
                "tid": 0,
                "args": args,
            })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": dict(meta or {}, exporter="repro_torch.obs"),
        }

    def write_chrome_trace(self, path: str, *, meta: dict | None = None,
                           overwrite: bool = False) -> str:
        """Write the trace JSON; returns the path actually written.

        By default an existing file is never clobbered — the export goes
        to the first free ``stem-N.json`` variant instead (repeated
        exports used to silently overwrite). ``overwrite=True`` restores
        the old behavior for callers that manage their own paths.
        """
        if not overwrite:
            path = unique_path(path)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(meta=meta), f, indent=1, default=str)
        return path

    def render(self) -> str:
        """Human-readable span tree with durations and counter deltas."""
        children: dict[int, list[SpanRecord]] = {}
        for r in self.records:
            children.setdefault(r.parent, []).append(r)
        for sibs in children.values():
            sibs.sort(key=lambda r: r.t0)
        lines: list[str] = []

        def emit(r: SpanRecord) -> None:
            arg_s = " ".join(f"{k}={v}" for k, v in r.args.items())
            head = "  " * r.depth + r.name + (f" [{arg_s}]" if arg_s else "")
            lines.append(f"{head:<56s} {r.duration_s * 1e3:10.2f} ms")
            for key, v in sorted(r.counters.items()):
                lines.append("  " * (r.depth + 1) + f"+ {key} = {v}")
            for c in children.get(r.sid, ()):
                emit(c)

        for root in children.get(-1, ()):
            emit(root)
        return "\n".join(lines)


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The default no-op tracer: zero records, zero counters, ~zero cost."""

    enabled = False
    records: tuple = ()
    open_spans = 0

    def span(self, name: str, **args) -> _NullSpan:
        return _NULL_SPAN

    def reset(self) -> None:
        pass


NULL = NullTracer()

_tracer = NULL


def get_tracer():
    """The process-default tracer (:data:`NULL` unless one was set)."""
    return _tracer


def set_tracer(tracer) -> None:
    global _tracer
    _tracer = NULL if tracer is None else tracer


@contextlib.contextmanager
def use_tracer(tracer: Tracer | None = None):
    """Scope the process-default tracer (fresh one by default)."""
    global _tracer
    scoped = Tracer() if tracer is None else tracer
    previous = _tracer
    _tracer = scoped
    try:
        yield scoped
    finally:
        _tracer = previous


def validate_chrome_trace(trace, *, expect_names=()) -> list[str]:
    """Schema-check a Chrome trace object; returns error strings.

    Checks the trace-event contract this exporter relies on (dict with a
    ``traceEvents`` list of complete ``"X"`` events carrying numeric
    ``ts``/``dur`` and a dict ``args``), plus proper nesting per
    ``(pid, tid)``: events must be disjoint or fully contained — an
    overlap means the span forest was corrupted. ``expect_names``
    additionally requires each named span to appear at least once (how
    CI asserts the sweep/mode/phase taxonomy actually got exported).
    """
    errors: list[str] = []
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        return ["trace is not a dict with a 'traceEvents' key"]
    events = trace["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' is not a list"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not a dict")
            continue
        for key in ("name", "ph", "ts", "dur", "pid", "tid", "cat"):
            if key not in ev:
                errors.append(f"event {i}: missing {key!r}")
        if ev.get("ph") != "X":
            errors.append(f"event {i}: ph={ev.get('ph')!r}, expected 'X' "
                          "(complete event)")
        for key in ("ts", "dur"):
            v = ev.get(key)
            if not isinstance(v, (int, float)) or v < 0:
                errors.append(f"event {i}: {key} must be a number >= 0, "
                              f"got {v!r}")
        if not isinstance(ev.get("args", {}), dict):
            errors.append(f"event {i}: args must be a dict")
    if errors:
        return errors
    # Nesting: per timeline, an event starting inside an open one must
    # also end inside it (tiny tolerance for float microsecond math).
    eps = 1e-3
    timelines: dict[tuple, list[dict]] = {}
    for ev in events:
        timelines.setdefault((ev["pid"], ev["tid"]), []).append(ev)
    for tl, evs in timelines.items():
        evs = sorted(evs, key=lambda e: (e["ts"], -e["dur"]))
        open_stack: list[tuple[float, float, str]] = []
        for ev in evs:
            lo, hi = ev["ts"], ev["ts"] + ev["dur"]
            while open_stack and lo >= open_stack[-1][1] - eps:
                open_stack.pop()
            if open_stack and hi > open_stack[-1][1] + eps:
                errors.append(
                    f"timeline {tl}: span {ev['name']!r} "
                    f"[{lo:.3f}, {hi:.3f}] overlaps the end of open span "
                    f"{open_stack[-1][2]!r} [.., {open_stack[-1][1]:.3f}]")
            open_stack.append((lo, hi, ev["name"]))
    names = {ev["name"] for ev in events}
    for want in expect_names:
        if want not in names:
            errors.append(f"expected span name {want!r} not present "
                          f"(saw: {sorted(names)})")
    return errors
