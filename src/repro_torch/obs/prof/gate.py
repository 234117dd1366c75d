"""The noise-aware timed regression gate over PROF artifacts.

Port of ``repro/obs/prof/gate.py``.

Timed numbers are host-local and noisy — a naive "current > baseline"
gate would be the flakiest check in CI. This gate is built to *never*
fail on noise:

* **ratio threshold** — a phase regresses only when its median exceeds
  ``baseline_median × max_ratio`` (default 1.5×: real regressions in
  this stack are 2×+ — a backend fell off a residency rung, a remap
  stopped overlapping — not 10%).
* **MAD-scaled tolerance** — the threshold widens by ``z ×
  (mad_frac_baseline + mad_frac_current)``: a phase whose own samples
  spread 10% gets 10%·z extra headroom, per side.
* **calibration bar** — every PROF artifact records a host-noise score
  (a fixed pure-python workload's ``mad_frac``); when either side's
  score exceeds :data:`NOISE_BAR` the gate SKIPs rather than judging
  timings the host can't reproduce.
* **fingerprint check** — baselines from a different host class
  (platform/machine/cpu/devices, and the card's power limit) SKIP;
  cross-host ratios are not regressions.
* **phase noise guard** — an individual phase spreading past
  :data:`PHASE_NOISE_BAR` is reported but can't fail the gate.

``tests/test_torch_prof.py`` pins both directions: an injected 2× slowdown
fails, and repeated same-distribution runs pass by tolerance
arithmetic, not luck.
"""
from __future__ import annotations

import dataclasses

from . import harness as _harness

__all__ = [
    "GateResult",
    "MAX_RATIO",
    "NOISE_BAR",
    "PHASE_NOISE_BAR",
    "PROF_SCHEMA",
    "TOLERANCE_Z",
    "compare",
    "validate_prof",
]

PROF_SCHEMA = 1
# Median-ratio ceiling before a phase counts as regressed.
MAX_RATIO = 1.5
# How many sigma-equivalent mad_fracs of slack each side contributes.
TOLERANCE_Z = 3.0
# Host-noise calibration mad_frac above which the whole gate SKIPs.
NOISE_BAR = 0.10
# Per-phase mad_frac above which that phase is reported, never failed.
PHASE_NOISE_BAR = 0.35
# Phases faster than this are clock-granularity territory; never gated.
MIN_GATED_S = 1e-4


@dataclasses.dataclass
class GateResult:
    """Outcome of one timed comparison."""

    status: str                 # "pass" | "fail" | "skip"
    messages: list[str]
    phases: list[dict]          # per-phase verdict rows

    @property
    def exit_status(self) -> int:
        return 1 if self.status == "fail" else 0


def validate_prof(obj) -> list[str]:
    """Schema-check a PROF artifact; returns error strings (CI runs
    this against the freshly emitted JSON)."""
    errors: list[str] = []
    if not isinstance(obj, dict):
        return ["PROF artifact is not a dict"]
    meta = obj.get("meta")
    if not isinstance(meta, dict):
        errors.append("missing meta dict")
    else:
        if meta.get("schema") != PROF_SCHEMA:
            errors.append(f"meta.schema is {meta.get('schema')!r}, "
                          f"expected {PROF_SCHEMA}")
        for key in ("fingerprint", "noise", "workload"):
            if not isinstance(meta.get(key), dict):
                errors.append(f"meta.{key} missing or not a dict")
        noise = meta.get("noise")
        if isinstance(noise, dict) and not isinstance(
                noise.get("mad_frac"), (int, float)):
            errors.append("meta.noise.mad_frac missing")
    phases = obj.get("phases")
    if not isinstance(phases, dict) or not phases:
        errors.append("phases missing or empty")
    else:
        for name, ph in phases.items():
            if not isinstance(ph, dict):
                errors.append(f"phase {name!r}: not a dict")
                continue
            for key in ("median_s", "mad_s", "mad_frac"):
                if not isinstance(ph.get(key), (int, float)):
                    errors.append(f"phase {name!r}: missing {key}")
            if not isinstance(ph.get("samples_s"), list) \
                    or not ph.get("samples_s"):
                errors.append(f"phase {name!r}: missing samples_s")
    st = obj.get("selftime")
    if not isinstance(st, dict) or not isinstance(st.get("top_down"), list) \
            or not isinstance(st.get("bottom_up"), list):
        errors.append("selftime.top_down/bottom_up tables missing")
    if not isinstance(obj.get("roofline"), list):
        errors.append("roofline rows missing")
    if not isinstance(obj.get("breakdown"), list):
        errors.append("breakdown rows missing")
    return errors


def _phase_verdict(name: str, base: dict, cur: dict, *, max_ratio: float,
                   z: float) -> dict:
    b_med, c_med = float(base["median_s"]), float(cur["median_s"])
    noise = float(base.get("mad_frac", 0.0)) + float(cur.get("mad_frac", 0.0))
    threshold = max_ratio + z * noise
    ratio = c_med / b_med if b_med > 0 else float("inf")
    row = {
        "phase": name,
        "baseline_median_s": b_med,
        "current_median_s": c_med,
        "ratio": ratio,
        "threshold": threshold,
        "noise_frac": noise,
        "verdict": "ok",
    }
    if max(float(base.get("mad_frac", 0)), float(cur.get("mad_frac", 0))) \
            > PHASE_NOISE_BAR:
        row["verdict"] = "noisy"     # reported, never failed
    elif max(b_med, c_med) < MIN_GATED_S:
        row["verdict"] = "sub-resolution"
    elif ratio > threshold:
        row["verdict"] = "regressed"
    elif ratio < 1.0 / threshold:
        row["verdict"] = "improved"
    return row


def compare(current: dict, baseline: dict, *, max_ratio: float = MAX_RATIO,
            z: float = TOLERANCE_Z, noise_bar: float = NOISE_BAR
            ) -> GateResult:
    """Gate ``current`` against ``baseline`` (both PROF artifacts)."""
    msgs: list[str] = []
    for label, obj in (("current", current), ("baseline", baseline)):
        errs = validate_prof(obj)
        if errs:
            return GateResult("fail", [f"{label} artifact invalid: {e}"
                                       for e in errs], [])
    fp_mismatch = _harness.fingerprint_compatible(
        current["meta"]["fingerprint"], baseline["meta"]["fingerprint"])
    if fp_mismatch:
        return GateResult(
            "skip",
            ["SKIP fingerprint mismatch (cross-host timings are not "
             "comparable): " + "; ".join(fp_mismatch),
             "refresh with `python -m repro_torch.obs.prof run "
             "--update-baseline` on this host"], [])
    for label, obj in (("current", current), ("baseline", baseline)):
        nf = float(obj["meta"]["noise"]["mad_frac"])
        if nf > noise_bar:
            return GateResult(
                "skip",
                [f"SKIP host-noise calibration on {label} run is "
                 f"{nf:.3f} > bar {noise_bar} — timings on this host "
                 "are not reproducible enough to gate"], [])
    rows = []
    for name in sorted(set(baseline["phases"]) & set(current["phases"])):
        rows.append(_phase_verdict(name, baseline["phases"][name],
                                   current["phases"][name],
                                   max_ratio=max_ratio, z=z))
    only_base = sorted(set(baseline["phases"]) - set(current["phases"]))
    only_cur = sorted(set(current["phases"]) - set(baseline["phases"]))
    for name in only_base:
        msgs.append(f"NOTE phase {name!r} in baseline only (instrumentation "
                    "changed?) — re-baseline to re-cover it")
    for name in only_cur:
        msgs.append(f"NOTE phase {name!r} is new (not gated) — re-baseline "
                    "to cover it")
    regressed = [r for r in rows if r["verdict"] == "regressed"]
    for r in rows:
        tag = "FAIL" if r["verdict"] == "regressed" else "ok  "
        note = ("" if r["verdict"] in ("ok", "regressed")
                else f", {r['verdict']}")
        msgs.append(
            f"{tag} {r['phase']}: {r['current_median_s'] * 1e3:.2f} ms vs "
            f"baseline {r['baseline_median_s'] * 1e3:.2f} ms "
            f"(ratio {r['ratio']:.2f}, threshold {r['threshold']:.2f}{note})")
    if not rows:
        return GateResult("skip", msgs + ["SKIP no common phases to gate"],
                          rows)
    if regressed:
        msgs.append(
            f"timed gate FAILED: {len(regressed)} phase(s) regressed past "
            "the noise-scaled threshold. If intentional, re-baseline with "
            "`python -m repro_torch.obs.prof run --update-baseline` and commit.")
        return GateResult("fail", msgs, rows)
    msgs.append(f"timed gate passed: {len(rows)} phases within "
                f"{max_ratio}x (noise-scaled)")
    return GateResult("pass", msgs, rows)
