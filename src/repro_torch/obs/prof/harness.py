"""Steady-state wall-clock measurement with robust statistics.

Port of ``repro/obs/prof/harness.py``: the one timing idiom the profiler
and the timed gate share.

* **fencing** — every sample brackets a call whose result is passed
  through ``block``: ``"auto"`` is ``torch.cuda.synchronize`` once the
  process has work on CUDA (where the reference calls
  ``jax.block_until_ready``), so queued device time never leaks out of
  the measured interval; on the CPU, which runs eagerly, it is nothing;
* **steady state** — ``warmup`` un-timed calls absorb kernel builds and
  cache effects before the first sample;
* **robust stats** — median + MAD (scaled to a sigma-equivalent by
  1.4826), with modified-z-score outlier rejection (Iglewicz–Hoaglin,
  |z| > 3.5), so one GC pause or scheduler hiccup cannot move the number;
* **environment fingerprint** — enough identity of the host and card
  (name, count, power limit) that a timed artifact refuses comparison
  against another machine, or the same card at another power limit;
* **noise calibration** — a fixed pure-python workload timed the same
  way; its relative spread is the host-noise score the timed gate checks
  before trusting any ratio.

stdlib-only at import time (torch is imported inside the functions that
need it), so the schema, validate and report paths never import torch.
"""
from __future__ import annotations

import dataclasses
import os
import platform
import sys
import time

__all__ = [
    "MAD_SIGMA",
    "OUTLIER_Z",
    "PhaseStats",
    "env_fingerprint",
    "fingerprint_compatible",
    "measure_steady",
    "noise_calibration",
    "robust_stats",
]

# MAD -> sigma-equivalent scale for normally distributed samples.
MAD_SIGMA = 1.4826
# Modified z-score cutoff for outlier rejection (Iglewicz & Hoaglin).
OUTLIER_Z = 3.5


def _median(xs: list[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


@dataclasses.dataclass(frozen=True)
class PhaseStats:
    """Robust summary of one timed phase's samples (seconds)."""

    samples_s: tuple[float, ...]    # every sample, pre-rejection
    kept_s: tuple[float, ...]       # samples surviving outlier rejection
    median_s: float
    mad_s: float                    # raw median absolute deviation
    mean_s: float
    min_s: float
    max_s: float
    rejected: int

    @property
    def mad_frac(self) -> float:
        """Sigma-equivalent relative spread: ``1.4826·MAD / median``.

        The noise term every timed-gate tolerance is scaled by; 0 for a
        perfectly steady phase, ~0.05 for a quiet host, >0.2 when the
        host is too noisy to gate on.
        """
        if self.median_s <= 0:
            return 0.0
        return MAD_SIGMA * self.mad_s / self.median_s

    def to_json(self) -> dict:
        return {
            "n": len(self.samples_s),
            "median_s": self.median_s,
            "mad_s": self.mad_s,
            "mad_frac": self.mad_frac,
            "mean_s": self.mean_s,
            "min_s": self.min_s,
            "max_s": self.max_s,
            "rejected": self.rejected,
            "samples_s": list(self.samples_s),
        }

    @classmethod
    def from_json(cls, obj: dict) -> "PhaseStats":
        return robust_stats(obj["samples_s"])


def robust_stats(samples) -> PhaseStats:
    """Median/MAD summary of ``samples`` with outlier rejection.

    Rejection needs >= 4 samples (with fewer, a "modified z score" is
    dominated by the sample itself) and recomputes the summary on the
    survivors; the raw samples are kept in the result so a reader can
    always re-derive everything.
    """
    samples = [float(x) for x in samples]
    if not samples:
        raise ValueError("robust_stats needs at least one sample")
    med = _median(samples)
    mad = _median([abs(x - med) for x in samples])
    kept = samples
    if len(samples) >= 4 and mad > 0:
        kept = [x for x in samples
                if abs(0.6745 * (x - med) / mad) <= OUTLIER_Z] or samples
    med_k = _median(kept)
    mad_k = _median([abs(x - med_k) for x in kept])
    return PhaseStats(
        samples_s=tuple(samples),
        kept_s=tuple(kept),
        median_s=med_k,
        mad_s=mad_k,
        mean_s=sum(kept) / len(kept),
        min_s=min(kept),
        max_s=max(kept),
        rejected=len(samples) - len(kept),
    )


def _cuda_fence(x):
    """``torch.cuda.synchronize()`` once this process has used CUDA;
    nothing before (the CPU runs eagerly). Returns ``x``."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return x


def measure_steady(fn, *, warmup: int = 2, repeats: int = 5,
                   clock=time.perf_counter, block="auto") -> PhaseStats:
    """Time ``fn()`` to steady state: warmup, then ``repeats`` samples.

    ``block`` fences each call (``"auto"`` = ``torch.cuda.synchronize``
    once the process has work on CUDA, nothing before; pass an explicit
    callable or ``None`` to disable). ``clock`` is injectable so tests measure with
    a deterministic fake clock instead of hoping the host is quiet.
    """
    if repeats < 1:
        raise ValueError("measure_steady needs repeats >= 1")
    fence = _cuda_fence if block == "auto" else (block or (lambda x: x))
    for _ in range(warmup):
        fence(fn())
    samples = []
    for _ in range(repeats):
        t0 = clock()
        fence(fn())
        samples.append(clock() - t0)
    return robust_stats(samples)


# Fingerprint keys that must match for a cross-run timed comparison to
# mean anything; the rest (versions) are informational. A card set below
# its maximum power runs slower under load, so its limit is strict.
_FINGERPRINT_STRICT = ("platform", "machine", "cpu_count", "devices",
                       "power_limit")


def _gpu_query(index: int) -> tuple[str, str]:
    """``(name, power limit)`` of card ``index`` as ``nvidia-smi`` reads
    them (``--query-gpu=name,power.limit --format=csv,noheader``)."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={index}"], capture_output=True,
        text=True, check=True, timeout=60)
    name, _, limit = out.stdout.strip().splitlines()[0].rpartition(",")
    return name.strip(), limit.strip()


def env_fingerprint(device=None) -> dict:
    """Who produced these numbers: the host, and the card they ran on.

    ``device`` is where the profiled work ran (``None``: CUDA, as
    ``runtime.device.resolve_device`` says; ``"cpu"``: the host alone).
    On CUDA it records the card's name, the count of cards and the power
    limit (``nvidia-smi``); on the CPU those are absent and ``devices`` is
    ``"cpu"``. Always the torch and CUDA versions.
    """
    import torch

    from ...runtime.device import resolve_device

    dev = resolve_device(device)
    fp = {
        "platform": sys.platform,
        "machine": platform.machine(),
        "python": platform.python_version(),
        "cpu_count": os.cpu_count() or 1,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "devices": "cpu",
    }
    if dev.type == "cuda":
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        name, limit = _gpu_query(index)
        count = torch.cuda.device_count()
        fp.update(devices=f"{count}x{name}", device_name=name,
                  device_count=count, power_limit=limit)
    return fp


def fingerprint_compatible(a: dict, b: dict) -> list[str]:
    """Strict-key mismatches between two fingerprints (empty = same host
    class; timed ratios are meaningful)."""
    return [f"{k}: {a.get(k)!r} != {b.get(k)!r}"
            for k in _FINGERPRINT_STRICT if a.get(k) != b.get(k)]


def _noise_workload(n: int = 80_000) -> int:
    # Fixed pure-python arithmetic: deterministic work, no allocation
    # spikes, long enough (~5ms) that the clock granularity vanishes.
    acc = 0
    for i in range(n):
        acc += i * i
    return acc


def noise_calibration(*, repeats: int = 9, warmup: int = 2,
                      clock=time.perf_counter) -> dict:
    """Time the fixed workload; its spread is the host-noise score.

    A quiet host lands ``mad_frac`` well under 0.05; a noisy, contended
    one (CI neighbors, thermal throttling) pushes past 0.1–0.3, at
    which point the timed gate refuses to fail anyone
    (:data:`repro_torch.obs.prof.gate.NOISE_BAR`).
    """
    stats = measure_steady(_noise_workload, warmup=warmup, repeats=repeats,
                           clock=clock, block=None)
    return {
        "workload": "sum-of-squares-80k",
        "median_s": stats.median_s,
        "mad_frac": stats.mad_frac,
        "samples_s": list(stats.samples_s),
    }
