"""Does a torch.profiler session slow a process's later host-bound work?

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 bench_torch/profiler_after_effect.py

Profiles the pinned baseline workload (``python -m repro_torch.obs.prof
run``, in this process) once, then runs one ``torch.profiler`` session
with CUDA activity (20 matmuls of 2048 x 2048), then profiles the pinned
workload twice more. Prints each profile's medians (run.total and the
host-bound phases) in ms, and the card's name and power limit; the
artifacts go to ``build/profiler_after_effect/``. The question it
answers: whether ``chip_smoke.py`` may time the pinned run in the same
process as its earlier profiled sweeps.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.obs.prof.__main__ import main as prof_main  # noqa: E402

OUT = os.path.join(ROOT, "build", "profiler_after_effect")
PHASES = ("run.total", "sweep", "mttkrp", "solve", "remap", "oocore.chunk")


def profile(tag: str) -> dict:
    path = os.path.join(OUT, f"{tag}.json")
    prof_main(["run", "--out", path])
    phases = json.load(open(path))["phases"]
    return {k: round(phases[k]["median_s"] * 1e3, 2) for k in PHASES
            if k in phases}


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_after_effect: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile as torch_profile
    os.makedirs(OUT, exist_ok=True)
    print("before the session", profile("before"), flush=True)
    x = torch.randn(2048, 2048, device="cuda")
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as p:
        for _ in range(20):
            x @ x
        torch.cuda.synchronize()
    p.key_averages()
    print("after, first ", profile("after1"), flush=True)
    print("after, second", profile("after2"), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
