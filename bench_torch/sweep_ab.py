"""Steady CP-ALS sweeps of the port on the nell-2 stand-in, for comparing two trees.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 bench_torch/sweep_ab.py [--tree DIR] [--workers D] [--cache DIR]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so one
call can time an unpacked older commit beside this one; trees from before
``core.workers`` existed run at one worker through their own
``device_state(..., device=)`` / ``als_sweep`` signature. Builds the
nell-2 stand-in (12100 x 9200 x 28800, 76,899,057 uniform nonzeros, seed
0; with ``--cache``, generated once and reloaded), FLYCOO for ``D``
workers, R=16, and runs ``--sweeps`` sweeps of ``als_sweep`` with
``backend="auto"`` from ``init_factors(seed=0)``, each timed on the host
clock and with CUDA events, then one later sweep under
``torch.profiler``: its device kernel time, the ops that launched the
most of it, and the device time of ``aten::cat`` (stacking). Prints one
JSON line with every number and, last, the card's name and power limit.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE, NNZ, RANK = (12100, 9200, 28800), 76_899_057, 16


def stand_in(tensors, cache: str | None):
    """The nell-2 stand-in, from ``cache`` when it holds one."""
    path = cache and os.path.join(cache, "nell2_seed0.npz")
    if path and os.path.exists(path):
        z = np.load(path)
        return tensors.SparseTensor(z["indices"], z["values"], SHAPE)
    t = tensors.random_sparse_tensor(SHAPE, NNZ, seed=0)
    if path:
        os.makedirs(cache, exist_ok=True)
        np.savez(path, indices=t.indices, values=t.values)
    return t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--sweeps", type=int, default=3)
    ap.add_argument("--cache", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import cpals, distributed as dist, flycoo, tensors
    dev = torch.device("cuda")
    t = stand_in(tensors, args.cache)
    ft = flycoo.build_flycoo(t, args.workers)
    rt, packed = dist.prepare_runtime(ft, RANK)
    if "workers" in inspect.signature(cpals.als_sweep).parameters:
        from repro_torch.core.workers import LocalWorkers
        wk = {"workers": LocalWorkers(args.workers, dev)}
        stream, factors, lam, x2 = cpals.device_state(ft, rt, packed, seed=0,
                                                      **wk)
    else:
        if args.workers != 1:
            raise SystemExit("this tree runs one worker only")
        wk = {}
        stream, factors, lam, x2 = cpals.device_state(ft, rt, packed, seed=0,
                                                      device=dev)
    del packed

    def sweep(sweep0: bool):
        nonlocal stream, factors, lam
        res = cpals.als_sweep(stream, factors, lam, x2, rt, sweep0=sweep0,
                              backend="auto", **wk)
        stream, factors, lam = res.stream, res.factors, res.lam
        return float(res.fit)

    host_ms, event_ms = [], []
    for it in range(args.sweeps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        sweep(it == 0)          # float(fit) waits for the sweep
        stop.record()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        stop.synchronize()
        event_ms.append(start.elapsed_time(stop))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        sweep(False)
        wall = (time.perf_counter() - t0) * 1e3
    kernels = sum(ev.device_time_total for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA) / 1e3
    ops = sorted((ev for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CPU
                  and ev.key.startswith("aten::")
                  and ev.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    top = {ev.key: [ev.self_device_time_total / 1e3, ev.count]
           for ev in ops[:8]}
    cat = [[ev.self_device_time_total / 1e3, ev.count] for ev in ops
           if ev.key == "aten::cat"]
    print(json.dumps({
        "tree": os.path.relpath(os.path.abspath(args.tree), ROOT),
        "workers": args.workers, "rank": RANK, "nnz": int(t.nnz),
        "sweep_host_ms": host_ms, "sweep_event_ms": event_ms,
        "profiled_wall_ms": wall, "profiled_kernel_ms": kernels,
        "cat_ms_count": cat[0] if cat else [0.0, 0],
        "top_ops_ms_count": top,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
