"""The counted baseline: a gate on silent changes of counted traffic.

Port of ``repro/obs/baseline.py``. The counted metrics of the registry
(out-of-core tile bytes, remap exchange bytes, dispatch and planner
decisions, site calls) are **host-independent**: static arithmetic and
data-dependent schedules, never clocks. So one instrumented run of the
pinned workload has exactly one right answer, committed as
``bench_torch/obs/BASELINE_counters.json``. :func:`run_gate` collects
again and diffs: a change to a dispatch decision, a plan, a remap
capacity or a single counted byte fails until it is fixed or re-baselined
on purpose (``python -m repro_torch.obs baseline --update-baseline``,
committing the file).

The same counts come out on the CPU and on the card: a CPU tensor runs
each kernel's plain version and a CUDA tensor the kernel, and every count
is taken before the route splits (``execution.resolve`` fires before a
wrapper picks its route). The committed file was collected on the CPU;
``chip_smoke.py`` holds a collection on the card to it key for key.

What the gate covers (:data:`COUNTED_PREFIXES`): ``cpals.*``,
``dispatch.*``, ``oocore.*``, ``planner.*``, ``remap.*``, ``reorder.*``,
``resilience.*``; ``*_s`` counters are timed and filtered out.

The workload is the reference's (:data:`WORKLOAD`): the same tensor,
workers, rank, sweeps, and the same forced-multichunk out-of-core step
over three orderings. It runs at the port's geometry (factor-row tiles of
8, rank padded to 16), so the ``oocore.*`` and ``reorder.*`` bytes are
the port's own; at the reference's geometry they equal the reference's
baseline (``tests/test_torch_obs_baseline.py``). Two differences by
design: the port's dispatch, planner and site counters fire per call,
not per jit trace (``obs.counters``), so there is no
``jax.clear_caches()`` before a collection; and the plan's bytes are
``planner.smem.plan_bytes`` / ``planner.l2.plan_bytes``, not
``planner.vmem.plan_bytes``.
"""
from __future__ import annotations

import json
import os

__all__ = [
    "BASELINE_PATH",
    "COUNTED_PREFIXES",
    "WORKLOAD",
    "collect",
    "diff",
    "load_baseline",
    "oocore_case",
    "run_gate",
    "write_baseline",
]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
BASELINE_PATH = os.path.join(_REPO_ROOT, "bench_torch", "obs",
                             "BASELINE_counters.json")

# Base-name prefixes whose counters are counted (host-independent).
COUNTED_PREFIXES = ("cpals.", "dispatch.", "oocore.", "planner.", "remap.",
                    "reorder.", "resilience.")

# The pinned workload, the reference's: recorded in the artifact's meta so
# a mismatch can be reproduced.
WORKLOAD = dict(
    tensor="enron", tensor_scale=0.05, tensor_seed=0,
    num_workers=4, rank=16, iters=2, tol=0.0, backend="auto",
    seed=0,
    oocore=dict(shape=(20000, 40, 9000, 30), nnz=600, nnz_seed=3,
                distribution="powerlaw", blk=32, tile_rows=8, rank=256,
                mode=1, max_chunk_bytes=2000,
                orderings=("none", "tile", "morton")),
)


def _is_counted(key: str) -> bool:
    from .counters import split_key

    name, _ = split_key(key)
    return name.startswith(COUNTED_PREFIXES) and not name.endswith("_s")


def oocore_case(device) -> tuple[tuple, dict]:
    """The workload's out-of-core step: ``(args, kwargs)`` of
    ``oocore.executor.mttkrp_out_of_core`` on ``device``, ordering and
    geometry left to the caller."""
    import numpy as np
    import torch

    from ..core.tensors import random_sparse_tensor

    oo = WORKLOAD["oocore"]
    rng = np.random.default_rng(0)
    t = random_sparse_tensor(tuple(oo["shape"]), oo["nnz"],
                             seed=oo["nnz_seed"],
                             distribution=oo["distribution"])
    order = np.argsort(t.indices[:, oo["mode"]], kind="stable")
    idx = torch.from_numpy(t.indices[order].astype(np.int32)).to(device)
    val = torch.from_numpy(t.values[order].astype(np.float32)).to(device)
    valid = torch.ones(len(order), dtype=torch.bool, device=device)
    factors = [torch.from_numpy(np.asarray(
        rng.standard_normal((d, oo["rank"])), np.float32)).to(device)
        for d in oo["shape"]]
    rows_cap = -(-oo["shape"][oo["mode"]] // oo["tile_rows"]) \
        * oo["tile_rows"]
    return (idx, val, valid, factors), dict(
        mode=oo["mode"], rows_cap=rows_cap, blk=oo["blk"],
        tile_rows=oo["tile_rows"], max_chunk_bytes=oo["max_chunk_bytes"],
        device=device)


def collect(tracer=None, *, device=None) -> dict:
    """Run the pinned instrumented workload; return the baseline object.

    ``device``: ``None`` is CUDA (``runtime.device.resolve_device``),
    ``"cpu"`` runs the plain versions. The workers are
    ``LocalWorkers(4, device)``. Returns ``{"meta": ..., "counters": ...}``
    with the counters filtered to the counted set and made ints.
    """
    from ..core.cpals import cp_als_distributed
    from ..core.flycoo import build_flycoo
    from ..core.tensors import frostt_like
    from ..oocore.executor import mttkrp_out_of_core
    from ..runtime.device import resolve_device
    from . import counters as _counters
    from . import tracer as _tracer

    dev = resolve_device(device)
    tracer = _tracer.Tracer() if tracer is None else tracer
    w = WORKLOAD
    with _counters.use_registry() as reg, _tracer.use_tracer(tracer):
        t = frostt_like(w["tensor"], scale=w["tensor_scale"],
                        seed=w["tensor_seed"])
        ft = build_flycoo(t, w["num_workers"], m_bounds=(2, 8),
                          g_bounds=(8, 64))
        result = cp_als_distributed(
            ft, w["rank"], device=dev, iters=w["iters"], seed=w["seed"],
            tol=w["tol"], backend=w["backend"], tracer=tracer)
        # A forced-multichunk out-of-core step per ordering: pins the
        # oocore.dma.* bytes and the reorder.* presort/postsort bytes.
        args, kw = oocore_case(dev)
        with tracer.span("oocore.baseline"):
            for ordering in w["oocore"]["orderings"]:
                mttkrp_out_of_core(*args, ordering=ordering, **kw)
        snapshot = reg.snapshot()

    counters = {k: int(v) for k, v in snapshot.items() if _is_counted(k)}
    return {
        "meta": {
            "schema": 1,
            "workload": WORKLOAD,
            "device": dev.type,
            "counted_prefixes": list(COUNTED_PREFIXES),
            "update_with": "PYTHONPATH=src python -m repro_torch.obs "
                           "baseline --update-baseline --device cpu",
            "final_fit": round(result.fits[-1], 6),
        },
        "counters": counters,
    }


def diff(current: dict, baseline: dict) -> list[str]:
    """Human-readable mismatches between two baseline objects."""
    cur = current["counters"]
    base = baseline["counters"]
    out = []
    for k in sorted(set(base) | set(cur)):
        if k not in cur:
            out.append(f"missing: {k} (baseline {base[k]}, current absent)")
        elif k not in base:
            out.append(f"new: {k} = {cur[k]} (absent from baseline)")
        elif cur[k] != base[k]:
            out.append(f"changed: {k} baseline {base[k]} -> "
                       f"current {cur[k]}")
    return out


def load_baseline(path: str = BASELINE_PATH) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def write_baseline(obj: dict, path: str = BASELINE_PATH) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def _rel(path: str) -> str:
    return os.path.relpath(path, _REPO_ROOT)


def run_gate(*, update: bool = False, path: str = BASELINE_PATH,
             tracer=None, device=None) -> tuple[int, list[str]]:
    """Collect and compare (or rewrite) the baseline.

    Returns ``(exit_status, messages)``: status 0 iff the gate passes (or
    the baseline was updated).
    """
    current = collect(tracer=tracer, device=device)
    if update:
        write_baseline(current, path)
        return 0, [f"baseline updated: {_rel(path)} "
                   f"({len(current['counters'])} counters) — commit it"]
    if not os.path.exists(path):
        return 1, [f"no baseline at {_rel(path)} — run with --update-baseline "
                   "and commit the artifact"]
    mismatches = diff(current, load_baseline(path))
    if mismatches:
        return 1, [f"FAIL {m}" for m in mismatches] + [
            "baseline gate failed: counted traffic/dispatch changed. If "
            "intentional, re-baseline with `python -m repro_torch.obs "
            "baseline --update-baseline` and commit the diff."]
    return 0, [f"baseline gate passed: {len(current['counters'])} counted "
               "metrics match the committed baseline"]
