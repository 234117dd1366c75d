"""Benchmark of the PyTorch/CUDA port (``repro_torch``): CP-ALS sweeps of a
FROSTT stand-in on one card.

    python3 cpbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration and its traffic are found by name:
``BENCHMARK.json`` names the cell's configuration file and traffic,
``cpbench/traffic/<traffic>.json`` holds the rank, backend, block,
ordering and gather precision, ``cpbench/workloads/<cell>.json`` the
limits of the check, each metric is read by
``cpbench/metrics/<metric>.py``, and each file
``cpbench/layers/<layer>.json`` names the port's entry into a layer
(``module``, ``entry``), which a traced run wraps in the range
``cpbench.<layer>``.

Set-up makes the tensor on the card from ``--seed``, runs the port's host
preprocessing (``flycoo.build_flycoo``, ``distributed.prepare_runtime``,
``cpals.device_state``) and two sweeps. The window then calls
``cpals.als_sweep`` back to back, each sweep ending at its fit's read to
the host, until ``--seconds`` have passed; the port's counters
(``obs.counters``) emitted in it go into the run's record. After it the plain reference
(``reference.py``) checks the two set-up sweeps from the seed, the
window's last sweep from its inputs, and the remapped stream. The last
line of standard output is the result; the numbers checked, with their
limits, are the last lines of standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
WARMUP_SWEEPS = 2
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_cell(name: str, root: Path = ROOT) -> tuple[dict, dict]:
    """``(BENCHMARK.json, the cell)``: its entry, configuration, traffic
    and limits, each read from the file its name points at."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    cfg_file = {c["name"]: c["file"] for c in bench["configs"]}[entry["config"]]
    cell = dict(entry)
    cell["config"] = json.loads((root / cfg_file).read_text())
    cell["traffic"] = json.loads(
        (HERE / "traffic" / f"{entry['traffic']}.json").read_text())
    cell["limits"] = json.loads(
        (HERE / "workloads" / f"{name}.json").read_text())["limits"]
    return bench, cell


def cell_metrics(bench: dict, section: str, name: str) -> list[dict]:
    return [m for m in bench[section]
            if "workloads" not in m or name in m["workloads"]]


def load_layers(here: Path = HERE) -> dict[str, dict]:
    """Layer name -> ``{"module", "entry"}``: where the port's entry into
    the layer is looked up when it is called."""
    return {p.stem: json.loads(p.read_text())
            for p in sorted((here / "layers").glob("*.json"))}


@contextlib.contextmanager
def layer_ranges(layers: dict[str, dict]):
    """Wrap each layer's entry in a ``record_function`` range named
    ``cpbench.<layer>``; an entry the port no longer has is left out, and
    its metrics read nothing."""
    import torch
    saved = []
    try:
        for name, where in layers.items():
            mod = importlib.import_module(where["module"])
            fn = getattr(mod, where["entry"], None)
            if fn is None:
                log(f"[cpbench] layer {name}: {where['module']}."
                    f"{where['entry']} not found")
                continue

            def ranged(*a, _fn=fn, _name=name, **kw):
                with torch.profiler.record_function(f"cpbench.{_name}"):
                    return _fn(*a, **kw)
            saved.append((mod, where["entry"], fn))
            setattr(mod, where["entry"], ranged)
        yield
    finally:
        for mod, entry, fn in reversed(saved):
            setattr(mod, entry, fn)


def read_metric(name: str, record: dict):
    """The metric's reader, ``metrics/<name>.py``, applied to the run."""
    spec = importlib.util.spec_from_file_location(
        f"cpbench_metric_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _card_facts() -> dict:
    """Name and power limit as ``nvidia-smi`` reads them, if it runs."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    return {"nvidia_smi": out[0]} if out else {}


def _host_sweep(res) -> dict:
    """A sweep's results, copied to the host for the check."""
    return {"mttkrp": [m[0].cpu() for m in res.mttkrp],
            "factors": [f.cpu() for f in res.factors],
            "lam": res.lam.cpu(), "fit": float(res.fit)}


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def drive(cell: dict, seed: int, seconds: float, trace: bool, device):
    """Set-up, window and check of one run. Returns ``(record, nums)``:
    the readings the metrics read, and the numbers the check compares."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import cpals, distributed as dist, flycoo, tensors
    from repro_torch.core.workers import LocalWorkers
    from repro_torch.obs import counters

    import check
    import devtrace
    import leasttime
    import reference
    import tensorgen

    cfg, tr = cell["config"], cell["traffic"]
    shape = tuple(cfg["shape"])
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    parts = {"start_s": t0 - T_START}   # imports, the card's context
    idx_d, val_d = tensorgen.make_tensor(cfg, seed, device)
    idx_h, val_h = idx_d.cpu().numpy(), val_d.cpu().numpy()
    del idx_d, val_d
    x_idx, x_val = idx_h.copy(), val_h.copy()   # the reference's own copy
    nnz = int(val_h.shape[0])
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    if trace:   # the profiler's own start-up, out of the window
        with torch.profiler.profile():
            torch.ones(1, device=device).add_(1)
    parts["tensor_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ft = flycoo.build_flycoo(tensors.SparseTensor(idx_h, val_h, shape), 1,
                             ordering=tr["ordering"])
    t1 = time.perf_counter()
    rt, packed = dist.prepare_runtime(ft, tr["rank"], blk=tr["blk"],
                                      gather_dtype=tr["gather_dtype"])
    t2 = time.perf_counter()
    workers = LocalWorkers(1, device)
    stream, factors, lam, x_norm_sq = cpals.device_state(
        ft, rt, packed, seed=seed, workers=workers)
    del packed, ft, idx_h, val_h
    _sync(device)
    t3 = time.perf_counter()
    parts.update(flycoo_s=t1 - t0, runtime_s=t2 - t1, state_s=t3 - t2)
    prep_s = t3 - t0

    backend = tr["backend"]
    held = []
    for k in range(WARMUP_SWEEPS):
        res = cpals.als_sweep(stream, factors, lam, x_norm_sq, rt,
                              workers=workers, sweep0=k == 0,
                              backend=backend)
        held.append(_host_sweep(res))
        stream, factors, lam = res.stream, res.factors, res.lam
        del res
    setup_s = time.perf_counter() - T_START
    parts["warmup_s"] = time.perf_counter() - t3
    log(f"[cpbench] {cell['name']} seed {seed}: {nnz} nonzeros, rank "
        f"{tr['rank']}, blk {rt.blk}, prep {prep_s:.3f} s, set-up "
        f"{setup_s:.3f} s (" + ", ".join(
            f"{k} {v:.3f}" for k, v in parts.items()) + ")")

    layers = load_layers()
    window = contextlib.ExitStack()
    window_counters = window.enter_context(counters.use_registry())
    if trace:
        window.enter_context(layer_ranges(layers))
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    times = []
    t_w = time.perf_counter()
    while True:
        inputs = factors
        res = None
        t0 = time.perf_counter()
        with (torch.profiler.record_function("cpbench.sweep") if trace
              else contextlib.nullcontext()):
            res = cpals.als_sweep(stream, factors, lam, x_norm_sq, rt,
                                  workers=workers, sweep0=False,
                                  backend=backend)
            float(res.fit)   # waits for the whole sweep
        t1 = time.perf_counter()
        times.append(t1 - t0)
        stream, factors, lam = res.stream, res.factors, res.lam
        if t1 - t_w >= seconds:
            break
    window_s = time.perf_counter() - t_w
    trace_rec = None
    if trace:
        prof.stop()
    window.close()
    if trace:
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            del prof
            trace_rec = devtrace.reduce_trace(json.loads(path.read_text()),
                                              tuple(layers))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    last = {"mttkrp": [m[0] for m in res.mttkrp], "factors": res.factors,
            "lam": res.lam, "fit": float(res.fit)}
    del rt, workers, lam, x_norm_sq, factors, res

    # The check, after the window and the peak's read.
    t0 = time.perf_counter()
    X_idx = torch.from_numpy(x_idx).to(device)
    X_val = torch.from_numpy(x_val).to(device)
    nums = {"stream_mismatch": check.stream_mismatch(stream, X_idx, X_val)}
    del stream
    rank = tr["rank"]
    init = [torch.from_numpy(a).to(device)
            for a in reference.initial_factors(shape, rank, seed)]
    r0 = reference.sweep(X_idx, X_val, init, sweep0=True)
    del init
    r1 = reference.sweep(X_idx, X_val, r0.factors, sweep0=False)
    nums = check.merge(nums, check.compare_sweep(held[0], r0),
                       check.compare_sweep(held[1], r1))
    del r0, r1, held
    slots = [reference.row_slots(d).to(device) for d in shape]
    rk = reference.sweep(X_idx, X_val, [f[s] for f, s in zip(inputs, slots)],
                         sweep0=False,
                         follow=[f[s] for f, s in zip(last["factors"], slots)])
    nums = check.merge(nums, check.compare_sweep(last, rk))
    del rk, inputs, last
    _sync(device)
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    least = leasttime.least_seconds(shape, nnz, rank, kind)
    record = {
        "setup_s": setup_s, "prep_s": prep_s, "setup_parts": parts,
        "sweep_s": times, "counters": window_counters.snapshot(),
        "window_s": window_s, "peak_bytes": peak, "nnz": nnz,
        "least_s": None if least is None else least[0],
        "least_bound": None if least is None else least[1],
        "trace": trace_rec, "check_s": time.perf_counter() - t0,
        "kind": kind,
    }
    return record, nums


def result(bench: dict, cell: dict, record: dict, nums: dict, trace: bool,
           card: dict) -> dict | None:
    """The run's result line, or ``None`` when the process has loaded JAX
    or the JAX package: looked at last, after every metric is read."""
    import check
    correct, checks = check.judge(nums, cell["limits"])
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, section, cell["name"]):
        value = read_metric(m["name"], record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": record["kind"], "count": 1,
              "memory_peak_bytes": record["peak_bytes"], **card}
    out = {"correct": correct, "attempted": len(record["sweep_s"]),
           "failed": 0 if correct else 1, "metrics": metrics,
           "device": device}
    if trace and record["trace"] is not None:
        tr = record["trace"]
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["checks"] = checks
    log(f"[cpbench] {len(record['sweep_s'])} sweeps in "
        f"{record['window_s']:.3f} s; least time a sweep "
        f"{record['least_s']} s ({record['least_bound']}); check "
        f"{record['check_s']:.3f} s; fit_gap {nums['fit_gap']:.3e}"
        + ("" if "fit_gap" in checks else " (no limit)"))
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}")
    found = forbidden_modules()
    if found:
        log(f"[cpbench] the process loaded {found}: refusing to report")
        return None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    bench, cell = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"[cpbench] needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    card = _card_facts()
    log(f"[cpbench] card {card.get('nvidia_smi', 'not read')}")
    record, nums = drive(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda:0")
    out = result(bench, cell, record, nums, bool(args.trace), card)
    if out is None:
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
