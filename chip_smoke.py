"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, measure.

Run from the root of a checkout on a machine with an H100:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. build the CUDA kernels from ``src/repro_torch/kernels/mttkrp/csrc``;
  2. B1 (``fused_mttkrp_nmode_gather``) and B2 (``..._tiled``) against
     their plain PyTorch versions on random streams (K in {2,3}, R in
     {16,256}, blk=512, tile_rows=8): allclose, B1 == B2 bitwise, and a
     repeated launch bitwise equal;
  3. the main path at nell-2 scale: ``cp_als_distributed`` (R=16, B1,
     3 sweeps) on a synthetic stand-in of FROSTT nell-2 with its real
     shape and nonzero count, then the tiled path (R=256, B2, 1 sweep);
     launch counts, fits, and each mode's sweep-0 kernel output against
     the plain version on the same inputs, with times beside the bounds;
  4. a 4-mode tensor (``frostt_like("enron")``), kernel vs plain per mode;
  5. exact recovery of a dense rank-4 tensor (fit > 0.999);
  6. one JSON line per kernel, the card's name and power limit, and the
     last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32
# (non-tensor-core) FLOP/s, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# rtol, and atol as a fraction of max|plain|: the kernel sums in another
# fp32 order than index_add_.
RTOL, ATOL_FRAC = 1e-5, 1e-5
BLK, TILE_ROWS = 512, 8

SOURCE = "src/repro_torch/kernels/mttkrp/csrc/gather_mttkrp.cu"
REPLACES = {
    "fused_mttkrp_nmode_gather": "src/repro/kernels/mttkrp/kernel.py:632",
    "fused_mttkrp_nmode_gather_tiled":
        "src/repro/kernels/mttkrp/kernel.py:728",
}


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*args):
    print(*args, flush=True)


def gpu_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event milliseconds of ``fn`` over ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_bound_ms(operands, *, rows_cap: int, tile_rows: int
                    ) -> tuple[float, str]:
    """Least time for one kernel call: max(bytes / HBM rate, flops / peak).

    Counts what this run's data needs. Bytes: for each nonzero slot
    (value != 0) its value, K indices and local row; the factors once;
    the per-tile block starts; the output written once. Padding slots
    need no index or row read. Operations: K multiplies and one add per
    column of each nonzero slot.
    """
    vals, idx_stream, factors, _, _ = operands
    rank, k = factors[0].shape[1], len(factors)
    nnz = int((vals != 0).sum())
    nbytes = nnz * (4 + 4 * k + 4)
    nbytes += sum(f.numel() * f.element_size() for f in factors)
    nbytes += (rows_cap // tile_rows + 1) * 4 + rows_cap * rank * 4
    flops = nnz * rank * (k + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(out, plain, what: str) -> float:
    scale = float(plain.abs().max())
    err = float((out - plain).abs().max())
    require(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    require(torch.allclose(out, plain, rtol=RTOL, atol=ATOL_FRAC * scale),
            f"{what}: max|kernel-plain| {err:.3e} (max|plain| {scale:.3e})")
    return err


def phase_build():
    from repro_torch.kernels.mttkrp import build
    t0 = time.perf_counter()
    path, report = build.build()
    build.load()
    secs = time.perf_counter() - t0
    regs = [ln.strip() for ln in report.splitlines()
            if "registers" in ln or "spill" in ln]
    log(f"[build] {os.path.relpath(path, ROOT)} in {secs:.2f} s")
    for ln in regs:
        log(f"[build] ptxas: {ln}")


def random_operands(rng, k: int, rank: int, cap: int, rows_cap: int,
                    slab: int, dev):
    """A row-sorted random stream through the port's own block layout."""
    from repro_torch.kernels.mttkrp import ops
    frows = [int(x) for x in rng.integers(5_000, 30_000, k)]
    rows = np.sort(rng.integers(0, rows_cap, cap)).astype(np.int32)
    cols = [rng.integers(0, f, cap) for f in frows]
    idx = torch.tensor(np.stack([rows] + cols, 1).astype(np.int32),
                       device=dev)
    val = torch.tensor(rng.standard_normal(cap).astype(np.float32),
                       device=dev)
    valid = torch.ones(cap, dtype=torch.bool, device=dev)
    factors = [torch.zeros(rows_cap, rank, device=dev)] + [
        torch.tensor(rng.standard_normal((f, rank)).astype(np.float32),
                     device=dev) for f in frows]
    return ops.gather_operands(idx, val, valid, factors, mode=0,
                               rows_cap=rows_cap, row_offset=0, blk=BLK,
                               tile_rows=TILE_ROWS, slab=slab)


def phase_kernels(dev):
    from repro_torch.kernels.mttkrp import kernel as K
    rng = np.random.default_rng(0)
    cap, rows_cap = 1 << 20, 16_384
    kw = dict(rows_cap=rows_cap, blk=BLK, tile_rows=TILE_ROWS)
    for k, rank in itertools.product((2, 3), (16, 256)):
        slab = min(rank, 128)
        ops_ = random_operands(rng, k, rank, cap, rows_cap, slab, dev)
        b1 = K.fused_mttkrp_nmode_gather(*ops_, **kw)
        b1_again = K.fused_mttkrp_nmode_gather(*ops_, **kw)
        b2 = K.fused_mttkrp_nmode_gather_tiled(*ops_, rank_slab=slab, **kw)
        plain = K.fused_mttkrp_nmode_gather_plain(*ops_, **kw)
        torch.cuda.synchronize()
        what = f"K={k} R={rank}"
        err = compare(b1, plain, f"B1 {what}")
        require(torch.equal(b1, b1_again), f"B1 {what}: rerun differs")
        require(torch.equal(b1, b2), f"B2 {what}: differs from B1 bitwise")
        t_b1 = cuda_ms(lambda: K.fused_mttkrp_nmode_gather(*ops_, **kw), 5)
        t_b2 = cuda_ms(lambda: K.fused_mttkrp_nmode_gather_tiled(
            *ops_, rank_slab=slab, **kw), 5)
        t_p = cuda_ms(lambda: K.fused_mttkrp_nmode_gather_plain(*ops_, **kw),
                      3)
        bound, by = kernel_bound_ms(ops_, rows_cap=rows_cap,
                                    tile_rows=TILE_ROWS)
        log(f"[kernels] {what} nnz={cap} slab={slab}: max_abs_err={err:.3e} "
            f"B1==B2 bitwise, rerun bitwise; B1 {t_b1:.4f} ms, B2 {t_b2:.4f} "
            f"ms, plain {t_p:.4f} ms, bound {bound:.4f} ms ({by})")


def check_modes(ft, rank: int, backend: str, dev, *, reps: int = 5):
    """Sweep 0 through ``backend``; per mode, rebuild the kernel's exact
    inputs, require the kernel to reproduce the sweep's output bitwise and
    to match its plain version, and time both. Returns per-mode rows."""
    from repro_torch.core import cpals, distributed as dist
    from repro_torch.kernels.mttkrp import kernel as K, ops
    tiled = backend == "pallas_fused_gather_tiled"
    kern = (K.fused_mttkrp_nmode_gather_tiled if tiled
            else K.fused_mttkrp_nmode_gather)
    plain = (K.fused_mttkrp_nmode_gather_tiled_plain if tiled
             else K.fused_mttkrp_nmode_gather_plain)
    slab = ops.tiled_rank_slab(rank) if tiled else ops.padded_rank(rank)
    extra = {"rank_slab": slab} if tiled else {}
    rt, packed = dist.prepare_runtime(ft, rank)
    stream, factors, lam, x2 = cpals.device_state(ft, rt, packed, seed=0,
                                                  device=dev)
    del packed
    res = cpals.als_sweep(stream, factors, lam, x2, rt, sweep0=True,
                          backend=backend)
    rows = []
    cur = stream
    for n in range(rt.nmodes):
        facs = list(res.factors[:n]) + list(factors[n:])
        operands = ops.gather_operands(
            *cur, facs, mode=n, rows_cap=rt.rows_cap[n], row_offset=0,
            blk=rt.blk, tile_rows=rt.tile_rows, slab=slab)
        kw = dict(rows_cap=rt.rows_cap[n], blk=rt.blk,
                  tile_rows=rt.tile_rows, **extra)
        out = kern(*operands, **kw)
        require(torch.equal(out[:, :rank], res.mttkrp[n]),
                f"{backend} mode {n}: rebuilt inputs do not reproduce the "
                "sweep's output bitwise")
        ref = plain(*operands, **kw)
        err = compare(out, ref, f"{backend} mode {n}")
        t_k = cuda_ms(lambda: kern(*operands, **kw), reps)
        t_p = cuda_ms(lambda: plain(*operands, **kw), max(1, reps // 2))
        bound, by = kernel_bound_ms(operands, rows_cap=rt.rows_cap[n],
                                    tile_rows=rt.tile_rows)
        rows.append(dict(mode=n, err=err, ms=t_k, plain_ms=t_p,
                         bound_ms=bound, bound_by=by,
                         slots=int(operands[0].shape[0])))
        del operands, out, ref
        cur = dist.device_remap(*cur, (n + 1) % rt.nmodes, rt)[:3]
    return rows, float(res.fit)


def profile_sweep(ft, rank: int, backend: str, dev):
    """Device time by kernel over one later sweep (torch.profiler), and the
    ops that launched the most of it, with their input shapes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import cpals, distributed as dist
    rt, packed = dist.prepare_runtime(ft, rank)
    stream, factors, lam, x2 = cpals.device_state(ft, rt, packed, seed=0,
                                                  device=dev)
    del packed
    res = cpals.als_sweep(stream, factors, lam, x2, rt, sweep0=True,
                          backend=backend)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        res = cpals.als_sweep(res.stream, res.factors, res.lam, x2, rt,
                              sweep0=False, backend=backend)
        float(res.fit)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {ev.key: ev.device_time_total / 1e3
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA}
    busy = sum(kernels.values())
    log(f"[profile] one sweep R={rank} {backend}: wall {wall_ms:.2f} ms, "
        f"kernels {busy:.2f} ms, device idle share {1 - busy / wall_ms:.3f}")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:10]:
        log(f"[profile]   kernel {ms:9.3f} ms  {name[:100]}")
    ops = [ev for ev in prof.key_averages(group_by_input_shape=True)
           if ev.device_type == DeviceType.CPU
           and ev.key.startswith("aten::") and ev.self_device_time_total > 0]
    for ev in sorted(ops, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile]   op {ev.self_device_time_total / 1e3:9.3f} ms  "
            f"x{ev.count} {ev.key} {str(ev.input_shapes)[:90]}")


def phase_main(dev, gpu: str):
    from repro_torch.core import cpals, flycoo, tensors
    from repro_torch.kernels.mttkrp import kernel as K
    prof = tensors.FROSTT_PROFILES["nell-2"]
    shape, nnz = prof["shape"], prof["nnz"]
    t0 = time.perf_counter()
    t = tensors.random_sparse_tensor(shape, nnz, seed=0)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    ft = flycoo.build_flycoo(t, 1)
    t_fly = time.perf_counter() - t0
    log(f"[main] nell-2 stand-in shape={shape} nnz={t.nnz} (profile nnz "
        f"{nnz}, uniform, seed 0): generate {t_gen:.1f} s, build_flycoo "
        f"{t_fly:.1f} s")

    # --- B1 path: counts zeroed just before, read just after ----------
    torch.cuda.reset_peak_memory_stats()
    K.fused_mttkrp_nmode_gather.launches = 0
    K.fused_mttkrp_nmode_gather_tiled.launches = 0
    t0 = time.perf_counter()
    res = cpals.cp_als_distributed(ft, 16, backend="pallas_fused_gather",
                                   iters=3, tol=0.0)
    wall = time.perf_counter() - t0
    b1_launches = K.fused_mttkrp_nmode_gather.launches
    b2_stray = K.fused_mttkrp_nmode_gather_tiled.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fits = res.fits
    log(f"[main] cp_als_distributed R=16 pallas_fused_gather: fits {fits}; "
        f"ms per sweep {[round(s * 1e3, 2) for s in res.sweep_seconds]}; "
        f"call {wall:.1f} s incl. host prepare_runtime; peak device memory "
        f"{peak_gb:.2f} GB; B1 launches {b1_launches}")
    require(b1_launches == 9, f"B1 launched {b1_launches} times, expected 9")
    require(b2_stray == 0, "the B1 path launched B2")
    require(all(np.isfinite(fits)) and max(fits) <= 1.0, f"fits {fits}")
    require(all(b >= a - 1e-3 for a, b in zip(fits[1:], fits[2:])),
            f"fit decreased after sweep 1: {fits}")
    for f in res.factors:
        require(bool(np.isfinite(f).all()), "non-finite factor")

    b1_rows, _ = check_modes(ft, 16, "pallas_fused_gather", dev)
    for r in b1_rows:
        log(f"[main] B1 mode {r['mode']}: {r['slots']} slots, kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']}, HBM 3.35 TB/s), "
            f"max_abs_err {r['err']:.3e}  [{gpu}]")
    profile_sweep(ft, 16, "pallas_fused_gather", dev)

    # --- B2 path (auto's next rung): R=256 in 128-column slabs ---------
    K.fused_mttkrp_nmode_gather.launches = 0
    K.fused_mttkrp_nmode_gather_tiled.launches = 0
    res2 = cpals.cp_als_distributed(
        ft, 256, backend="pallas_fused_gather_tiled", iters=1, tol=0.0)
    b2_launches = K.fused_mttkrp_nmode_gather_tiled.launches
    require(K.fused_mttkrp_nmode_gather.launches == 0,
            "the B2 path launched B1")
    log(f"[main] cp_als_distributed R=256 pallas_fused_gather_tiled: fits "
        f"{res2.fits}; ms per sweep "
        f"{[round(s * 1e3, 2) for s in res2.sweep_seconds]}; B2 launches "
        f"{b2_launches}")
    require(b2_launches == 3, f"B2 launched {b2_launches} times, expected 3")
    require(all(np.isfinite(res2.fits)) and max(res2.fits) <= 1.0,
            f"fits {res2.fits}")
    b2_rows, _ = check_modes(ft, 256, "pallas_fused_gather_tiled", dev,
                             reps=3)
    for r in b2_rows:
        log(f"[main] B2 mode {r['mode']}: {r['slots']} slots, kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']}), max_abs_err "
            f"{r['err']:.3e}  [{gpu}]")
    return {"fused_mttkrp_nmode_gather": (b1_launches, b1_rows),
            "fused_mttkrp_nmode_gather_tiled": (b2_launches, b2_rows)}


def phase_four_mode(dev):
    from repro_torch.core import flycoo, tensors
    t = tensors.frostt_like("enron")
    ft = flycoo.build_flycoo(t, 1)
    rows, fit = check_modes(ft, 16, "pallas_fused_gather", dev)
    require(np.isfinite(fit), f"enron sweep fit {fit}")
    errs = ", ".join(f"{r['err']:.2e}" for r in rows)
    log(f"[enron] 4-mode nnz={t.nnz} R=16: sweep-0 fit {fit:.6f}; per-mode "
        f"max_abs_err [{errs}]")


def dense_lowrank(shape, rank, seed):
    from repro_torch.core.tensors import SparseTensor
    rng = np.random.default_rng(seed)
    facs = [rng.standard_normal((d, rank)) for d in shape]
    dense = np.einsum("ir,jr,kr->ijk", *facs)
    idx = np.array(list(itertools.product(*[range(d) for d in shape])),
                   dtype=np.int32)
    return SparseTensor(idx, dense.reshape(-1).astype(np.float32), shape)


def phase_recovery():
    from repro_torch.core import cpals, flycoo
    t = dense_lowrank((40, 30, 20), 4, seed=0)
    res = cpals.cp_als_distributed(flycoo.build_flycoo(t, 1), 4,
                                   backend="pallas_fused_gather", iters=40,
                                   seed=1)
    log(f"[recovery] dense rank-4 (40,30,20): fit {res.fit:.6f} after "
        f"{res.iters} sweeps")
    require(res.fit > 0.999, f"exact recovery fit {res.fit}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    from repro_torch.kernels.mttkrp import kernel as K
    dev = torch.device("cuda")
    gpu = gpu_info()
    log(f"[gpu] {gpu}; torch {torch.__version__} CUDA {torch.version.cuda}")
    t_all = time.perf_counter()
    phase_build()
    phase_kernels(dev)
    main_rows = phase_main(dev, gpu)
    phase_four_mode(dev)
    phase_recovery()
    kernels = []
    for name, (launches, rows) in main_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": max(r["err"] for r in rows),
            "ms": float(np.mean([r["ms"] for r in rows])),
            "plain_ms": float(np.mean([r["plain_ms"] for r in rows])),
            "bound_ms": float(np.mean([r["bound_ms"] for r in rows])),
            "bound_by": rows[0]["bound_by"],
            "library_ms": None,
        })
    require(all(k["launches"] > 0 for k in kernels), "a kernel never ran")
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s; "
        "kernel ms/plain_ms/bound_ms are means per launch over the modes "
        "of the main path; library_ms null: no single PyTorch call "
        "computes spMTTKRP")
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
