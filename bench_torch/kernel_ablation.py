"""Ablations of the B1 and B6 designs on one H100: which change moves the time.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 bench_torch/kernel_ablation.py

Each variant is the kernel's source in ``src/repro_torch/kernels/mttkrp/csrc``
with one design choice undone by a text edit, built with the port's nvcc
flags into ``build/ablation/`` (all sources compiled at once) and launched
through the port's own wrapper, on a device-made stream of the nell-2
stand-in's shape (12100 x 9200 x 28800, 76,899,057 uniform nonzeros, seed
0, sorted by the output mode): B1 at blk=512, R=16 (modes 0 and 2) and B2
at R=256; B6 at blk=64, R=16 under Morton order (mode 0), also with the
ring's stages and mapper warps forced. Every variant's output must equal
the unmodified kernel's bitwise. Prints one line per variant with its
CUDA-event mean time, and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels.mttkrp import build, kernel as K, ops  # noqa: E402
from repro_torch.reorder import reorder_stream  # noqa: E402

CSRC = os.path.join(ROOT, "src/repro_torch/kernels/mttkrp/csrc")
OUT = os.path.join(ROOT, "build/ablation")
SHAPE, NNZ = (12100, 9200, 28800), 76_899_057


def edit(source: str, pairs) -> str:
    """``source`` with each (old, new) replaced; each old must occur once."""
    text = open(os.path.join(CSRC, source)).read()
    for old, new in pairs:
        if text.count(old) != 1:
            raise SystemExit(f"ablation edit no longer applies: {old!r}")
        text = text.replace(old, new)
    return text


B1 = "gather_mttkrp.cu"
B6 = "gather_stream_mttkrp.cu"
# name -> (library, source, edits[, edits of mttkrp_common.cuh]): each
# undoes or varies one choice of the design.
VARIANTS = {
    "b1": ("gather_mttkrp", B1, []),
    "b1 tiles in launch order (no last-tile-first)": (
        "gather_mttkrp", B1,
        [("const int t = gridDim.x - 1 - blockIdx.x;",
          "const int t = blockIdx.x;")]),
    "b1 64-bit row offsets": (
        "gather_mttkrp", B1,
        [("int at[kUnroll][K];", "long long at[kUnroll][K];"),
         ("at[u][w] = ix * ld + col0;",
          "at[u][w] = (long long)ix * ld + col0;")]),
    "b1 kUnroll 8": ("gather_mttkrp", B1,
                     [("constexpr int kUnroll = 4;",
                       "constexpr int kUnroll = 8;")]),
    "b1 kUnroll 2": ("gather_mttkrp", B1,
                     [("constexpr int kUnroll = 4;",
                       "constexpr int kUnroll = 2;")]),
    "b1 each chunk staged before its gathers (no overlap)": (
        "gather_mttkrp", B1,
        [("      mttkrp_common::cp_async_wait<1>();",
          "      mttkrp_common::cp_async_wait<0>();")]),
    "b1 factor rows loaded past L1 (ld.global.cg)": (
        "gather_mttkrp", B1,
        [("fs.ptr[w] + at[u][w]; }, use,",
          "fs.ptr[w] + at[u][w]; }, use, /* cg */")],
        [("float ldg_f32(const float* p) { return __ldg(p); }",
          "float ldg_f32(const float* p) { return __ldcg(p); }")]),
    "b6": ("gather_stream_mttkrp", B6, []),
    "b6 one bulk copy per tile (no runs)": (
        "gather_stream_mttkrp", B6,
        [("              if (ld == slab) {\n"
          "                if (j > 0 && entry(w, j - 1) == tile - 1) {",
          "              if (false) {\n"
          "                if (j > 0 && entry(w, j - 1) == tile - 1) {")]),
}
# B6 ring shapes forced through the wrapper: (stages, mapper warps).
RINGS = [(3, 8), (1, 8), (3, 4), (3, 2)]


def build_variants():
    os.makedirs(OUT, exist_ok=True)
    inc = '#include "mttkrp_common.cuh"'
    procs = {}
    for i, (name, (lib, src, pairs, *hdr)) in enumerate(VARIANTS.items()):
        header = os.path.join(OUT, f"v{i}_common.cuh")
        open(header, "w").write(edit("mttkrp_common.cuh",
                                     hdr[0] if hdr else []))
        text = edit(src, pairs).replace(inc, f'#include "{header}"')
        cu, so = os.path.join(OUT, f"v{i}.cu"), os.path.join(OUT, f"v{i}.so")
        open(cu, "w").write(text)
        procs[name] = (lib, so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, so, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{report}")
        handle = ctypes.CDLL(so)
        for fn, argtypes in build._LAUNCH_ARGTYPES[lib].items():
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = ctypes.c_int
        err = getattr(handle, f"{lib}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        libs[name] = handle
    return libs


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device", file=sys.stderr)
        return 2
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    libs = build_variants()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    idx = torch.stack([torch.randint(0, d, (NNZ,), generator=g, device=dev,
                                     dtype=torch.int32) for d in SHAPE], 1)
    val = torch.randn(NNZ, generator=g, device=dev)
    valid = torch.ones(NNZ, dtype=torch.bool, device=dev)
    f16 = [torch.randn(d, 16, generator=g, device=dev) for d in SHAPE]
    f256 = [torch.randn(d, 256, generator=g, device=dev) for d in SHAPE]
    real_load, real_ring = build.load, K.stream_ring
    cases = []  # (label, kernel name prefix, call)
    for mode in (0, 2):
        order = torch.sort(idx[:, mode], stable=True).indices
        si, sv = idx[order].contiguous(), val[order].contiguous()
        rows_cap = -(-SHAPE[mode] // 8) * 8
        kw = dict(rows_cap=rows_cap, blk=512, tile_rows=8)
        o16 = ops.gather_operands(si, sv, valid, f16, mode=mode, row_offset=0,
                                  slab=16, **kw)
        cases.append((f"B1 mode {mode}", "b1",
                      lambda o=o16, kw=kw:
                      K.fused_mttkrp_nmode_gather(*o, **kw)))
        if mode == 0:
            o256 = ops.gather_operands(si, sv, valid, f256, mode=mode,
                                       row_offset=0, slab=128, **kw)
            cases.append(("B2 R=256 mode 0", "b1",
                          lambda o=o256, kw=kw:
                          K.fused_mttkrp_nmode_gather_tiled(
                              *o, rank_slab=128, **kw)))
            ri, rv, rva, _ = reorder_stream(si, sv, valid, mode=0,
                                            ordering="morton", tile_rows=8,
                                            max_rows=max(SHAPE[1:]))
            skw = dict(rows_cap=rows_cap, blk=64, tile_rows=8)
            vals, ia, fm, rows, tob = ops.gather_operands(
                ri, rv, rva, f16, mode=0, row_offset=0, slab=16, **skw)
            fm = tuple(ops._pad_factor_rows(f, K.FACTOR_ROW_TILE) for f in fm)
            scheds, windows, _ = ops.stream_schedules(
                ia, 64, [f.shape[0] for f in fm])
            s_ops = (vals, ia, fm, rows, tob, scheds)
            cases.append((f"B6 mode 0 windows {windows}", "b6",
                          lambda s=s_ops, kw=skw:
                          K.fused_mttkrp_nmode_gather_stream(*s, **kw)))
    for label, prefix, call in cases:
        build.load = lambda name, h=libs[prefix]: h
        want = call()
        for name, handle in libs.items():
            if not name.startswith(prefix + " ") and name != prefix:
                continue
            rings = RINGS if name == "b6" else [None]
            for ring in rings:
                build.load = lambda n, h=handle: h
                K.stream_ring = (real_ring if ring is None else
                                 (lambda *a, r=ring, **k: r))
                got = call()
                same = torch.equal(got, want)
                ms = cuda_ms(call, 3)
                what = name if ring is None else \
                    f"{name} stages {ring[0]} mappers {ring[1]}"
                print(f"[ablation] {label}: {what}: {ms:.3f} ms, "
                      f"{'==' if same else '!='} unmodified bitwise  [{gpu}]",
                      flush=True)
                if not same:
                    return 1
    build.load, K.stream_ring = real_load, real_ring
    return 0


if __name__ == "__main__":
    sys.exit(main())
