"""Ablations of the B1/B2, B3/B4 and B6 designs on one H100: which change moves the time.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 bench_torch/kernel_ablation.py

Each variant is the kernel's source in ``src/repro_torch/kernels/mttkrp/csrc``
with one design choice undone by a text edit, built with the port's nvcc
flags into ``build/ablation/`` (all sources compiled at once) and launched
through the port's own wrapper, on a device-made stream of the nell-2
stand-in's shape (12100 x 9200 x 28800, 76,899,057 uniform nonzeros, seed
0, sorted by the output mode): B1 at blk=512, R=16 (modes 0 and 2) and B2
at R=256; B6 at blk=64, R=16 under Morton order (mode 0), also with the
ring's stages and mapper warps forced; each of B1, B2 and B6 also on
the same factors in bf16 (``-bf16`` cases); B3 at blk=512, R=16 on rows
pre-gathered in fp32 (modes 0, 1, 2) and bf16 (modes 0, 2), and B4 at
R=32 in two 16-column slabs (modes 0, 2), also with the ring's stages and
slots per stage forced, and B4 at R=16 (one slab) on the same rows; beside
each, B3/B4's first design, kept as source text in
``bench_torch/fused_mttkrp_direct.cu``. Every variant's
output must equal the unmodified kernel's bitwise, but for B6's
copies-without-adds and adds-without-copies, whose output must be zeros.
``--cases REGEX`` runs only the cases whose label matches. Prints one line per
variant with its CUDA-event mean time (B3/B4 lines also the HBM TB/s
their bytes take at that time), the mode-2 gap (mode 2 minus mode 0) of
every B3/B4 variant, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
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
    """``source`` (under csrc/, or a path) with each (old, new) replaced;
    each old must occur once."""
    text = open(os.path.join(CSRC, source)).read()
    for old, new in pairs:
        if text.count(old) != 1:
            raise SystemExit(f"ablation edit no longer applies: {old!r}")
        text = text.replace(old, new)
    return text


# B3/B4's copy of a stage's slab of narrower-than-row slices: 2-D tensor
# copies (the kernel), or 16-byte cp.async by the row warp's lanes, each
# lane's copies tracked by the stage's full barrier with no net arrival
# (cp.async.mbarrier.arrive without .noinc) and lane 0 arriving.
TENSOR_COPY = """\
          if (lane32 == 0) {
            const int box = min(slots, kBoxRows);
            mttkrp_common::mbar_arrive_expect_tx(&full[s],
                                                 K * slots * row_bytes);
#pragma unroll
            for (int w = 0; w < K; ++w)
              for (int b = 0; b < slots; b += box)
                tensor_g2s(dst + ((size_t)w * slots + b) * slab,
                           &maps.map[w], sl * slab, (int)i0 + b, &full[s]);
          }
"""
CP_ASYNC_COPY = """\
          const int pieces = row_bytes / 16;
          const int per_w = cnt * pieces;
          const int step = 16 / sizeof(T);
          for (int p = lane32; p < K * per_w; p += 32) {
            const int w = p / per_w;
            const int j = (p - w * per_w) / pieces;
            const int e = (p - w * per_w - j * pieces) * step;
            mttkrp_common::cp_async16(
                dst + ((size_t)w * slots + j) * slab + e,
                rs.ptr[w] + (i0 + j) * ld + (long long)sl * slab + e);
          }
          asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(
                           mttkrp_common::smem_addr(&full[s]))
                       : "memory");
          __syncwarp();
          if (lane32 == 0) mbar_arrive(&full[s]);
"""
B1 = "gather_mttkrp.cu"
B6 = "gather_stream_mttkrp.cu"
B3 = "fused_mttkrp.cu"
# B3/B4's first design (one CTA per tile, rows loaded element by element).
DIRECT = os.path.join(ROOT, "bench_torch/fused_mttkrp_direct.cu")
_P, _I = ctypes.c_void_p, ctypes.c_int
DIRECT_ARGS = ([_P] * 5 + [_P] * 3 + [_I] * 9 + [_P])
DIRECT_NAME = "b3 first design (direct row loads, one CTA per tile)"
B6_COPIES_ONLY = "b6 copies without adds"
B6_ADDS_ONLY = "b6 adds without copies"
# Variants that compute something else on purpose: their output must be
# all zeros (no out_init is passed).
ZERO_VARIANTS = {B6_COPIES_ONLY, B6_ADDS_ONLY}
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
    "b1 kUnroll 16": ("gather_mttkrp", B1,
                      [("constexpr int kUnroll = 4;",
                        "constexpr int kUnroll = 16;")]),
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
    # What sets B6's pace: its copies alone (the consumers wait on each
    # stage and release it, adding nothing), or its adds alone (no tile
    # is copied; the windows are zeroed once, so every product is 0).
    # Both outputs are zeros, which is what they are checked against.
    B6_COPIES_ONLY: (
        "gather_stream_mttkrp", B6,
        [("      if (adds && sl[plan_off + wsum]) {",
          "      if (false) {")]),
    B6_ADDS_ONLY: (
        "gather_stream_mttkrp", B6,
        [("  const int pl = threadIdx.x % 32;\n",
          "  for (size_t e = threadIdx.x;\n"
          "       e < (size_t)stages * win_elems * sizeof(T) / 4;\n"
          "       e += blockDim.x)\n"
          "    reinterpret_cast<int*>(win)[e] = 0;\n"
          "  __syncthreads();\n"
          "  const int pl = threadIdx.x % 32;\n"),
         ("      if (runs[wsum]) {\n        // Entry e",
          "      if (false) {\n        // Entry e")]),
    "b3": ("fused_mttkrp", B3, []),
    DIRECT_NAME: ("fused_mttkrp_direct", DIRECT, []),
    "b3 slabs by 16-byte cp.async (not the 2-D tensor copy)": (
        "fused_mttkrp", B3, [(TENSOR_COPY, CP_ASYNC_COPY)]),
    "b3 one CTA per work item (not persistent)": (
        "fused_mttkrp", B3,
        [("const int grid = (int)min(items, (long long)sms * per_sm);",
          "const int grid = (int)items;")]),
    "b3 tiles in counter order (not the last first)": (
        "fused_mttkrp", B3,
        [("const int t = num_tiles - 1 - item / num_slabs;",
          "const int t = item / num_slabs;")]),
    "b3 padding stages copied too (no skip)": (
        "fused_mttkrp", B3,
        [("if (cv[j] != 0.0f) live |= 1ull << (j >> shift);",
          "live |= 1ull << (j >> shift);")]),
    "b3 kUnroll 8": ("fused_mttkrp", B3,
                     [("constexpr int kUnroll = 4;",
                       "constexpr int kUnroll = 8;")]),
    "b3 kUnroll 2": ("fused_mttkrp", B3,
                     [("constexpr int kUnroll = 4;",
                       "constexpr int kUnroll = 2;")]),
    "b3 meta ring of 2 chunks": (
        "fused_mttkrp", B3,
        [("constexpr int kMetaStages = 4;", "constexpr int kMetaStages = 2;")]),
    "b3 meta chunks of 512 slots": (
        "fused_mttkrp", B3,
        [("constexpr int kMetaChunk = 1024;",
          "constexpr int kMetaChunk = 512;")]),
}
# The bf16 designs of B1/B2 and B6 (variants named "... bf16 ...", run on
# the bf16 cases only): each undoes or varies one choice; the first bf16
# designs undo all. Some also set a wrapper function for their run
# (PATCHES) or force B6's ring (B6_RINGS).
_NO_VEC_ROWS = [("constexpr int kVecMinSlab = 64;",
                 "constexpr int kVecMinSlab = 1 << 30;")]
_COLUMN_READS = [("  constexpr bool kPairReads = sizeof(T) == 2;",
                  "  constexpr bool kPairReads = false;")]
FIRST_B6 = "b6 bf16 first design (a column a lane, 16 lanes, deepest ring)"
VARIANTS.update({
    "b1 bf16 first design (a column a lane at every slab)": (
        "gather_mttkrp", B1, _NO_VEC_ROWS),
    "b1 bf16 16-byte rows at every slab": (
        "gather_mttkrp", B1, [("constexpr int kVecMinSlab = 64;",
                               "constexpr int kVecMinSlab = 16;")]),
    "b1 bf16 16-byte rows at every slab, kUnrollBf16 16": (
        "gather_mttkrp", B1, [("constexpr int kVecMinSlab = 64;",
                               "constexpr int kVecMinSlab = 16;"),
                              ("constexpr int kUnrollBf16 = 8;",
                               "constexpr int kUnrollBf16 = 16;")]),
    "b1 bf16 kUnrollBf16 16": (
        "gather_mttkrp", B1, [("constexpr int kUnrollBf16 = 8;",
                               "constexpr int kUnrollBf16 = 16;")]),
    "b1 bf16 kUnrollBf16 4": (
        "gather_mttkrp", B1, [("constexpr int kUnrollBf16 = 8;",
                               "constexpr int kUnrollBf16 = 4;")]),
    FIRST_B6: ("gather_stream_mttkrp", B6, _COLUMN_READS),
    "b6 bf16 a column a lane (16 lanes)": (
        "gather_stream_mttkrp", B6, _COLUMN_READS),
    "b6 bf16 deepest ring in one CTA": ("gather_stream_mttkrp", B6, []),
    "b6 bf16 8 issuer warps": (
        "gather_stream_mttkrp", B6, [("constexpr int kIssuerWarps = 4;",
                                      "constexpr int kIssuerWarps = 8;")]),
})
_COLUMN_LANES = {"_stream_lanes": lambda slab, gather_itemsize=4:
                 K._lanes(slab)}
_VEC_EVERYWHERE = {"BF16_VEC_MIN_SLAB": 16}
PATCHES = {
    "b1 bf16 first design (a column a lane at every slab)": {
        "BF16_VEC_MIN_SLAB": 1 << 30},
    "b1 bf16 16-byte rows at every slab": _VEC_EVERYWHERE,
    "b1 bf16 16-byte rows at every slab, kUnrollBf16 16": _VEC_EVERYWHERE,
    FIRST_B6: _COLUMN_LANES,
    "b6 bf16 a column a lane (16 lanes)": _COLUMN_LANES,
}
# The deepest ring one bf16 CTA fits (the rule before the two-CTA one),
# at the nell-2 stand-in's mode 0 windows (64, 62).
_ONE_CTA_RING = (5, 8)
# Variants that differ from the unmodified kernel only where the slab is
# narrower than the row: timed on those cases alone.
SLAB_ONLY = {"b3 slabs by 16-byte cp.async (not the 2-D tensor copy)"}
# B6 ring shapes forced through the wrapper per variant: (stages, mapper
# warps); None is the ring the wrapper picks (kernel.stream_ring). A
# shape whose CTA does not fit is reported as not launched.
B6_RINGS = {
    "b6": [None, (3, 8), (2, 8), (1, 8), (2, 4), (1, 4), (3, 2)],
    FIRST_B6: [_ONE_CTA_RING],
    "b6 bf16 deepest ring in one CTA": [_ONE_CTA_RING],
    "b6 bf16 8 issuer warps": [None, _ONE_CTA_RING],
    B6_COPIES_ONLY: [None, _ONE_CTA_RING],
    B6_ADDS_ONLY: [None, _ONE_CTA_RING],
}
# B3/B4 ring shapes forced through the wrapper: (stages, slots per stage);
# (1, 256) is one stage, no overlap of copies and adds. Shapes whose CTA
# does not fit shared memory are skipped. The meta-ring variants run at a
# few of them.
FUSED_RINGS = [(1, 256), (2, 128), (4, 128), (8, 128), (2, 256), (3, 256),
               (4, 256), (2, 512), (4, 512)]
FUSED_VARIANT_RINGS = {"b3": FUSED_RINGS,
                       "b3 meta ring of 2 chunks": [(2, 256), (3, 256),
                                                    (4, 256), (2, 512)],
                       "b3 meta chunks of 512 slots": [(2, 256), (4, 256)]}


def build_variants():
    os.makedirs(OUT, exist_ok=True)
    inc = '#include "mttkrp_common.cuh"'
    procs = {}
    for i, (name, (lib, src, pairs, *hdr)) in enumerate(VARIANTS.items()):
        header = os.path.join(OUT, f"v{i}_common.cuh")
        open(header, "w").write(edit("mttkrp_common.cuh",
                                     hdr[0] if hdr else []))
        text = edit(src, pairs).replace(inc, f'#include "{header}"')
        assert f'#include "{header}"' in text
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
        launch_args = build._LAUNCH_ARGTYPES.get(lib) or {
            "fused_mttkrp_direct_launch": DIRECT_ARGS,
            "fused_mttkrp_direct_bf16_launch": DIRECT_ARGS}
        for fn, argtypes in launch_args.items():
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


def direct_call(lib, vals, pre, rows, tob, *, rows_cap, blk, tile_rows,
                slab):
    """B3/B4's first design through its own launch: one CTA per output
    tile and slab, the same output buffer and block starts."""
    k, rank = len(pre), pre[0].shape[1]
    num_tiles = rows_cap // tile_rows
    blk_start = K._tile_starts(tob, num_tiles)
    out = torch.zeros(rows_cap, rank, device=vals.device)
    ptrs = [r.data_ptr() for r in pre] + [0] * (K.MAX_IN_MODES - k)
    bf16 = pre[0].dtype == torch.bfloat16
    err = getattr(lib, "fused_mttkrp_direct_bf16_launch" if bf16 else
                  "fused_mttkrp_direct_launch")(
        vals.data_ptr(), *ptrs, rows.data_ptr(), blk_start.data_ptr(),
        out.data_ptr(), k, num_tiles, rank // slab, blk, tile_rows, rank,
        slab, K._groups(tile_rows), K._lanes(slab),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit("fused_mttkrp_direct launch failed: "
                         f"{lib.fused_mttkrp_direct_error_string(err)}")
    return out


def bf16_operands(operands):
    """A kernel's operands with the factor matrices (the third) in bf16."""
    return (operands[:2] + (tuple(f.to(torch.bfloat16) for f in operands[2]),)
            + operands[3:])


def fused_hbm_bytes(vals, pre, rows_cap, tile_rows):
    """B3/B4's HBM bytes (chip_smoke.fused_bound_ms's count): per nonzero
    its value, local row and K rows; the block starts; the output."""
    nnz = int((vals != 0).sum())
    k, rank, item = len(pre), pre[0].shape[1], pre[0].element_size()
    return (nnz * (8 + k * rank * item) + (rows_cap // tile_rows + 1) * 4
            + rows_cap * rank * 4)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device", file=sys.stderr)
        return 2
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cases", default="",
                        help="regular expression: run only the cases whose "
                        "label it matches (e.g. 'bf16')")
    wanted = re.compile(parser.parse_args().cases)
    libs = build_variants()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    idx = torch.stack([torch.randint(0, d, (NNZ,), generator=g, device=dev,
                                     dtype=torch.int32) for d in SHAPE], 1)
    val = torch.randn(NNZ, generator=g, device=dev)
    valid = torch.ones(NNZ, dtype=torch.bool, device=dev)
    f16 = [torch.randn(d, 16, generator=g, device=dev) for d in SHAPE]
    f32 = [torch.randn(d, 32, generator=g, device=dev) for d in SHAPE]
    f256 = [torch.randn(d, 256, generator=g, device=dev) for d in SHAPE]
    real_load, real_ring = build.load, K.stream_ring
    real_fused_ring = K.fused_ring
    times = {}  # (label, variant) -> ms

    def run_case(label, prefix, call, fused=None, only=None):
        """Every variant of ``prefix`` on ``call`` (``only``: those
        named), each == the unmodified kernel bitwise. ``fused``: (vals,
        pre, rows, tob, kw, slab) of a B3/B4 case, for the first design
        and the forced rings. Cases ``--cases`` does not match are
        skipped."""
        if not wanted.search(label):
            return True
        build.load = lambda name, h=libs[prefix]: h
        want = call()
        hbm = fused_hbm_bytes(fused[0], fused[1], fused[4]["rows_cap"],
                              fused[4]["tile_rows"]) if fused else None
        for name, handle in libs.items():
            if not name.startswith(prefix + " ") and name != prefix:
                continue
            if only is not None and name not in only:
                continue
            if " bf16 " in name and "bf16" not in label:
                continue
            if name in SLAB_ONLY and (fused is None
                                      or fused[5] == fused[1][0].shape[1]):
                continue
            if prefix == "b6":
                rings = B6_RINGS.get(name, [None])
            elif name in FUSED_VARIANT_RINGS and only is None:
                rings = [None] + FUSED_VARIANT_RINGS[name]
            else:
                rings = [None]
            for ring in rings:
                if VARIANTS[name][0] == "fused_mttkrp_direct":
                    vals, pre, rows, tob, kw, slab = fused

                    def fn(h=handle):
                        return direct_call(h, vals, pre, rows, tob,
                                           slab=slab, **kw)
                    what = name
                else:
                    build.load = lambda n, h=handle: h
                    fn = call
                    if prefix == "b6":
                        K.stream_ring = (real_ring if ring is None else
                                         (lambda *a, r=ring, **k: r))
                        what = name if ring is None else \
                            f"{name} stages {ring[0]} mappers {ring[1]}"
                    else:
                        if ring is not None:
                            vals, pre, _, _, kw, slab = fused
                            if K.fused_smem_bytes(
                                    len(pre), pre[0].shape[1],
                                    kw["tile_rows"], rank_slab=slab,
                                    stages=ring[0], slots=ring[1],
                                    gather_itemsize=pre[0].element_size()) \
                                    > K.SMEM_LIMIT_BYTES:
                                continue
                        K.fused_ring = (real_fused_ring if ring is None else
                                        (lambda *a, r=ring, **k: r))
                        if ring is None and fused:
                            vals, pre, _, _, kw, slab = fused
                            ring = real_fused_ring(
                                len(pre), pre[0].shape[1], kw["tile_rows"],
                                rank_slab=slab,
                                gather_itemsize=pre[0].element_size())
                            what = f"{name} (stages {ring[0]} slots " \
                                f"{ring[1]})"
                        else:
                            what = name if ring is None else \
                                f"{name} stages {ring[0]} slots {ring[1]}"
                saved = {a: getattr(K, a) for a in PATCHES.get(name, {})}
                for a, value in PATCHES.get(name, {}).items():
                    setattr(K, a, value)
                try:
                    got = fn()
                except RuntimeError as exc:  # a refused launch is a result
                    print(f"[ablation] {label}: {what}: not launched "
                          f"({exc})  [{gpu}]", flush=True)
                    K.stream_ring, K.fused_ring = real_ring, real_fused_ring
                    continue
                finally:
                    for a, value in saved.items():
                        setattr(K, a, value)
                if name in ZERO_VARIANTS:
                    same = torch.equal(got, torch.zeros_like(got))
                    check = f"{'==' if same else '!='} zeros (as it must)"
                else:
                    same = torch.equal(got, want)
                    check = f"{'==' if same else '!='} unmodified bitwise"
                for a, value in PATCHES.get(name, {}).items():
                    setattr(K, a, value)
                try:
                    ms = cuda_ms(fn, 3)
                finally:
                    for a, value in saved.items():
                        setattr(K, a, value)
                times[(label, what)] = ms
                rate = f", {hbm / ms / 1e9:.3f} TB/s" if hbm else ""
                print(f"[ablation] {label}: {what}: {ms:.3f} ms{rate}, "
                      f"{check}  [{gpu}]", flush=True)
                K.stream_ring, K.fused_ring = real_ring, real_fused_ring
                if not same:
                    return False
        return True

    ok = True
    for mode in (0, 1, 2):
        order = torch.sort(idx[:, mode], stable=True).indices
        si, sv = idx[order].contiguous(), val[order].contiguous()
        del order
        rows_cap = -(-SHAPE[mode] // 8) * 8
        kw = dict(rows_cap=rows_cap, blk=512, tile_rows=8)
        o16 = ops.gather_operands(si, sv, valid, f16, mode=mode, row_offset=0,
                                  slab=16, **kw)
        if mode != 1:
            ok &= run_case(f"B1 mode {mode}", "b1",
                           lambda o=o16, kw=kw:
                           K.fused_mttkrp_nmode_gather(*o, **kw))
            ok &= run_case(f"B1-bf16 mode {mode}", "b1",
                           lambda o=bf16_operands(o16), kw=kw:
                           K.fused_mttkrp_nmode_gather(*o, **kw))
        # B3 on rows pre-gathered in fp32 (every mode) and bf16.
        vals, ia, fm, rows, tob = o16
        for dtype in (torch.float32, torch.bfloat16):
            if dtype == torch.bfloat16 and mode == 1:
                continue
            tag = "" if dtype == torch.float32 else "-bf16"
            if not (wanted.search(f"B3{tag} mode {mode}")
                    or wanted.search(f"B4{tag} mode {mode}")):
                continue
            pre = ops.pregathered_rows(ia, [f.to(dtype) for f in fm])
            ok &= run_case(f"B3{tag} mode {mode}", "b3",
                           lambda p=pre: K.fused_mttkrp_nmode(
                               vals, p, rows, tob, **kw),
                           fused=(vals, pre, rows, tob, kw, 16))
            # B4 at R=16 (one 16-column slab: B3's path), beside the
            # first design.
            ok &= run_case(f"B4{tag} mode {mode}", "b3",
                           lambda p=pre: K.fused_mttkrp_nmode_tiled(
                               vals, p, rows, tob, rank_slab=16, **kw),
                           fused=(vals, pre, rows, tob, kw, 16),
                           only=("b3", DIRECT_NAME))
            del pre
        del o16, vals, ia, fm, rows, tob
        if mode != 1 and wanted.search(f"B4 R=32 mode {mode}"):
            # B4 at R=32 in two 16-column slabs (a slab narrower than the
            # row: the 2-D tensor copy, or cp.async).
            o32 = ops.gather_operands(si, sv, valid, f32, mode=mode,
                                      row_offset=0, slab=32, **kw)
            vals, ia, fm, rows, tob = o32
            pre = ops.pregathered_rows(ia, fm)
            del o32, ia, fm
            ok &= run_case(f"B4 R=32 mode {mode}", "b3",
                           lambda: K.fused_mttkrp_nmode_tiled(
                               vals, pre, rows, tob, rank_slab=16, **kw),
                           fused=(vals, pre, rows, tob, kw, 16))
            del vals, pre, rows, tob
        torch.cuda.empty_cache()
        if mode == 0:
            o256 = ops.gather_operands(si, sv, valid, f256, mode=mode,
                                       row_offset=0, slab=128, **kw)
            ok &= run_case("B2 R=256 mode 0", "b1",
                           lambda o=o256, kw=kw:
                           K.fused_mttkrp_nmode_gather_tiled(
                               *o, rank_slab=128, **kw))
            ok &= run_case("B2-bf16 R=256 mode 0", "b1",
                           lambda o=bf16_operands(o256), kw=kw:
                           K.fused_mttkrp_nmode_gather_tiled(
                               *o, rank_slab=128, **kw))
            del o256
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
            ok &= run_case(f"B6 mode 0 windows {windows}", "b6",
                           lambda s=s_ops, kw=skw:
                           K.fused_mttkrp_nmode_gather_stream(*s, **kw))
            ok &= run_case(f"B6-bf16 mode 0 windows {windows}", "b6",
                           lambda s=bf16_operands(s_ops), kw=skw:
                           K.fused_mttkrp_nmode_gather_stream(*s, **kw))
            del ri, rv, rva, vals, ia, fm, rows, tob, scheds, s_ops
        del si, sv
        torch.cuda.empty_cache()
        if not ok:
            break
    build.load = real_load
    for tag in ("B3", "B3-bf16", "B4", "B4-bf16", "B4 R=32"):
        for (label, what), ms0 in times.items():
            if label != f"{tag} mode 0":
                continue
            ms2 = times.get((f"{tag} mode 2", what))
            if ms2 is not None:
                print(f"[ablation] {tag} mode-2 gap: {what}: "
                      f"{ms2 - ms0:+.3f} ms (mode 0 {ms0:.3f}, mode 2 "
                      f"{ms2:.3f})  [{gpu}]", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
