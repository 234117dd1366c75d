"""L2 -> shared-memory copy rate of random 512- and 256-byte tiles, and the
rate of random row reads, on one H100.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 bench_torch/copy_rate.py

The question it answers for the stream kernel (B6): how fast can a CTA
fill shared memory with factor tiles (8 rows x 16 elements: 512 B in fp32,
256 B in bf16) picked at random from an L2-resident factor (2 MiB), and
how many warps must issue the copies? Each CTA runs 200 rounds; a round
copies 48 KB of random tiles (96 of 512 B, 192 of 256 B: a B6 window's
size) and waits for them. Mechanisms: one bulk copy (the TMA's 1-D form)
per tile, issued by the lanes of the first `wi` warps, waited on an
mbarrier (`bulk`); the same with two buffers, round r+1 issued before
round r is waited (`bulk x2`); 16-byte `cp.async`, the 32 lanes of a warp
moving one 512-byte tile or two 256-byte tiles per instruction, waited
with `cp.async.wait_group` (`cp.async`); the same double-buffered, each
issuing thread's copies completing on the round's mbarrier through
`cp.async.mbarrier.arrive.noinc`, as B6's bf16 ring fills a stage
(`cp.async x2`). CTAs of 512 threads, 1, 2 or 4 per SM. Prints the rate
(tile bytes over CUDA-event time) and tiles per second per configuration,
and the card's name and power limit.

Then the question it answers for B1/B2: how many random rows a second
can an SM's threads read out of L2 (a 4 MiB buffer), by row size (32 B:
a bf16 row at R=16; 64 B: an fp32 one) and by the width each lane loads
(2 B: a bf16 column a lane, as B1-bf16; 4 B: an fp32 column a lane, as
B1; 16 B: as the bf16 16-byte row loads), with 8 rows a lane in flight,
CTAs of 256 threads, 4, 8 or 16 an SM (`gather` lines: G rows/s and
TB/s).

Then the rows-in-flight ceiling for B1-bf16 at R=16 (`rows` lines): random
32-byte rows (a bf16 row at R=16), two lanes a row, 16 bytes a lane, read
out of L2 (a 4 MiB buffer; row ids from a hash, so no id stream competes),
either into registers (`ld.global.nc`, as gather_mttkrp_narrow_kernel
loads them) or into shared memory with `cp.async` (what a ring of staged
rows would do), in rounds: a CTA issues all of a round's rows, then waits
for them. CTAs of 1, 2, 4, 8 or 16 an SM, 640 to 4096 rows in flight an SM
(the CTA's warps times 16 rows times P rows a lane pair; a combination no
CTA shape gives is skipped). Prints G rows/s and TB/s per configuration.
The kernels below are measurements, not part of the port.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels.mttkrp import build  # noqa: E402

SOURCE = r"""
#include "@COMMON@"
using namespace mttkrp_common;
// Each CTA: `iters` rounds; each round copies `n` random tiles of `tb`
// bytes (tile ids from `ids`) into shared memory and waits for them.
// mode 0: bulk copy per tile, issued by lanes of the first `wi` warps.
// mode 1: cp.async 16 B, a warp moving 512 / tb tiles per
//         instruction, the first `wi` warps; cp.async.wait_group.
// mode 2: bulk copies, double-buffered: round r+1 issued before waiting r.
// mode 3: as mode 1, double-buffered, completion on the round's mbarrier
//         by cp.async.mbarrier.arrive.noinc from every issuing thread.
__global__ void copy_kernel(int mode, const float* src, const int* ids,
                            int n, int iters, int wi, int tb, float* sink) {
  extern __shared__ float4 sm4[];
  float* sm = (float*)sm4;
  __shared__ unsigned long long bar[2];
  const int tf = tb / 4;               // floats per tile
  const int pieces = tb / 16;          // 16-byte pieces per tile
  const int per_warp = 32 / pieces;    // tiles one warp instruction moves
  if (threadIdx.x == 0) {
    const unsigned count = mode == 3 ? wi * 32 : 1;
    mbar_init(&bar[0], count);
    mbar_init(&bar[1], count);
    mbar_init_fence();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* my = ids + (size_t)blockIdx.x * iters * n;
  float acc = 0;
  auto issue = [&](int r, int buf) {
    float* dst0 = sm + (size_t)buf * n * tf;
    if (warp < wi) {
      if (threadIdx.x == 0) mbar_expect_tx(&bar[buf], n * tb);
      __syncwarp();
      for (int j = warp * 32 + lane; j < n; j += wi * 32)
        bulk_g2s(dst0 + j * tf, src + (size_t)my[r * n + j] * tf, tb,
                 &bar[buf]);
    }
    __syncthreads();
    if (threadIdx.x == 0) mbar_arrive(&bar[buf]);
  };
  auto issue_async = [&](int r, int buf) {
    float* dst0 = sm + (size_t)buf * n * tf;
    if (warp < wi) {
      const int sub = lane / pieces, piece = lane % pieces;
      for (int j = warp * per_warp + sub; j < n; j += wi * per_warp)
        cp_async16(dst0 + j * tf + piece * 4,
                   src + (size_t)my[r * n + j] * tf + piece * 4);
    }
  };
  for (int r = 0; r < iters; ++r) {
    if (mode == 0) {
      issue(r, 0);
      mbar_wait(&bar[0], r & 1);
    } else if (mode == 2) {
      if (r == 0) issue(0, 0);
      if (r + 1 < iters) issue(r + 1, (r + 1) & 1);
      mbar_wait(&bar[r & 1], (r >> 1) & 1);
    } else if (mode == 3) {
      auto post = [&](int rr) {
        issue_async(rr, rr & 1);
        if (warp < wi) cp_async_mbar_arrive_noinc(&bar[rr & 1]);
      };
      if (r == 0) post(0);
      if (r + 1 < iters) post(r + 1);
      mbar_wait(&bar[r & 1], (r >> 1) & 1);
    } else {
      issue_async(r, 0);
      cp_async_commit();
      cp_async_wait_all();
    }
    __syncthreads();
    acc += sm[(size_t)(r & 1) * (mode >= 2 ? n * tf : 0) +
              (threadIdx.x * 7) % (n * tf)];
    __syncthreads();
  }
  if (acc == 12345.0f) sink[0] = acc;
}
// Random rows of `rb` bytes, each read by rb / W lanes of W bytes
// (ld.global.nc); a lane keeps 8 rows in flight; `iters` rounds.
template <int W>
struct Piece;
template <> struct Piece<2> { using T = unsigned short; };
template <> struct Piece<4> { using T = unsigned; };
template <> struct Piece<16> { using T = uint4; };
__device__ __forceinline__ unsigned fold(unsigned short x) { return x; }
__device__ __forceinline__ unsigned fold(unsigned x) { return x; }
__device__ __forceinline__ unsigned fold(uint4 x) {
  return x.x ^ x.y ^ x.z ^ x.w;
}
template <int W>
__global__ void gather_kernel(const void* src, const int* ids, int rb,
                              int nslots, int iters, float* sink) {
  using P = typename Piece<W>::T;
  const P* rows = static_cast<const P*>(src);
  const int per = rb / W;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int slot = t / per, piece = t % per;
  if (slot >= nslots) return;
  unsigned acc = 0;
  for (int i = 0; i < iters; ++i) {
    const int* id = ids + ((size_t)i * nslots + slot) * 8;
    P x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = __ldg(rows + (size_t)id[u] * per + piece);
#pragma unroll
    for (int u = 0; u < 8; ++u) acc ^= fold(x[u]);
  }
  if (acc == 0x12345678u) sink[0] = 1.0f;
}
// Random 32-byte rows, two lanes a row (16 bytes each), P rows a lane pair
// per round: into registers (mode 0) or into shared memory by cp.async
// (mode 1); `rounds` rounds, each waited for before the next. Row ids are
// a hash of (CTA, round, row) over `nrows` rows.
template <int P>
__global__ void rows_kernel(int mode, const uint4* __restrict__ src,
                            int nrows, int rounds, float* sink) {
  extern __shared__ uint4 rs[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = lane & 1, r16 = lane >> 1;
  const int per_cta = blockDim.x / 2 * P;
  unsigned acc = 0;
  for (int r = 0; r < rounds; ++r) {
    unsigned id[P];
#pragma unroll
    for (int u = 0; u < P; ++u) {
      unsigned h = (blockIdx.x * 0x9e3779b1u) ^ (r * 0x85ebca77u) ^
                   (((warp * P + u) * 16 + r16) * 0xc2b2ae3du);
      h ^= h >> 15;
      h *= 0x2c1b3c6du;
      h ^= h >> 12;
      id[u] = h % (unsigned)nrows;
    }
    if (mode == 0) {
      uint4 x[P];
#pragma unroll
      for (int u = 0; u < P; ++u) x[u] = __ldg(src + (size_t)id[u] * 2 + half);
#pragma unroll
      for (int u = 0; u < P; ++u) acc ^= x[u].x ^ x[u].w;
    } else {
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const int row = (warp * P + u) * 16 + r16;
        cp_async16(rs + row * 2 + half, src + (size_t)id[u] * 2 + half);
      }
      cp_async_commit();
      cp_async_wait_all();
      __syncwarp();
      acc ^= reinterpret_cast<const unsigned*>(
          rs)[(warp * P * 16 * 8 + lane * 7 + r) % (per_cta * 8)];
      __syncwarp();
    }
  }
  if (acc == 0x12345678u) sink[0] = 1.0f;
}
extern "C" int rows_run(int mode, int p, const void* src, int nrows,
                        int rounds, int ctas, int threads, void* sink) {
  const size_t smem = mode == 1 ? (size_t)threads / 2 * p * 32 : 0;
  const uint4* s = static_cast<const uint4*>(src);
  float* k = static_cast<float*>(sink);
#define ROWS(PP)                                                          \
  cudaFuncSetAttribute(rows_kernel<PP>,                                   \
                       cudaFuncAttributeMaxDynamicSharedMemorySize,       \
                       (int)smem);                                        \
  rows_kernel<PP><<<ctas, threads, smem>>>(mode, s, nrows, rounds, k);
  switch (p) {
    case 1: ROWS(1) break;
    case 2: ROWS(2) break;
    case 4: ROWS(4) break;
    case 8: ROWS(8) break;
    case 16: ROWS(16) break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef ROWS
  return cudaGetLastError();
}
extern "C" int gather_run(int w, const void* src, const void* ids, int rb,
                          int nslots, int iters, int ctas, int threads,
                          void* sink) {
  if (w == 2)
    gather_kernel<2><<<ctas, threads>>>(src, (const int*)ids, rb, nslots,
                                        iters, (float*)sink);
  else if (w == 4)
    gather_kernel<4><<<ctas, threads>>>(src, (const int*)ids, rb, nslots,
                                        iters, (float*)sink);
  else
    gather_kernel<16><<<ctas, threads>>>(src, (const int*)ids, rb, nslots,
                                         iters, (float*)sink);
  return cudaGetLastError();
}
extern "C" int copy_run(int mode, const void* src, const void* ids, int n,
                        int iters, int wi, int tb, int ctas, int threads,
                        void* sink) {
  size_t smem = (size_t)(mode >= 2 ? 2 : 1) * n * tb;
  cudaFuncSetAttribute(copy_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  copy_kernel<<<ctas, threads, smem>>>(mode, (const float*)src,
                                       (const int*)ids, n, iters, wi, tb,
                                       (float*)sink);
  return cudaGetLastError();
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("copy_rate: no CUDA device", file=sys.stderr)
        return 2
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    out = os.path.join(ROOT, "build/copy_rate")
    os.makedirs(out, exist_ok=True)
    common = os.path.join(ROOT, "src/repro_torch/kernels/mttkrp/csrc/"
                          "mttkrp_common.cuh")
    cu, so = os.path.join(out, "copy_rate.cu"), os.path.join(out,
                                                             "copy_rate.so")
    open(cu, "w").write(SOURCE.replace("@COMMON@", common))
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, cu],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    run = lib.copy_run
    P, I = ctypes.c_void_p, ctypes.c_int
    run.argtypes = [I, P, P, I, I, I, I, I, I, P]
    run.restype = I
    dev = torch.device("cuda")
    src = torch.randn(2 ** 19, device=dev)          # 2 MiB: L2-resident
    sink = torch.zeros(1, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    names = {0: "bulk", 2: "bulk x2", 1: "cp.async", 3: "cp.async x2"}
    iters = 200
    for tb in (512, 256):
        ntiles, n = src.numel() * 4 // tb, 48 * 1024 // tb
        for mode in (0, 2, 1, 3):
            for per_sm in (1, 2, 4):
                for wi in ((1, 4, 8) if mode in (0, 2) else (4, 8, 16)):
                    ctas = sms * per_sm
                    ids = torch.randint(0, ntiles, (ctas * iters * n,),
                                        device=dev, dtype=torch.int32)
                    args = (mode, src.data_ptr(), ids.data_ptr(), n, iters,
                            wi, tb, ctas, 512, sink.data_ptr())
                    if run(*args) != 0:
                        print(f"copy_rate: launch failed ({names[mode]}, "
                              f"{tb} B)", file=sys.stderr)
                        return 1
                    torch.cuda.synchronize()
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    run(*args)
                    b.record()
                    b.synchronize()
                    ms = a.elapsed_time(b)
                    tiles = ctas * iters * n
                    print(f"[copy] {tb} B tiles, {names[mode]}: {wi} issuing "
                          f"warps, {per_sm} CTA/SM: "
                          f"{tiles * tb / ms / 1e9:.3f} TB/s, "
                          f"{tiles / ms / 1e6:.3f} G tiles/s "
                          f"({ms * 1e3 / iters:.2f} us per {n}-tile round)  "
                          f"[{gpu}]", flush=True)
    grun = lib.gather_run
    grun.argtypes = [I, P, P, I, I, I, I, I, P]
    grun.restype = I
    buf = torch.randint(0, 2 ** 15, (2 ** 21,), device=dev,
                        dtype=torch.int16)          # 4 MiB: L2-resident
    iters = 16
    for rb, width in ((32, 2), (32, 16), (64, 4), (64, 16)):
        for per_sm in (4, 8, 16):
            ctas, threads = sms * per_sm, 256
            nslots = ctas * threads // (rb // width)
            ids = torch.randint(0, buf.numel() * 2 // rb,
                                (iters * nslots * 8,), device=dev,
                                dtype=torch.int32)
            args = (width, buf.data_ptr(), ids.data_ptr(), rb, nslots,
                    iters, ctas, threads, sink.data_ptr())
            if grun(*args) != 0:
                print(f"copy_rate: gather launch failed ({rb} B, {width} B "
                      "loads)", file=sys.stderr)
                return 1
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            grun(*args)
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b)
            rows = iters * nslots * 8
            print(f"[gather] random {rb} B rows, {width} B a lane "
                  f"({rb // width} lanes a row), {per_sm} CTA/SM: "
                  f"{rows / ms / 1e6:.3f} G rows/s, "
                  f"{rows * rb / ms / 1e9:.3f} TB/s  [{gpu}]", flush=True)
            del ids
    rrun = lib.rows_run
    rrun.argtypes = [I, I, P, I, I, I, I, P]
    rrun.restype = I
    rounds, nrows = 64, buf.numel() * 2 // 32
    for in_flight in (640, 1024, 2048, 4096):
        for per_sm in (1, 2, 4, 8, 16):
            shape = _rows_shape(in_flight // per_sm)
            if shape is None or in_flight % per_sm:
                print(f"[rows] {in_flight} rows in flight an SM, {per_sm} "
                      "CTA/SM: no CTA shape gives it, skipped", flush=True)
                continue
            warps, p = shape
            for mode, name in ((0, "registers"), (1, "cp.async to smem")):
                ctas = sms * per_sm
                args = (mode, p, buf.data_ptr(), nrows, rounds, ctas,
                        32 * warps, sink.data_ptr())
                if rrun(*args) != 0:
                    print(f"copy_rate: rows launch failed ({name}, {warps} "
                          f"warps, P={p})", file=sys.stderr)
                    return 1
                torch.cuda.synchronize()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                rrun(*args)
                b.record()
                b.synchronize()
                ms = a.elapsed_time(b)
                rows = ctas * rounds * 16 * warps * p
                print(f"[rows] random 32 B rows into {name}: {in_flight} "
                      f"in flight an SM, {per_sm} CTA/SM ({warps} warps x "
                      f"16 rows x {p}): {rows / ms / 1e6:.3f} G rows/s, "
                      f"{rows * 32 / ms / 1e9:.3f} TB/s  [{gpu}]", flush=True)
    return 0


def _rows_shape(per_cta: int):
    """``(warps, P)`` of a CTA holding ``per_cta`` rows in flight (16 a
    warp per P), the most rows a lane pair first; ``None`` if none."""
    for p in (16, 8, 4, 2, 1):
        if per_cta % (16 * p) == 0 and 1 <= per_cta // (16 * p) <= 32:
            return per_cta // (16 * p), p
    return None


if __name__ == "__main__":
    sys.exit(main())
