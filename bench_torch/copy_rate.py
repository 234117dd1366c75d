"""L2 -> shared-memory copy rate of random 512-byte tiles on one H100.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 bench_torch/copy_rate.py

The question it answers for the stream kernel (B6): how fast can a CTA
fill shared memory with factor tiles (8 rows x 16 floats, 512 B) picked
at random from an L2-resident factor (2 MiB), and how many warps must
issue the copies? Each CTA runs 200 rounds; a round copies 96 random
tiles (48 KB, a B6 window's size) and waits for them. Mechanisms: one
bulk copy (the TMA's 1-D form) per tile, issued by the lanes of the
first `wi` warps, waited on an mbarrier (`bulk`); the same with two
buffers, round r+1 issued before round r is waited (`bulk x2`); 16-byte
`cp.async`, a warp per tile (`cp.async`). CTAs of 512 threads, 1, 2 or
4 per SM. Prints the rate (tile bytes over CUDA-event time) per
configuration, and the card's name and power limit. The kernel below is
a measurement, not part of the port.
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
// Each CTA: `iters` rounds; each round copies `n` random 512-byte tiles
// (tile ids from `ids`) into shared memory and waits for them.
// mode 0: bulk copy per tile, issued by lanes of the first `wi` warps.
// mode 1: cp.async 16 B, warp per tile, the first `wi` warps.
// mode 2: bulk copies, double-buffered: round r+1 issued before waiting r.
__global__ void copy_kernel(int mode, const float* src, const int* ids,
                            int n, int iters, int wi, float* sink) {
  extern __shared__ float4 sm4[];
  float* sm = (float*)sm4;
  __shared__ unsigned long long bar[2];
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_init_fence();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* my = ids + (size_t)blockIdx.x * iters * n;
  float acc = 0;
  auto issue = [&](int r, int buf) {
    float* dst0 = sm + (size_t)buf * n * 128;
    if (warp < wi) {
      if (threadIdx.x == 0) mbar_expect_tx(&bar[buf], n * 512);
      __syncwarp();
      for (int j = warp * 32 + lane; j < n; j += wi * 32)
        bulk_g2s(dst0 + j * 128, src + (size_t)my[r * n + j] * 128, 512,
                 &bar[buf]);
    }
    __syncthreads();
    if (threadIdx.x == 0) mbar_arrive(&bar[buf]);
  };
  for (int r = 0; r < iters; ++r) {
    if (mode == 0) {
      issue(r, 0);
      mbar_wait(&bar[0], r & 1);
    } else if (mode == 2) {
      if (r == 0) issue(0, 0);
      if (r + 1 < iters) issue(r + 1, (r + 1) & 1);
      mbar_wait(&bar[r & 1], (r >> 1) & 1);
    } else {
      if (warp < wi)
        for (int j = warp; j < n; j += wi) {
          const float* s = src + (size_t)my[r * n + j] * 128;
          cp_async16(sm + j * 128 + lane * 4, s + lane * 4);
        }
      cp_async_commit();
      cp_async_wait_all();
    }
    __syncthreads();
    acc += sm[(threadIdx.x * 7) % (n * 128)];
    __syncthreads();
  }
  if (acc == 12345.0f) sink[0] = acc;
}
extern "C" int copy_run(int mode, const void* src, const void* ids, int n,
                        int iters, int wi, int ctas, int threads, void* sink) {
  size_t smem = (size_t)(mode == 2 ? 2 : 1) * n * 512;
  cudaFuncSetAttribute(copy_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  copy_kernel<<<ctas, threads, smem>>>(mode, (const float*)src,
                                       (const int*)ids, n, iters, wi,
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
    run.argtypes = [I, P, P, I, I, I, I, I, P]
    run.restype = I
    dev = torch.device("cuda")
    ntiles = 4096                      # 2 MiB of tiles: L2-resident
    src = torch.randn(ntiles * 128, device=dev)
    sink = torch.zeros(1, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    names = {0: "bulk", 2: "bulk x2", 1: "cp.async"}
    n, iters = 96, 200
    for mode in (0, 2, 1):
        for per_sm in (1, 2, 4):
            for wi in ((1, 4, 8) if mode != 1 else (4, 8, 16)):
                ctas = sms * per_sm
                ids = torch.randint(0, ntiles, (ctas * iters * n,),
                                    device=dev, dtype=torch.int32)
                args = (mode, src.data_ptr(), ids.data_ptr(), n, iters, wi,
                        ctas, 512, sink.data_ptr())
                if run(*args) != 0:
                    print(f"copy_rate: launch failed ({names[mode]})",
                          file=sys.stderr)
                    return 1
                torch.cuda.synchronize()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                run(*args)
                b.record()
                b.synchronize()
                ms = a.elapsed_time(b)
                rate = ctas * iters * n * 512 / ms / 1e9
                print(f"[copy] {names[mode]}: {wi} issuing warps, {per_sm} "
                      f"CTA/SM: {rate:.3f} TB/s ({ms * 1e3 / iters:.2f} us "
                      f"per 96-tile round)  [{gpu}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
