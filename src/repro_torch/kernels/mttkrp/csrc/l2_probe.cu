// L2 read-rate probe for Hopper (sm_90a): a yardstick, not a kernel of any
// path of the port, and no TPU kernel's counterpart.
//
// chip_smoke.py times it to turn the L2 bytes that B1, B2 and B6 move (the
// factor rows they gather, the factor tiles B6 copies) into an L2 bound,
// the least time the card's L2 could serve them in. Each pass reads a
// buffer small enough to stay in the 50 MB L2 (the caller passes 16 MiB)
// with 16-byte loads that bypass L1 (ld.global.cg), `passes` times over;
// the rate is passes * bytes over the CUDA-event time of one launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ../build.py); bound with ctypes.

#include <cuda_runtime.h>

namespace {

__global__ void l2_read_kernel(const float4* __restrict__ buf, long long n4,
                               int passes, float* __restrict__ sink) {
  float acc = 0.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int p = 0; p < passes; ++p) {
#pragma unroll 4
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n4; i += stride) {
      const float4 v = __ldcg(buf + i);
      acc += (v.x + v.y) + (v.z + v.w);
    }
  }
  if (acc == 1.2345e-30f) *sink = acc;  // keeps the loads; never true
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int l2_read_launch(const void* buf, long long n4, int passes,
                              int blocks, int threads, void* sink,
                              void* stream) {
  l2_read_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(buf), n4, passes, static_cast<float*>(sink));
  return (int)cudaGetLastError();
}

extern "C" const char* l2_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
