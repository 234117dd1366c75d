// Device code shared by the in-kernel-gather kernels (gather_mttkrp.cu,
// gather_stream_mttkrp.cu): the factor set passed by value, the fixed-order
// reduction of a CTA's private partial tiles, and the opt-in to more than
// 48 KB of dynamic shared memory. Both kernels add in one order, and this
// epilogue is the last step of it, so B1 == B2 == B6 bitwise.
#pragma once

#include <cuda_runtime.h>

namespace mttkrp_common {

constexpr int kMaxInModes = 4;

// The K input-factor matrices (row-major, `ld` floats per row) and their
// row counts, passed to a kernel by value.
struct FactorSet {
  const float* ptr[kMaxInModes];
  int rows[kMaxInModes];
};

inline FactorSet make_factor_set(const void* f0, const void* f1,
                                 const void* f2, const void* f3, int rows0,
                                 int rows1, int rows2, int rows3) {
  FactorSet fs;
  const void* ptrs[kMaxInModes] = {f0, f1, f2, f3};
  const int rows[kMaxInModes] = {rows0, rows1, rows2, rows3};
  for (int w = 0; w < kMaxInModes; ++w) {
    fs.ptr[w] = static_cast<const float*>(ptrs[w]);
    fs.rows[w] = rows[w];
  }
  return fs;
}

// Sum the `groups` partial tiles (each tile_rows x slab, row-major, one
// after the other in `part`) in the fixed order 0..groups-1 and add the
// sum to the output tile at `tile_out` (row stride `ld`).
__device__ __forceinline__ void reduce_partials_into(const float* part,
                                                     int groups,
                                                     int tile_elems, int slab,
                                                     float* tile_out,
                                                     long long ld) {
  for (int e = threadIdx.x; e < tile_elems; e += blockDim.x) {
    float acc = part[e];
    for (int q = 1; q < groups; ++q)
      acc = __fadd_rn(acc, part[(size_t)q * tile_elems + e]);
    float* o = tile_out + (long long)(e / slab) * ld + (e % slab);
    *o = __fadd_rn(*o, acc);
  }
}

// A launch above 48 KB of dynamic shared memory needs this opt-in first.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace mttkrp_common
