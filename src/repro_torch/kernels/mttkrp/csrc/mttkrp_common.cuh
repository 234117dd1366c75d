// Device code shared by the spMTTKRP kernels (gather_mttkrp.cu: B1, B2;
// gather_stream_mttkrp.cu: B6; fused_mttkrp.cu: B3, B4, B5): the factor set
// passed by value, the loads that turn a factor element (float or bf16)
// into fp32, the per-group product-and-add of a batch of slots, the
// fixed-order reduction of a CTA's private partial tiles (and its variant
// for warp-specialized CTAs, which clears them), cp.async, bulk copies and
// mbarriers, the opt-in to more than 48 KB of dynamic shared memory, and
// the end of the last tile's live run that B1, B2 and B6 stop at
// (live_end_kernel, run_end).
// Every kernel
// adds in one order and ends with the same epilogue, so B1 == B2 == B3 ==
// B4 == B5 == B6 bitwise on one aligned stream, and likewise the bf16
// variants of B1, B2, B3, B4 and B6 among themselves.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mttkrp_common {

constexpr int kMaxInModes = 4;

// The K input-factor matrices (row-major, `ld` elements of type T per row;
// T is float, or __nv_bfloat16 for the bf16 gathers) and their row counts,
// passed to a kernel by value.
template <typename T>
struct FactorSet {
  const T* ptr[kMaxInModes];
  int rows[kMaxInModes];
};

template <typename T>
inline FactorSet<T> make_factor_set(const void* f0, const void* f1,
                                    const void* f2, const void* f3,
                                    int rows0, int rows1, int rows2,
                                    int rows3) {
  FactorSet<T> fs;
  const void* ptrs[kMaxInModes] = {f0, f1, f2, f3};
  const int rows[kMaxInModes] = {rows0, rows1, rows2, rows3};
  for (int w = 0; w < kMaxInModes; ++w) {
    fs.ptr[w] = static_cast<const T*>(ptrs[w]);
    fs.rows[w] = rows[w];
  }
  return fs;
}

// A factor element as fp32. A bf16 is the upper half of an fp32, so the
// conversion is exact: it is taken as soon as the element is loaded, and
// every product and sum after it is the fp32 kernel's.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __uint_as_float(
      static_cast<unsigned>(__bfloat16_as_ushort(x)) << 16);
}

// The same, loaded from global memory through the read-only path.
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const __nv_bfloat16* p) {
  return __uint_as_float(
      static_cast<unsigned>(
          __ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
}

// Two and eight adjacent bf16 elements, as loaded in one 4-byte or one
// 16-byte read (the first element in the low half), as fp32: exact, as
// to_f32 is.
__device__ __forceinline__ void bf16x2_to_f32(unsigned x, float& lo,
                                              float& hi) {
  lo = __uint_as_float(x << 16);
  hi = __uint_as_float(x & 0xffff0000u);
}
__device__ __forceinline__ void bf16x8_to_f32(const uint4& q,
                                              float (&f)[8]) {
  bf16x2_to_f32(q.x, f[0], f[1]);
  bf16x2_to_f32(q.y, f[2], f[3]);
  bf16x2_to_f32(q.z, f[4], f[5]);
  bf16x2_to_f32(q.w, f[6], f[7]);
}

// One group's adds for a batch of U slots: for each of this lane's columns
// c, the product v[u] * row(u,0)[c] * ... * row(u,K-1)[c] (multiplied left
// to right with __fmul_rn) is added with __fadd_rn into row r[u] of the
// group's partial tile `mine`, in the order u = 0..U-1. `row(u, w)` gives
// slot u's row of input mode w, as a float or a bf16 pointer; each element
// becomes fp32 at its load (ldg_f32). A slot with use[u] false loads
// nothing and adds nothing. All loads of the batch are issued before its
// first add. B1, B2 and B3, B4 call this with the rows they gather or are
// given, so their sums are one sequence of operations.
template <int K, int U, typename RowFn>
__device__ __forceinline__ void add_products(const float (&v)[U],
                                             const int (&r)[U], RowFn row,
                                             const bool (&use)[U],
                                             float* mine, int slab, int lane,
                                             int lanes) {
  for (int c = lane; c < slab; c += lanes) {
    float p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      p[u] = v[u];
#pragma unroll
      for (int w = 0; w < K; ++w)
        p[u] = __fmul_rn(p[u], use[u] ? ldg_f32(row(u, w) + c) : 0.0f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (use[u]) {
        float* dst = mine + r[u] * slab + c;
        *dst = __fadd_rn(*dst, p[u]);
      }
    }
  }
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

// reduce_partials_into for a CTA in which only threads 0..nthreads-1 take
// part (the consumer warps of a warp-specialized kernel) and partial tile
// q starts at q * part_stride, summing in the same order 0..groups-1; each
// thread then zeroes the partial elements it summed, so the partial tiles
// are ready for the next output tile.
__device__ __forceinline__ void reduce_partials_and_clear(
    float* part, int groups, int tile_elems, int part_stride, int slab,
    float* tile_out, long long ld, int tid, int nthreads) {
  for (int e = tid; e < tile_elems; e += nthreads) {
    float acc = part[e];
    for (int q = 1; q < groups; ++q)
      acc = __fadd_rn(acc, part[q * part_stride + e]);
    float* o = tile_out + (long long)(e / slab) * ld + (e % slab);
    *o = __fadd_rn(*o, acc);
    for (int q = 0; q < groups; ++q) part[q * part_stride + e] = 0.0f;
  }
}

// 16-byte asynchronous copy from global to shared memory, and its fences.
__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Wait until at most N of this thread's commit groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4-byte asynchronous copy (no alignment beyond 4 bytes needed).
__device__ __forceinline__ void cp_async4(void* smem_dst,
                                          const void* gmem_src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(smem_dst)),
               "l"(gmem_src)
               : "memory");
}

// mbarriers in shared memory: init (one thread, then a fence and a
// __syncthreads), arrive, arrive with an expected byte count, and a wait
// on the phase of parity `parity` having completed.
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// `count` arrivals at once.
__device__ __forceinline__ void mbar_arrive_n(unsigned long long* bar,
                                              unsigned count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Raise the barrier's expected byte count without arriving.
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// The barrier's arrival, once this thread's earlier cp.asyncs have landed
// (counted in the barrier's init count).
__device__ __forceinline__ void cp_async_mbar_arrive_noinc(
    unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Bulk copy (the TMA's 1-D form) of `bytes` (a multiple of 16, both
// addresses 16-byte aligned) from global to shared memory; its bytes
// complete the transaction count of `bar`.
__device__ __forceinline__ void bulk_g2s(void* smem_dst, const void* gmem_src,
                                         unsigned bytes,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem_dst)),
      "l"(gmem_src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy (bulk copy) writes to the same bytes.
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The end of the last tile's live run (S1). The aligned stream gives every
// output tile blk slots of slack, and the blocks of padding that are left
// over are clipped onto the last tile, so its run holds about
// num_tiles x blk / 2 slots of padding after its last nonzero. Rather than
// stage and vote over all of them in one CTA, the wrapper first runs
// live_end_kernel over that run with the whole card: blk_start[-1] (set to
// 0 by the wrapper) becomes one past the last block of the run that holds
// a nonzero value (atomicMax: integers, so the result is exact), and the
// last tile's CTA stops there (run_end). Any block of the run may hold a
// nonzero, so every slot of it is read, 16 bytes at a time; only the
// blocks after the last live one are cut, which moves no live slot to
// another group, so every sum is bitwise the uncut walk's.
__global__ void live_end_kernel(const float* __restrict__ vals,
                                int* __restrict__ blk_start, int num_tiles,
                                int blk) {
  const long long first = (long long)blk_start[num_tiles - 1] * blk;
  const long long n4 = ((long long)blk_start[num_tiles] * blk - first) / 4;
  const float4* v4 = reinterpret_cast<const float4*>(vals + first);
  long long last = -1;  // the last 16-byte piece holding a nonzero
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < n4; p += (long long)gridDim.x * blockDim.x) {
    const float4 v = __ldcs(v4 + p);
    if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f) last = p;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
  if ((threadIdx.x & 31) == 0 && last >= 0)
    atomicMax(blk_start - 1, (int)((first + 4 * last) / blk) + 1);
}

// Launch live_end_kernel for a stream of n_pad slots (blk_start points at
// the tile starts, blk_start[-1] at the cut, which must hold 0).
inline cudaError_t launch_live_end(const float* vals, int* blk_start,
                                   int num_tiles, int blk, long long n_pad,
                                   cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  constexpr int kThreads = 256;
  const long long pieces = (n_pad / 4 + kThreads - 1) / kThreads;
  const int grid = (int)(pieces < 4LL * sms ? (pieces > 0 ? pieces : 1)
                                            : 4LL * sms);
  live_end_kernel<<<grid, kThreads, 0, stream>>>(vals, blk_start, num_tiles,
                                                 blk);
  return cudaGetLastError();
}

// The block at which tile t's walk ends: its run's end, but for the last
// tile the end of its live run (live_end_kernel), never before its start.
__device__ __forceinline__ int run_end(const int* blk_start, int t,
                                       int num_tiles) {
  const int b1 = blk_start[t + 1];
  return t == num_tiles - 1 ? max(blk_start[t], min(b1, blk_start[-1])) : b1;
}

// A launch above 48 KB of dynamic shared memory needs this opt-in first.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace mttkrp_common
