// The first Hopper design of B3 and B4 (fused spMTTKRP on pre-gathered
// rows), as src/repro_torch/kernels/mttkrp/csrc/fused_mttkrp.cu held it
// before the ring of bulk-copied rows replaced it: kept as source text for
// bench_torch/kernel_ablation.py, which builds it beside the current
// kernel and times both on the same inputs. Not part of the package.
//
// One CTA per output tile (grid num_tiles x num_slabs); per chunk of
// kChunk slots the CTA stages the values, then the local rows of the
// nonzero slots, and skips a chunk of padding only; each group of `lanes`
// threads then loads its slots' rows straight from device memory, element
// by element (4-byte __ldg, or 2-byte for bf16), kUnroll slots in flight,
// and adds them in B1's order (mttkrp_common.cuh add_products,
// reduce_partials_into), so it is bitwise equal to the current kernel.
//
// Build: the port's nvcc flags, with mttkrp_common.cuh on the include path.

#include "mttkrp_common.cuh"

namespace {

using mttkrp_common::kMaxInModes;

// Slots of the stream a B3/B4 CTA stages at a time (as in B1).
constexpr int kChunk = 2048;
// Slots of one group whose row loads are in flight together (as in B1).
constexpr int kUnroll = 4;

// The K pre-gathered row arrays, each (n_pad, ld) row-major, of float or
// bf16 elements.
template <typename T>
struct RowSet {
  const T* ptr[kMaxInModes];
};

template <int K, typename T>
__global__ void fused_mttkrp_kernel(const float* __restrict__ vals,
                                    RowSet<T> rs, const int* __restrict__ lrow,
                                    const int* __restrict__ blk_start,
                                    float* __restrict__ out, int blk,
                                    int tile_rows, int ld, int slab,
                                    int groups, int lanes) {
  // Dynamic shared memory: groups x tile_rows x slab partial tiles, then
  // the staged values and local rows of a chunk.
  extern __shared__ float smem[];
  const int tile_elems = tile_rows * slab;
  float* part = smem;
  float* s_val = part + (size_t)groups * tile_elems;
  int* s_row = reinterpret_cast<int*>(s_val + kChunk);

  const int t = blockIdx.x;
  const int col0 = blockIdx.y * slab;
  const int b0 = blk_start[t];
  const int b1 = blk_start[t + 1];
  if (b0 == b1) return;  // no block maps here: the tile keeps out_init

  for (int e = threadIdx.x; e < groups * tile_elems; e += blockDim.x)
    part[e] = 0.0f;

  const int g = threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  float* mine = part + (size_t)g * tile_elems;
  const long long end = (long long)b1 * blk;
  for (long long base = (long long)b0 * blk; base < end; base += kChunk) {
#pragma unroll 8
    for (int j = threadIdx.x; j < kChunk; j += blockDim.x) {
      const long long i = base + j;
      s_val[j] = i < end ? vals[i] : 0.0f;
    }
    int any = 0;
#pragma unroll 4
    for (int j = threadIdx.x; j < kChunk; j += blockDim.x) {
      if (s_val[j] != 0.0f) {  // this thread's own slot: no barrier needed
        any = 1;
        s_row[j] = lrow[base + j];
      }
    }
    if (!__syncthreads_or(any)) continue;

    // B1's walk: group g takes the chunk's slots g, g+groups, ...,
    // kUnroll at a time; only where the rows come from differs.
    for (int j0 = g; j0 < kChunk; j0 += groups * kUnroll) {
      float v[kUnroll];
      int r[kUnroll];
      long long at[kUnroll];  // slot u's row offset in every row array
      bool use[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * groups;
        v[u] = j < kChunk ? s_val[j] : 0.0f;
        // Padding slots and out-of-range rows add nothing.
        use[u] = v[u] != 0.0f;
        r[u] = use[u] ? s_row[j] : 0;
        use[u] = use[u] && (unsigned)r[u] < (unsigned)tile_rows;
        at[u] = (use[u] ? base + j : 0) * ld + col0;
      }
      mttkrp_common::add_products<K, kUnroll>(
          v, r, [&](int u, int w) { return rs.ptr[w] + at[u]; }, use, mine,
          slab, lane, lanes);
    }
    __syncthreads();  // the next chunk overwrites the staging buffers
  }

  mttkrp_common::reduce_partials_into(
      part, groups, tile_elems, slab,
      out + (long long)t * tile_rows * ld + col0, ld);
}

template <int K, typename T>
cudaError_t launch_fused_k(const float* vals, const RowSet<T>& rs,
                           const int* lrow, const int* blk_start, float* out,
                           int num_tiles, int num_slabs, int blk,
                           int tile_rows, int ld, int slab, int groups,
                           int lanes, cudaStream_t stream) {
  const size_t smem = (size_t)groups * tile_rows * slab * sizeof(float) +
                      (size_t)kChunk * 2 * sizeof(float);
  const cudaError_t e =
      mttkrp_common::allow_smem(fused_mttkrp_kernel<K, T>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(num_tiles, num_slabs);
  fused_mttkrp_kernel<K, T><<<grid, groups * lanes, smem, stream>>>(
      vals, rs, lrow, blk_start, out, blk, tile_rows, ld, slab, groups,
      lanes);
  return cudaGetLastError();
}

template <typename T>
int launch_fused(const void* vals, const void* r0, const void* r1,
                 const void* r2, const void* r3, const void* lrow,
                 const void* blk_start, void* out, int num_in, int num_tiles,
                 int num_slabs, int blk, int tile_rows, int ld, int slab,
                 int groups, int lanes, void* stream) {
  RowSet<T> rs;
  const void* ptrs[kMaxInModes] = {r0, r1, r2, r3};
  for (int w = 0; w < kMaxInModes; ++w)
    rs.ptr[w] = static_cast<const T*>(ptrs[w]);
  const float* v = static_cast<const float*>(vals);
  const int* lr = static_cast<const int*>(lrow);
  const int* bs = static_cast<const int*>(blk_start);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH_K(KK)                                                      \
  launch_fused_k<KK, T>(v, rs, lr, bs, o, num_tiles, num_slabs, blk,      \
                        tile_rows, ld, slab, groups, lanes, s)
  switch (num_in) {
    case 1:
      return LAUNCH_K(1);
    case 2:
      return LAUNCH_K(2);
    case 3:
      return LAUNCH_K(3);
    case 4:
      return LAUNCH_K(4);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH_K
}

}  // namespace

// B3/B4. Launch on `stream`; returns the cudaError_t of the launch (0 =
// success). r1..r3 are ignored beyond `num_in` input modes. The rows are
// float (fused_mttkrp_direct_launch) or bf16
// (fused_mttkrp_direct_bf16_launch); every
// other argument is the same.
#define FUSED_ARGS                                                        \
  const void *vals, const void *r0, const void *r1, const void *r2,       \
      const void *r3, const void *lrow, const void *blk_start, void *out, \
      int num_in, int num_tiles, int num_slabs, int blk, int tile_rows,   \
      int ld, int slab, int groups, int lanes, void *stream
#define FUSED_PASS                                                        \
  vals, r0, r1, r2, r3, lrow, blk_start, out, num_in, num_tiles,          \
      num_slabs, blk, tile_rows, ld, slab, groups, lanes, stream

extern "C" int fused_mttkrp_direct_launch(FUSED_ARGS) {
  return launch_fused<float>(FUSED_PASS);
}

extern "C" int fused_mttkrp_direct_bf16_launch(FUSED_ARGS) {
  return launch_fused<__nv_bfloat16>(FUSED_PASS);
}

extern "C" const char* fused_mttkrp_direct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
