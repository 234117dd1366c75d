// Fused spMTTKRP on pre-gathered rows (B3, B4) and the blocked scatter of
// a materialized contribution (B5), for Hopper (sm_90a).
//
// Replaces repro/kernels/mttkrp/kernel.py:fused_mttkrp_nmode (B3, body
// _fused_nmode_body), fused_mttkrp_nmode_tiled (B4, the same body under a
// rank-slab grid axis) and segment_accumulate (B5, body
// _accum_body_aliased). One kernel serves B3 and B4: B3 is the case where
// the column slab is the whole padded rank, B4 adds a grid axis over
// column slabs (blockIdx.y), as B2 is to B1.
//
// What they compute. For every block b of the block-aligned stream and
// every slot i in it, with t = tile_of_block[b]:
//
//   B3/B4: out[t*tile_rows + local_row[i], c]
//              += vals[i] * prod_w rows_w[i, c]
//   B5:    out[t*tile_rows + local_row[i], c] += contrib[i, c]
//
// on top of the caller's out_init (the wrapper passes `out` holding
// out_init or zeros). rows_w is the w-th input factor's row of slot i,
// gathered by the caller (ops: index_select on the aligned index stream);
// contrib is the materialized product (val * row_0) * row_1 ... .
//
// Element types. B3/B4's rows are float, or bf16 (the reference's bf16
// gathers, kernel.py:453 and :607: ops casts the factor matrix to bf16
// before the gather, the kernel multiplies and adds in fp32). The kernel is
// instantiated for both (fused_mttkrp_launch, fused_mttkrp_bf16_launch); a
// bf16 element becomes fp32 as it is loaded (add_products), exactly, so the
// bf16 B3 == B4 == the bf16 B1 bitwise. B5 takes only fp32: on the bf16
// path its contribution is made in fp32 (the reference's ops.py:619-628).
//
// What bounds them. Per nonzero B3 reads 4 B of value, 4 B of local row
// and K rows of R elements (K * 64 B at R=16, K * 32 B in bf16); B5 reads 4 B of local row and
// one contribution row (64 B at R=16). Both are bound by these HBM bytes:
// the rows are read once, in slot order, with no reuse.
//
// What the design does about it.
//  * The TPU's one-hot MXU scatter is gone. One CTA owns one output tile
//    (its blocks form a contiguous run, found by the wrapper with
//    searchsorted) and holds `groups` private partial tiles in shared
//    memory; no float atomics, so reruns are bitwise equal.
//  * Bitwise contracts. The accumulation is B1's: group g of `lanes`
//    threads takes the slots g, g+groups, ... of the tile's run in order,
//    its lanes split the columns, products are taken left to right with
//    __fmul_rn and added with __fadd_rn (add_products, shared with B1),
//    and the partials are reduced in the order 0..groups-1
//    (reduce_partials_into). `groups` depends on tile_rows only. So on one
//    aligned stream B3 == B4 == B1, and B5 == B1 when contrib holds the
//    same products (PyTorch's elementwise multiplies round the same way).
//    B1 skips padding slots (value 0) while B5 adds their zero rows: adding
//    +-0 leaves a sum unchanged but for the sign of a zero.
//  * B3/B4 stage only values and local rows (kChunk slots, coalesced); a
//    chunk holding only padding is skipped after reading its values, and
//    the rows are read straight from device memory by each group's lanes
//    (16 lanes x 4 B = one 64 B segment per row at R=16), kUnroll slots'
//    loads in flight per thread. Staging whole rows would need
//    kChunk * K * R * 4 B of shared memory.
//  * B5 has no values to skip padding by, so it stages its contribution
//    rows instead: per chunk, `chunk` rows one slab wide (32 KB) are copied
//    with 16-byte cp.async by the whole CTA, then the groups add from
//    shared memory. Its slab is chosen by the wrapper (<= 128 columns), so
//    it runs at any rank: the last rung of the residency ladder.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ../build.py); bound with ctypes.

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

__global__ void segment_accumulate_kernel(const float* __restrict__ contrib,
                                          const int* __restrict__ lrow,
                                          const int* __restrict__ blk_start,
                                          float* __restrict__ out, int blk,
                                          int tile_rows, int ld, int slab,
                                          int groups, int lanes, int chunk) {
  // Dynamic shared memory: the partial tiles, then `chunk` contribution
  // rows one slab wide (16-byte aligned: slab % 16 == 0), then their
  // local rows.
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tile_elems = tile_rows * slab;
  float* part = smem;
  float* s_c = part + (size_t)groups * tile_elems;
  int* s_row = reinterpret_cast<int*>(s_c + (size_t)chunk * slab);

  const int t = blockIdx.x;
  const int col0 = blockIdx.y * slab;
  const int b0 = blk_start[t];
  const int b1 = blk_start[t + 1];
  if (b0 == b1) return;  // no block maps here: the tile keeps its zeros

  for (int e = threadIdx.x; e < groups * tile_elems; e += blockDim.x)
    part[e] = 0.0f;

  const int g = threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  float* mine = part + (size_t)g * tile_elems;
  const int segs = slab / 4;  // 16-byte pieces of one row
  const long long end = (long long)b1 * blk;
  for (long long base = (long long)b0 * blk; base < end; base += chunk) {
    // Stage the chunk: the rows with cp.async (a slot past the run copies
    // nothing and is marked row -1), the local rows while they fly.
    for (int p = threadIdx.x; p < chunk * segs; p += blockDim.x) {
      const int j = p / segs;
      const int s4 = (p - j * segs) * 4;
      const long long i = base + j;
      if (i < end)
        mttkrp_common::cp_async16(s_c + (size_t)j * slab + s4,
                                  contrib + i * ld + col0 + s4);
    }
    mttkrp_common::cp_async_commit();
    for (int j = threadIdx.x; j < chunk; j += blockDim.x) {
      const long long i = base + j;
      s_row[j] = i < end ? lrow[i] : -1;
    }
    mttkrp_common::cp_async_wait_all();
    __syncthreads();

    // B1's walk (chunk is a multiple of groups): group g adds the chunk's
    // slots g, g+groups, ... in order; an out-of-range row adds nothing.
    for (int j = g; j < chunk; j += groups) {
      const int r = s_row[j];
      if ((unsigned)r >= (unsigned)tile_rows) continue;
      const float* src = s_c + (size_t)j * slab;
      for (int c = lane; c < slab; c += lanes) {
        float* dst = mine + r * slab + c;
        *dst = __fadd_rn(*dst, src[c]);
      }
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
// float (fused_mttkrp_launch) or bf16 (fused_mttkrp_bf16_launch); every
// other argument is the same.
#define FUSED_ARGS                                                        \
  const void *vals, const void *r0, const void *r1, const void *r2,       \
      const void *r3, const void *lrow, const void *blk_start, void *out, \
      int num_in, int num_tiles, int num_slabs, int blk, int tile_rows,   \
      int ld, int slab, int groups, int lanes, void *stream
#define FUSED_PASS                                                        \
  vals, r0, r1, r2, r3, lrow, blk_start, out, num_in, num_tiles,          \
      num_slabs, blk, tile_rows, ld, slab, groups, lanes, stream

extern "C" int fused_mttkrp_launch(FUSED_ARGS) {
  return launch_fused<float>(FUSED_PASS);
}

extern "C" int fused_mttkrp_bf16_launch(FUSED_ARGS) {
  return launch_fused<__nv_bfloat16>(FUSED_PASS);
}

// B5. `chunk` contribution rows are staged at a time (a multiple of
// `groups`); `out` holds zeros.
extern "C" int segment_accumulate_launch(const void* contrib, const void* lrow,
                                         const void* blk_start, void* out,
                                         int num_tiles, int num_slabs, int blk,
                                         int tile_rows, int ld, int slab,
                                         int groups, int lanes, int chunk,
                                         void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)groups * tile_rows * slab +
                       (size_t)chunk * slab + (size_t)chunk);
  const cudaError_t e =
      mttkrp_common::allow_smem(segment_accumulate_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(num_tiles, num_slabs);
  segment_accumulate_kernel<<<grid, groups * lanes, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(contrib), static_cast<const int*>(lrow),
      static_cast<const int*>(blk_start), static_cast<float*>(out), blk,
      tile_rows, ld, slab, groups, lanes, chunk);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_mttkrp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
