// In-kernel-gather fused spMTTKRP for Hopper (sm_90a).
//
// Replaces repro/kernels/mttkrp/kernel.py:fused_mttkrp_nmode_gather and
// fused_mttkrp_nmode_gather_tiled (the two share _fused_gather_body). One
// device function serves both: the untiled kernel is the case where the
// column slab is the whole padded rank; the tiled kernel adds a grid axis
// over column slabs (blockIdx.y).
//
// What it computes. For every block b of the block-aligned nonzero stream
// and every slot i in it:
//
//   out[tile_of_block[b]*tile_rows + local_row[i], c]
//       += vals[i] * prod_w factors[w][idx[i, w], c]
//
// accumulated in fp32 on top of the caller's out_init (the wrapper passes
// `out` already holding out_init or zeros).
//
// What bounds it. Per nonzero the stream brings 4 B of value, 4 B of local
// row and 4 B per input mode of factor index: 16 B/nnz for a 3-mode tensor,
// read from HBM exactly once. The factor matrices are small next to that (at
// R=16 every factor of nell-2 is <= 1.9 MB) and stay in the 50 MB L2, and
// the output is written once. So the kernel is bound by the HBM bytes of
// the nonzero stream; in practice the random factor-row gathers out of L2
// are the second limit.
//
// What the design does about it.
//  * The stream is read once: a CTA stages kChunk slots at a time into
//    shared memory with coalesced loads, and a chunk holding only padding
//    is skipped after reading its values. The factors are gathered straight
//    from global memory through the read-only path (L2-resident), and the
//    TPU's one-hot MXU gather and scatter are gone. Each group issues the
//    factor loads of kUnroll slots before it adds any of them, so several
//    loads are in flight per thread.
//  * One CTA owns one output tile (tile_of_block is non-decreasing, so a
//    tile's blocks form a contiguous run, found by the wrapper with
//    searchsorted). The tile lives in shared memory and is written to HBM
//    once. No float atomics anywhere, so the result is deterministic.
//  * The rank may be as small as 16, where one column per thread would
//    leave most of a warp idle. Instead each CTA has `groups` groups of
//    `lanes` (16 or 32) threads; group g takes the slots g, g+groups, ...
//    of the tile's run in order, its lanes split the columns, and it adds
//    into its own private partial tile. The partials are then summed in
//    the fixed order 0..groups-1 and added to the output.
//  * Bitwise contract tiled == untiled: `groups` depends on tile_rows only,
//    never on the slab width, and every add and multiply is __fadd_rn /
//    __fmul_rn (no contraction into FMA), so each column sees the same
//    operations in the same order whatever the slab.
//  * Padding slots (val == 0) add nothing and are skipped before any
//    gather. An out-of-range local row or factor index is skipped too, so
//    a malformed stream cannot write or read out of bounds.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ../build.py); bound with ctypes.

#include "mttkrp_common.cuh"

namespace {

using mttkrp_common::FactorSet;
// Slots of the stream a CTA stages in shared memory at a time (a multiple
// of every block size the wrapper picks: groups (<= 16) x lanes (16 or
// 32), powers of two up to 512). No __launch_bounds__: on the H100 it
// made the wide-slab kernel slower; at <= 96 registers a 512-thread CTA
// fits, and a refused launch is reported by the wrapper.
constexpr int kChunk = 2048;
// Slots of one group whose factor loads are in flight together.
constexpr int kUnroll = 4;

template <int K>
__global__ void gather_mttkrp_kernel(const float* __restrict__ vals,
                                     const int* __restrict__ idx,
                                     const int* __restrict__ lrow,
                                     const int* __restrict__ blk_start,
                                     FactorSet fs, float* __restrict__ out,
                                     int blk, int tile_rows, int ld,
                                     int slab, int groups, int lanes) {
  // Dynamic shared memory: groups x tile_rows x slab partial tiles, then
  // the staged chunk of the stream (values, local rows, K indices).
  extern __shared__ float smem[];
  const int tile_elems = tile_rows * slab;
  float* part = smem;
  float* s_val = part + (size_t)groups * tile_elems;
  int* s_row = reinterpret_cast<int*>(s_val + kChunk);
  int* s_idx = s_row + kChunk;

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
    // Stage the chunk with coalesced loads, the independent value loads
    // first; a padding slot (val == 0) loads nothing else. A chunk without
    // a nonzero value is skipped as a whole, so the all-padding blocks
    // clipped onto the last tile cost one coalesced read of their values.
#pragma unroll 8
    for (int j = threadIdx.x; j < kChunk; j += blockDim.x) {
      const long long i = base + j;
      s_val[j] = i < end ? vals[i] : 0.0f;
    }
    int any = 0;
#pragma unroll 4
    for (int j = threadIdx.x; j < kChunk; j += blockDim.x) {
      if (s_val[j] != 0.0f) {  // this thread's own slot: no barrier needed
        const long long i = base + j;
        any = 1;
        s_row[j] = lrow[i];
#pragma unroll
        for (int w = 0; w < K; ++w) s_idx[j * K + w] = idx[i * K + w];
      }
    }
    if (!__syncthreads_or(any)) continue;

    // Group g takes the chunk's slots g, g+groups, ... (kChunk is a
    // multiple of groups, so across chunks it walks every groups-th slot
    // of the tile's run in order), kUnroll slots at a time: the factor
    // loads of a batch are issued before its adds, which run in slot order.
    for (int j0 = g; j0 < kChunk; j0 += groups * kUnroll) {
      float v[kUnroll];
      int r[kUnroll];
      const float* rowp[kUnroll][K];
      bool use[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * groups;
        v[u] = j < kChunk ? s_val[j] : 0.0f;
        // Padding slots and out-of-range rows or indices add nothing.
        use[u] = v[u] != 0.0f;
        r[u] = use[u] ? s_row[j] : 0;
        use[u] = use[u] && (unsigned)r[u] < (unsigned)tile_rows;
#pragma unroll
        for (int w = 0; w < K; ++w) {
          const int ix = use[u] ? s_idx[j * K + w] : 0;
          use[u] = use[u] && (unsigned)ix < (unsigned)fs.rows[w];
          rowp[u][w] = fs.ptr[w] + (long long)ix * ld + col0;
        }
      }
      mttkrp_common::add_products<K, kUnroll>(v, r, rowp, use, mine, slab,
                                              lane, lanes);
    }
    __syncthreads();  // the next chunk overwrites the staging buffers
  }

  // Fixed-order reduction of the group partials into the output tile.
  mttkrp_common::reduce_partials_into(
      part, groups, tile_elems, slab,
      out + (long long)t * tile_rows * ld + col0, ld);
}

template <int K>
cudaError_t launch_k(const float* vals, const int* idx, const int* lrow,
                     const int* blk_start, const FactorSet& fs, float* out,
                     int num_tiles, int num_slabs, int blk, int tile_rows,
                     int ld, int slab, int groups, int lanes,
                     cudaStream_t stream) {
  const size_t smem = (size_t)groups * tile_rows * slab * sizeof(float) +
                      (size_t)kChunk * (2 + K) * sizeof(float);
  const cudaError_t e =
      mttkrp_common::allow_smem(gather_mttkrp_kernel<K>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(num_tiles, num_slabs);
  gather_mttkrp_kernel<K><<<grid, groups * lanes, smem, stream>>>(
      vals, idx, lrow, blk_start, fs, out, blk, tile_rows, ld, slab, groups,
      lanes);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// f1..f3 / rows1..rows3 are ignored beyond `num_in` input modes.
extern "C" int gather_mttkrp_launch(
    const void* vals, const void* idx, const void* lrow, const void* blk_start,
    const void* f0, const void* f1, const void* f2, const void* f3, int rows0,
    int rows1, int rows2, int rows3, void* out, int num_in, int num_tiles,
    int num_slabs, int blk, int tile_rows, int ld, int slab, int groups,
    int lanes, void* stream) {
  const FactorSet fs = mttkrp_common::make_factor_set(
      f0, f1, f2, f3, rows0, rows1, rows2, rows3);
  const float* v = static_cast<const float*>(vals);
  const int* ix = static_cast<const int*>(idx);
  const int* lr = static_cast<const int*>(lrow);
  const int* bs = static_cast<const int*>(blk_start);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (num_in) {
    case 1:
      return launch_k<1>(v, ix, lr, bs, fs, o, num_tiles, num_slabs, blk,
                         tile_rows, ld, slab, groups, lanes, s);
    case 2:
      return launch_k<2>(v, ix, lr, bs, fs, o, num_tiles, num_slabs, blk,
                         tile_rows, ld, slab, groups, lanes, s);
    case 3:
      return launch_k<3>(v, ix, lr, bs, fs, o, num_tiles, num_slabs, blk,
                         tile_rows, ld, slab, groups, lanes, s);
    case 4:
      return launch_k<4>(v, ix, lr, bs, fs, o, num_tiles, num_slabs, blk,
                         tile_rows, ld, slab, groups, lanes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* gather_mttkrp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
