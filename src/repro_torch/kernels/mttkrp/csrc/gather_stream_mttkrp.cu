// Out-of-core in-kernel-gather spMTTKRP for Hopper (sm_90a): the stream
// kernel (B6).
//
// Replaces repro/kernels/mttkrp/kernel.py:fused_mttkrp_nmode_gather_stream
// (body _fused_gather_stream_body). The factor matrices stay in device
// memory; per nonzero block and input mode w the kernel copies the W_w
// factor tiles (frow rows x slab columns) that the block's schedule row
// names into a window in shared memory, and every slot reads its factor
// rows from that window.
//
// What it computes. For every block b of the block-aligned stream and
// every slot i in it, with tile(w, i) = idx[i, w] / frow:
//
//   out[tile_of_block[b]*tile_rows + local_row[i], c]
//       += vals[i] * prod_w factors[w][idx[i, w], c]
//
// if tile(w, i) appears in sched_w[b, :] for every w; a slot whose tile is
// missing adds nothing, like an out-of-range index. The window holds the
// very rows B1 gathers, and the sums are taken in B1's order (below), so
// B6 == B1 bitwise on the same stream: the reference's "streamed ==
// resident".
//
// What bounds it. Each nonzero's value, local row and K indices are read
// from device memory once (4 + 4 + 4K bytes), and each block copies the
// distinct tiles of its schedule rows (frow * slab * 4 bytes each, once
// per slab). Those tile bytes are what the stream counts as
// distinct_tile_bytes; on data without locality they exceed B1's row
// gathers, since a tile brings frow rows for the one a slot reads. The
// copies come out of the 50 MB L2 where the factors fit, so the kernel is
// bound by L2-to-shared-memory bandwidth and by the latency of the
// per-block phases more than by HBM bytes.
//
// What the design does about it.
//  * One CTA owns one output tile and walks its contiguous run of blocks
//    (as in B1); a block holding only padding is skipped after one
//    coalesced read of its values, so the padding blocks clipped onto the
//    last tile cost almost nothing.
//  * Per block, three phases and three barriers: (1) stage the values,
//    local rows, indices and K schedule rows with independent loads;
//    (2) issue the tile copies, a warp per tile, with 16-byte cp.async
//    (no registers held, one commit group), and while they fly map each
//    slot to its window rows by a binary search of the sorted schedule
//    row, once per slot rather than once per lane; (3) accumulate. A
//    schedule entry that repeats entry 0 is never the first match, so
//    its copy is skipped: the padding of a short row costs nothing.
//  * The CTA has 512 threads whatever `groups * lanes` is: the extra
//    warps stage and copy, and only the first groups * lanes threads add.
//  * Accumulation is B1's: `groups` groups of `lanes` threads, group g
//    takes the slots whose index in the tile's run is g mod groups, in
//    order, its lanes split the columns, and it adds with __fmul_rn /
//    __fadd_rn into a private partial tile; the partials are reduced in
//    the order 0..groups-1 (mttkrp_common.cuh, shared with B1).
//  * Chunked == single-pass. A chunk may end inside a tile's run. Then the
//    CTA of that tile writes its partial tiles to `carry_out` instead of
//    reducing them, and the next chunk's CTA of the same tile starts from
//    them (`carry_in`), with the slot phase it hands on, so the adds are
//    the single pass's, bracketed the same way.
//  * TMA and a multi-stage mbarrier ring, which would overlap one block's
//    copies with the previous block's sums, are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ../build.py); bound with ctypes.

#include "mttkrp_common.cuh"

namespace {

using mttkrp_common::FactorSet;
using mttkrp_common::cp_async16;
using mttkrp_common::cp_async_commit;
using mttkrp_common::cp_async_wait_all;
using mttkrp_common::kMaxInModes;

// Threads of a CTA: groups * lanes (<= 512) accumulate; all of them stage
// the block and copy the window.
constexpr int kThreads = 512;
// A schedule entry never read: it sorts after every tile.
constexpr int kNoTile = 0x7fffffff;

// Per input mode: the (num_blocks, width) int32 schedule and its width.
struct ScheduleSet {
  const int* ptr[kMaxInModes];
  int width[kMaxInModes];
};

template <int K>
__global__ void gather_stream_mttkrp_kernel(
    const float* __restrict__ vals, const int* __restrict__ idx,
    const int* __restrict__ lrow, const int* __restrict__ blk_start,
    FactorSet fs, ScheduleSet ss, float* __restrict__ out,
    const float* __restrict__ carry_in, float* __restrict__ carry_out,
    int blk, int tile_rows, int ld, int slab, int groups, int lanes, int frow,
    int carry_in_tile, int carry_in_phase, int carry_out_tile) {
  // Dynamic shared memory (kernel.gather_stream_smem_bytes): the partial
  // tiles, the window (per mode, width tiles of frow x slab), the staged
  // values, local rows and window rows, and the schedule rows.
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int woff[K];  // first window tile of each mode
  int wsum = 0;
#pragma unroll
  for (int w = 0; w < K; ++w) {
    woff[w] = wsum;
    wsum += ss.width[w];
  }
  const int tile_elems = tile_rows * slab;
  const size_t part_elems = (size_t)groups * tile_elems;
  float* part = smem;
  float* win = part + part_elems;  // 16-byte aligned: slab % 16 == 0
  float* s_val = win + (size_t)wsum * frow * slab;
  int* s_row = reinterpret_cast<int*>(s_val + blk);
  int* s_loc = s_row + blk;
  int* s_sched = s_loc + blk * K;

  const int t = blockIdx.x;
  const int col0 = blockIdx.y * slab;
  const int b0 = blk_start[t];
  const int b1 = blk_start[t + 1];
  if (b0 == b1) return;  // no block maps here: the tile keeps out_init

  const bool carried = t == carry_in_tile;
  for (size_t e = threadIdx.x; e < part_elems; e += blockDim.x)
    part[e] = carried ? carry_in[blockIdx.y * part_elems + e] : 0.0f;

  // Threads past groups * lanes only stage and copy.
  const int g = threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  float* mine = part + (size_t)g * tile_elems;
  const int warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  const int segs = slab / 4;  // 16-byte pieces of one tile row
  const int tile_segs = frow * segs;
  // Index, within the tile's run, of this block's first slot, mod groups.
  int phase = carried ? carry_in_phase : 0;
  for (int b = b0; b < b1; ++b, phase = (phase + blk) % groups) {
    // Stage the block: values, local rows, indices and schedule rows, all
    // loads independent. A schedule entry that repeats entry 0, or lies
    // outside the factor, is stored as kNoTile: it is never the first
    // match, so its tile is not copied, and the rest of a schedule built
    // by ops.tile_schedule stays sorted for the binary search below.
    const long long base = (long long)b * blk;
    int any = 0;
    for (int j = threadIdx.x; j < blk; j += blockDim.x) {
      const float v = vals[base + j];
      s_val[j] = v;
      s_row[j] = lrow[base + j];
#pragma unroll
      for (int w = 0; w < K; ++w) s_loc[j * K + w] = idx[(base + j) * K + w];
      any |= v != 0.0f;
    }
#pragma unroll
    for (int w = 0; w < K; ++w) {
      const int* row = ss.ptr[w] + (long long)b * ss.width[w];
      const int first = row[0];
      const int ntiles = fs.rows[w] / frow;
      for (int j = threadIdx.x; j < ss.width[w]; j += blockDim.x) {
        const int tile = row[j];
        s_sched[woff[w] + j] =
            (j > 0 && tile == first) || (unsigned)tile >= (unsigned)ntiles
                ? kNoTile
                : tile;
      }
    }
    if (!__syncthreads_or(any)) continue;  // padding only: adds nothing

    // Copy the scheduled tiles into the window, one slab wide: a warp per
    // tile, a 16-byte piece per lane.
#pragma unroll
    for (int w = 0; w < K; ++w) {
      const int* sch = s_sched + woff[w];
      for (int j = warp; j < ss.width[w]; j += nwarps) {
        const int tile = sch[j];
        if (tile == kNoTile) continue;
        const float* src = fs.ptr[w] + (long long)tile * frow * ld + col0;
        float* dst = win + (size_t)(woff[w] + j) * frow * slab;
        for (int p = threadIdx.x % 32; p < tile_segs; p += 32) {
          const int r = p / segs;
          const int s4 = (p - r * segs) * 4;
          cp_async16(dst + r * slab + s4, src + (long long)r * ld + s4);
        }
      }
    }
    cp_async_commit();

    // While the copies fly: each slot's window row per mode (-1: the slot
    // adds nothing), and its local row (-1 likewise). A binary search
    // finds the tile in a sorted schedule; a schedule in another order
    // falls back to a scan. Any slot that holds the tile holds the same
    // rows, so the first match's rows are read.
    for (int j = threadIdx.x; j < blk; j += blockDim.x) {
      int r = -1;
      if (s_val[j] != 0.0f) {
        r = s_row[j];
        if ((unsigned)r >= (unsigned)tile_rows) r = -1;
      }
#pragma unroll
      for (int w = 0; w < K; ++w) {
        int loc = -1;
        if (r >= 0) {
          const int ix = s_loc[j * K + w];
          if ((unsigned)ix < (unsigned)fs.rows[w]) {
            const int tile = ix / frow;
            const int* sch = s_sched + woff[w];
            int lo = 0;
            int hi = ss.width[w];
            while (lo < hi) {
              const int mid = (lo + hi) >> 1;
              if (sch[mid] < tile)
                lo = mid + 1;
              else
                hi = mid;
            }
            int q = lo < ss.width[w] && sch[lo] == tile ? lo : -1;
            for (int u = 0; q < 0 && u < ss.width[w]; ++u)
              if (sch[u] == tile) q = u;
            if (q >= 0) loc = (woff[w] + q) * frow + ix % frow;
          }
          if (loc < 0) r = -1;
        }
        s_loc[j * K + w] = loc;
      }
      s_row[j] = r;
    }
    cp_async_wait_all();
    __syncthreads();

    // B1's accumulation: group g takes the slots j with
    // (phase + j) % groups == g, in order.
    if (g < groups) {
      for (int j = (g - phase + groups) % groups; j < blk; j += groups) {
        const int r = s_row[j];
        if (r < 0) continue;
        const float v = s_val[j];
        const float* rowp[K];
#pragma unroll
        for (int w = 0; w < K; ++w)
          rowp[w] = win + (size_t)s_loc[j * K + w] * slab;
        for (int c = lane; c < slab; c += lanes) {
          float p = v;
#pragma unroll
          for (int w = 0; w < K; ++w) p = __fmul_rn(p, rowp[w][c]);
          float* dst = mine + r * slab + c;
          *dst = __fadd_rn(*dst, p);
        }
      }
    }
    __syncthreads();  // the next block overwrites the staging and window
  }

  if (t == carry_out_tile) {  // the run goes on in the next chunk
    for (size_t e = threadIdx.x; e < part_elems; e += blockDim.x)
      carry_out[blockIdx.y * part_elems + e] = part[e];
    return;
  }
  mttkrp_common::reduce_partials_into(
      part, groups, tile_elems, slab,
      out + (long long)t * tile_rows * ld + col0, ld);
}

template <int K>
cudaError_t launch_k(const float* vals, const int* idx, const int* lrow,
                     const int* blk_start, const FactorSet& fs,
                     const ScheduleSet& ss, float* out, const float* carry_in,
                     float* carry_out, int num_tiles, int num_slabs, int blk,
                     int tile_rows, int ld, int slab, int groups, int lanes,
                     int frow, int carry_in_tile, int carry_in_phase,
                     int carry_out_tile, cudaStream_t stream) {
  size_t wsum = 0;
  for (int w = 0; w < K; ++w) wsum += ss.width[w];
  const size_t smem =
      sizeof(float) * ((size_t)groups * tile_rows * slab +
                       wsum * frow * slab + wsum + (size_t)blk * (2 + K));
  const cudaError_t e =
      mttkrp_common::allow_smem(gather_stream_mttkrp_kernel<K>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(num_tiles, num_slabs);
  gather_stream_mttkrp_kernel<K><<<grid, kThreads, smem, stream>>>(
      vals, idx, lrow, blk_start, fs, ss, out, carry_in, carry_out, blk,
      tile_rows, ld, slab, groups, lanes, frow, carry_in_tile,
      carry_in_phase, carry_out_tile);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// Arguments past `num_in` input modes are ignored. carry_in / carry_out
// may be null when carry_in_tile / carry_out_tile is -1.
extern "C" int gather_stream_mttkrp_launch(
    const void* vals, const void* idx, const void* lrow, const void* blk_start,
    const void* f0, const void* f1, const void* f2, const void* f3, int rows0,
    int rows1, int rows2, int rows3, const void* s0, const void* s1,
    const void* s2, const void* s3, int width0, int width1, int width2,
    int width3, void* out, const void* carry_in, void* carry_out, int num_in,
    int num_tiles, int num_slabs, int blk, int tile_rows, int ld, int slab,
    int groups, int lanes, int frow, int carry_in_tile, int carry_in_phase,
    int carry_out_tile, void* stream) {
  const FactorSet fs = mttkrp_common::make_factor_set(
      f0, f1, f2, f3, rows0, rows1, rows2, rows3);
  ScheduleSet ss;
  const void* sp[kMaxInModes] = {s0, s1, s2, s3};
  const int widths[kMaxInModes] = {width0, width1, width2, width3};
  for (int w = 0; w < kMaxInModes; ++w) {
    ss.ptr[w] = static_cast<const int*>(sp[w]);
    ss.width[w] = widths[w];
  }
  const float* v = static_cast<const float*>(vals);
  const int* ix = static_cast<const int*>(idx);
  const int* lr = static_cast<const int*>(lrow);
  const int* bs = static_cast<const int*>(blk_start);
  float* o = static_cast<float*>(out);
  const float* ci = static_cast<const float*>(carry_in);
  float* co = static_cast<float*>(carry_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH_K(KK)                                                         \
  launch_k<KK>(v, ix, lr, bs, fs, ss, o, ci, co, num_tiles, num_slabs, blk,  \
               tile_rows, ld, slab, groups, lanes, frow, carry_in_tile,      \
               carry_in_phase, carry_out_tile, st)
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

extern "C" const char* gather_stream_mttkrp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
