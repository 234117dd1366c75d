// Out-of-core in-kernel-gather spMTTKRP for Hopper (sm_90a): the stream
// kernel (B6).
//
// Replaces repro/kernels/mttkrp/kernel.py:fused_mttkrp_nmode_gather_stream
// (:868, pallas_call :969; body _fused_gather_stream_body). The factor
// matrices stay in device memory; per nonzero block and input mode w the
// kernel copies the W_w factor tiles (frow rows x slab columns) that the
// block's schedule row names into a window in shared memory, and every
// slot reads its factor rows from that window.
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
// Element types. The factors, and so the window's tiles, are float or
// bf16 (the reference's bf16 gathers, kernel.py:868: bf16 window tiles,
// fp32 products and sums). The kernel is instantiated for both
// (gather_stream_mttkrp_launch, gather_stream_mttkrp_bf16_launch). A bf16
// tile is half the bytes: 256 B at frow 8 and slab 16, and a per-row copy
// slab * 2 = 32 B, both still multiples of 16. The consumers turn each
// element into fp32 as they read it (exact), so the bf16 B6 == the bf16 B1
// bitwise.
//
// What bf16 does besides. Its consumers read two adjacent columns a lane
// (one 4-byte read per row, a float2 of the partial tile; the wrapper
// gives them slab / 2 lanes, half the warps). And the wrapper's ring for
// bf16 windows is the deepest of two stages or more that lets two CTAs
// share an SM (kernel.stream_ring): on the nell-2 stand-in, at one CTA
// an SM the copies alone and the adds alone each took most of the call,
// and two CTAs of two stages overlap them (bench_torch/kernel_ablation.py
// on one H100: 9.6 ms in one CTA of five stages, 6.5 in two of two).
// Four issuer warps a CTA stay (eight ran slower at two CTAs an SM), and
// so do the bulk copies: 16-byte cp.async moved random 256-byte tiles at
// most at 14.3 G tiles/s against the bulk copy's 21.8
// (bench_torch/copy_rate.py).
//
// What bounds it. Each nonzero's value, local row and K indices are read
// from device memory once (4 + 4 + 4K bytes: the HBM bound), and each
// block copies the distinct tiles of its schedule rows (frow * slab *
// itemsize bytes each, once per slab): the stream's distinct_tile_bytes, ~56 GB per
// mode at nell-2 scale under Morton order, ~30x the HBM bytes. They come
// out of the 50 MB L2, so the L2 bound (tile bytes over the card's
// measured L2 read rate) is the one the kernel can approach, and the
// latency of a block's copies is what it must hide.
//
// What the design does about it. The first port ran each block through
// three phases between three barriers (stage, copy, add), so nothing of
// block b+1 was in flight while block b added.
// Now a ring of `stages` window stages (the most that fit 227 KB beside
// eight mapper warps; the wrapper picks it, kernel.stream_ring) and four
// roles of warps, synchronised only by mbarriers:
//  * The meta warp stages each block's values, local rows and indices
//    (three bulk copies, the TMA's 1-D form) and its K schedule rows
//    (4-byte cp.async: a row of odd width is not 16-byte aligned) into a
//    meta slot, stages + mappers + 1 slots deep, well ahead of use.
//  * Mapper warps (warp q takes blocks q, q + mappers, ...) plan a block
//    without touching the window: a block of padding only is flagged and
//    copies nothing; otherwise each schedule entry that repeats entry 0,
//    or lies outside the factor, reads as kNoTile (never copied, never
//    matched), each run of consecutive tiles in consecutive window slots
//    becomes one copy (tiles are contiguous in the factor when
//    ld == slab), and each slot is mapped to its window rows by a binary
//    search of the sorted schedule row (a scan when the row is not
//    sorted). Planning a block is a long chain of dependent shared-memory
//    reads for one warp, so several warps plan blocks at once.
//  * Issuer warps take the planned blocks in order: once a stage is free
//    they issue the block's copies (one bulk copy per run, or per tile
//    row when ld > slab), each warp announcing its bytes to the stage's
//    full barrier. A warp's lanes issue their bulk copies one after
//    another, so four warps share a block's copies.
//  * Consumer warps wait on a stage's full barrier, add, and release the
//    stage and the meta slot. So block i's adds overlap the copies of
//    blocks i+1 ... i+stages-1 and the planning of the blocks after.
//  * One CTA owns one output tile and walks its contiguous run of blocks
//    (as in B1), the last tile first: the padding blocks clipped onto the
//    last tile make its run the longest. That walk ends at the run's last
//    live block (live_end_kernel and run_end, mttkrp_common.cuh, as in
//    B1): the blocks of padding behind it were planned, staged and
//    released one by one by a single CTA. A chunk whose part of the run
//    is all padding walks no block but still hands its carried partials
//    on or reduces them into the output.
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
//
// Shared memory (kernel.gather_stream_smem_bytes), in this order:
//   partial tiles   groups * tile_rows * slab floats
//   windows         stages x wsum * frow * slab elements of the factors'
//                   type (wsum = sum W_w); a multiple of 16 bytes
//   meta slots      (stages + mappers + 1) x slot_ints ints: blk values,
//                   blk local rows, blk * K indices (the mapper writes
//                   window rows over them), wsum schedule entries padded
//                   to 16 bytes; then wsum copy-run lengths and a flag
//                   (the block holds a nonzero), padded to 16 bytes
//   mbarriers       8 bytes each: full, empty per stage; meta full,
//                   planned, meta empty per meta slot
// Threads: the consumers (groups * lanes, rounded up to a warp), the
// mapper warps, kIssuerWarps issuer warps and the meta warp. The wrapper
// checks that vals, local rows, indices and factors are 16-byte aligned
// and blk a multiple of 4, so every bulk copy is aligned.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ../build.py); bound with ctypes.

#include "mttkrp_common.cuh"

namespace {

template <typename T>
using FactorSet = mttkrp_common::FactorSet<T>;
using mttkrp_common::kMaxInModes;
using mttkrp_common::mbar_arrive;
using mttkrp_common::mbar_wait;
using Barrier = unsigned long long;

// A schedule entry never copied or read: it sorts after every tile.
constexpr int kNoTile = 0x7fffffff;

// Per input mode: the (num_blocks, width) int32 schedule and its width.
struct ScheduleSet {
  const int* ptr[kMaxInModes];
  int width[kMaxInModes];
};

// Warps of a CTA besides the consumers: one stages the blocks' meta,
// `mappers` (the wrapper picks 1..8) map blocks' slots and plan their
// copies (warp q takes the blocks q, q + mappers, ...), and kIssuerWarps
// issue each block's copies.
constexpr int kIssuerWarps = 4;

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Ints of one meta slot: the staged block (blk values, blk local rows,
// blk * K indices, wsum schedule entries), then the block's plan (wsum
// copy-run lengths and a flag).
__host__ __device__ inline int meta_slot_ints(int k, int blk, int wsum) {
  return (2 + k) * blk + round4(wsum) + round4(wsum + 1);
}

__host__ __device__ inline int meta_slots(int stages, int mappers) {
  return stages + mappers + 1;
}

__host__ __device__ inline int consumer_threads(int groups, int lanes) {
  return (groups * lanes + 31) / 32 * 32;
}

template <int K, typename T>
__global__ void gather_stream_mttkrp_kernel(
    const float* __restrict__ vals, const int* __restrict__ idx,
    const int* __restrict__ lrow, const int* __restrict__ blk_start,
    FactorSet<T> fs, ScheduleSet ss, float* __restrict__ out,
    const float* __restrict__ carry_in, float* __restrict__ carry_out,
    int blk, int tile_rows, int ld, int slab, int groups, int lanes, int frow,
    int stages, int mappers, int carry_in_tile, int carry_in_phase,
    int carry_out_tile) {
  // Consumer lanes read two adjacent bf16 columns at once.
  constexpr bool kPairReads = sizeof(T) == 2;
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
  const int part_elems = groups * tile_elems;
  const int win_elems = wsum * frow * slab;
  const int slot_ints = meta_slot_ints(K, blk, wsum);
  const int nmeta = meta_slots(stages, mappers);
  const int plan_off = (2 + K) * blk + round4(wsum);  // run lengths, flag
  float* part = smem;
  // 16-byte aligned: slab % 16 == 0, and so is every tile's byte count.
  T* win = reinterpret_cast<T*>(part + part_elems);
  int* meta = reinterpret_cast<int*>(win + (size_t)stages * win_elems);
  Barrier* full = reinterpret_cast<Barrier*>(meta + (size_t)nmeta * slot_ints);
  Barrier* empty = full + stages;
  Barrier* mfull = empty + stages;    // the meta landed
  Barrier* mapped = mfull + nmeta;    // the plan is written
  Barrier* mempty = mapped + nmeta;   // the consumers are done with it

  const int t = gridDim.x - 1 - blockIdx.x;  // the last tile first
  const int col0 = blockIdx.y * slab;
  const int b0 = blk_start[t];
  if (b0 == blk_start[t + 1]) return;  // no block maps here: out_init stays
  // The last tile's walk ends at its last live block (S1). A chunk whose
  // part of that run is all padding then walks no block, but still hands
  // on or reduces the partials it was given (carry_in) below.
  const int nblk = mttkrp_common::run_end(blk_start, t, gridDim.x) - b0;
  const int consumers = consumer_threads(groups, lanes);
  const unsigned consumer_warps = consumers / 32;
  const int mappers0 = consumers;                    // first mapper thread
  const int issuers0 = mappers0 + 32 * mappers;  // first issuer thread
  const int meta0 = issuers0 + 32 * kIssuerWarps;     // the meta warp

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mttkrp_common::mbar_init(&full[s], kIssuerWarps);
      mttkrp_common::mbar_init(&empty[s], consumer_warps);
    }
    for (int m = 0; m < nmeta; ++m) {
      mttkrp_common::mbar_init(&mfull[m], 32 + 1);
      mttkrp_common::mbar_init(&mapped[m], 1);
      mttkrp_common::mbar_init(&mempty[m], consumer_warps);
    }
    mttkrp_common::mbar_init_fence();
  }
  const bool carried = t == carry_in_tile;
  for (int e = threadIdx.x; e < part_elems; e += blockDim.x)
    part[e] = carried ? carry_in[(size_t)blockIdx.y * part_elems + e] : 0.0f;
  __syncthreads();

  const int pl = threadIdx.x % 32;
  const unsigned tile_bytes = frow * slab * sizeof(T);
  if (threadIdx.x >= meta0) {
    // ---- the meta warp: each block's values, local rows and indices (3
    // bulk copies) and schedule rows (4-byte cp.async) into its slot ----
    for (int i = 0; i < nblk; ++i) {
      const int m = i % nmeta;
      mbar_wait(&mempty[m], ((i / nmeta) & 1) ^ 1);
      int* sl = meta + (size_t)m * slot_ints;
      const long long b = b0 + i;
      int* s_sched = sl + (2 + K) * blk;
#pragma unroll
      for (int w = 0; w < K; ++w) {
        const int* row = ss.ptr[w] + b * ss.width[w];
        for (int j = pl; j < ss.width[w]; j += 32)
          mttkrp_common::cp_async4(s_sched + woff[w] + j, row + j);
      }
      mttkrp_common::cp_async_mbar_arrive_noinc(&mfull[m]);
      if (pl == 0) {
        mttkrp_common::mbar_arrive_expect_tx(&mfull[m], (2 + K) * blk * 4);
        mttkrp_common::bulk_g2s(sl, vals + b * blk, blk * 4, &mfull[m]);
        mttkrp_common::bulk_g2s(sl + blk, lrow + b * blk, blk * 4, &mfull[m]);
        mttkrp_common::bulk_g2s(sl + 2 * blk, idx + b * blk * K, blk * K * 4,
                                &mfull[m]);
      }
    }
  } else if (threadIdx.x >= issuers0) {
    // ---- the issuer warps: block by block, once its plan is written and
    // its stage is free, each issues its share of the planned copies ----
    const int iw = (threadIdx.x - issuers0) / 32;
    const int step = 32 * kIssuerWarps;
    for (int i = 0; i < nblk; ++i) {
      const int s = i % stages;
      const int m = i % nmeta;
      mbar_wait(&mapped[m], (i / nmeta) & 1);
      mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
      const int* sl = meta + (size_t)m * slot_ints;
      const int* s_sched = sl + (2 + K) * blk;
      const int* runs = sl + plan_off;
      if (runs[wsum]) {
        // Entry e = pl * kIssuerWarps + iw + k * step of the window.
        unsigned bytes = 0;
        for (int e = pl * kIssuerWarps + iw; e < wsum; e += step)
          bytes += runs[e] * tile_bytes;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          bytes += __shfl_xor_sync(0xffffffffu, bytes, o);
        if (pl == 0) mttkrp_common::mbar_expect_tx(&full[s], bytes);
        __syncwarp();
        T* wins = win + (size_t)s * win_elems;
        for (int e = pl * kIssuerWarps + iw; e < wsum; e += step) {
          const int len = runs[e];
          if (len == 0) continue;
          const T* base = fs.ptr[0];
#pragma unroll
          for (int w = 1; w < K; ++w)
            if (e >= woff[w]) base = fs.ptr[w];
          const T* src = base + (long long)s_sched[e] * frow * ld + col0;
          T* dst = wins + (size_t)e * frow * slab;
          if (ld == slab) {
            mttkrp_common::bulk_g2s(dst, src, len * tile_bytes, &full[s]);
          } else {
            for (int r = 0; r < frow; ++r)
              mttkrp_common::bulk_g2s(dst + r * slab, src + (long long)r * ld,
                                      slab * sizeof(T), &full[s]);
          }
        }
      }
      __syncwarp();
      if (pl == 0) mbar_arrive(&full[s]);
    }
  } else if (threadIdx.x >= mappers0) {
    // ---- the mapper warps: warp q plans the blocks q, q + mappers, ...:
    // which copies to make, and each slot's window rows ----
    const int q = (threadIdx.x - mappers0) / 32;
    for (int i = q; i < nblk; i += mappers) {
      const int m = i % nmeta;
      mbar_wait(&mfull[m], (i / nmeta) & 1);
      int* sl = meta + (size_t)m * slot_ints;
      const float* s_val = reinterpret_cast<const float*>(sl);
      int* s_row = sl + blk;
      int* s_loc = sl + 2 * blk;  // indices in, window rows out
      const int* s_sched = sl + (2 + K) * blk;
      int* runs = sl + plan_off;
      int any = 0;
      for (int j = pl; j < blk; j += 32) any |= s_val[j] != 0.0f;
      any = __any_sync(0xffffffffu, any);
      if (any) {
        // Entry j of a schedule row as the kernel reads it: an entry that
        // repeats entry 0, or lies outside the factor, is kNoTile (never
        // copied, never matched; a row built by ops.tile_schedule stays
        // sorted for the binary search below).
        int first[K];
        int ntiles[K];
#pragma unroll
        for (int w = 0; w < K; ++w) {
          first[w] = s_sched[woff[w]];
          ntiles[w] = fs.rows[w] / frow;
        }
        auto entry = [&](int w, int j) {
          const int tile = s_sched[woff[w] + j];
          return (j > 0 && tile == first[w]) ||
                         (unsigned)tile >= (unsigned)ntiles[w]
                     ? kNoTile
                     : tile;
        };
        // The copies: one per run of consecutive tiles in consecutive
        // window slots (contiguous in both places when ld == slab), else
        // one per tile; runs[e] is the run's length at its first entry.
#pragma unroll
        for (int w = 0; w < K; ++w) {
          for (int j = pl; j < ss.width[w]; j += 32) {
            const int tile = entry(w, j);
            int len = 0;
            if (tile != kNoTile) {
              len = 1;
              if (ld == slab) {
                if (j > 0 && entry(w, j - 1) == tile - 1) {
                  len = 0;  // inside a run
                } else {
                  while (j + len < ss.width[w] &&
                         entry(w, j + len) == tile + len)
                    ++len;
                }
              }
            }
            runs[woff[w] + j] = len;
          }
        }
        // Each slot's window row per mode (-1: the slot adds nothing), and
        // its local row (-1 likewise), in place. A binary search finds the
        // tile in a sorted schedule row; a row in another order falls back
        // to a scan. Any entry that holds the tile holds the same rows.
        for (int j = pl; j < blk; j += 32) {
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
                const int width = ss.width[w];
                int lo = 0;
                int hi = width;
                while (lo < hi) {
                  const int mid = (lo + hi) >> 1;
                  if (entry(w, mid) < tile)
                    lo = mid + 1;
                  else
                    hi = mid;
                }
                int hit = lo < width && entry(w, lo) == tile ? lo : -1;
                for (int u = 0; hit < 0 && u < width; ++u)
                  if (entry(w, u) == tile) hit = u;
                if (hit >= 0) loc = (woff[w] + hit) * frow + ix % frow;
              }
              if (loc < 0) r = -1;
            }
            s_loc[j * K + w] = loc;
          }
          s_row[j] = r;
        }
        // These in-place writes precede, through the barriers, the next
        // bulk copy into this meta slot (another proxy).
        mttkrp_common::fence_proxy_async_smem();
      }
      __syncwarp();
      if (pl == 0) {
        runs[wsum] = any;
        mbar_arrive(&mapped[m]);
      }
    }
  } else {
    // ---- the consumer warps: B1's accumulation ----
    const int g = threadIdx.x / lanes;
    const int lane = threadIdx.x % lanes;
    const bool adds = g < groups;
    float* mine = part + (size_t)g * tile_elems;
    // Index, within the tile's run, of the block's first slot, mod groups.
    int phase = carried ? carry_in_phase : 0;
    for (int i = 0; i < nblk; ++i, phase = (phase + blk) % groups) {
      const int s = i % stages;
      const int m = i % nmeta;
      mbar_wait(&full[s], (i / stages) & 1);
      const int* sl = meta + (size_t)m * slot_ints;
      const float* s_val = reinterpret_cast<const float*>(sl);
      const int* s_row = sl + blk;
      const int* s_loc = sl + 2 * blk;
      if (adds && sl[plan_off + wsum]) {
        const T* wins = win + (size_t)s * win_elems;
        // Group g adds its slots in order (B1's order).
        for (int j = (g - phase + groups) % groups; j < blk; j += groups) {
          const int r = s_row[j];
          if (r < 0) continue;
          const float v = s_val[j];
          const T* rowp[K];
#pragma unroll
          for (int w = 0; w < K; ++w)
            rowp[w] = wins + (size_t)s_loc[j * K + w] * slab;
          if constexpr (kPairReads) {
            // Columns c, c + 1: the same operations as a column a lane.
            for (int c = 2 * lane; c < slab; c += 2 * lanes) {
              float p0 = v;
              float p1 = v;
#pragma unroll
              for (int w = 0; w < K; ++w) {
                float lo, hi;
                mttkrp_common::bf16x2_to_f32(
                    *reinterpret_cast<const unsigned*>(rowp[w] + c), lo, hi);
                p0 = __fmul_rn(p0, lo);
                p1 = __fmul_rn(p1, hi);
              }
              float2* dst = reinterpret_cast<float2*>(mine + r * slab + c);
              float2 d = *dst;
              d.x = __fadd_rn(d.x, p0);
              d.y = __fadd_rn(d.y, p1);
              *dst = d;
            }
          } else {
            for (int c = lane; c < slab; c += lanes) {
              float p = v;
#pragma unroll
              for (int w = 0; w < K; ++w)
                p = __fmul_rn(p, mttkrp_common::to_f32(rowp[w][c]));
              float* dst = mine + r * slab + c;
              *dst = __fadd_rn(*dst, p);
            }
          }
        }
      }
      __syncwarp();
      if ((threadIdx.x & 31) == 0) {
        mbar_arrive(&empty[s]);
        mbar_arrive(&mempty[m]);
      }
    }
  }
  __syncthreads();

  if (t == carry_out_tile) {  // the run goes on in the next chunk
    for (int e = threadIdx.x; e < part_elems; e += blockDim.x)
      carry_out[(size_t)blockIdx.y * part_elems + e] = part[e];
    return;
  }
  mttkrp_common::reduce_partials_into(
      part, groups, tile_elems, slab,
      out + (long long)t * tile_rows * ld + col0, ld);
}

template <int K, typename T>
cudaError_t launch_k(const float* vals, const int* idx, const int* lrow,
                     int* blk_start, const FactorSet<T>& fs,
                     const ScheduleSet& ss, float* out, const float* carry_in,
                     float* carry_out, int num_tiles, int num_slabs, int blk,
                     int tile_rows, int ld, int slab, int groups, int lanes,
                     int frow, int stages, int mappers, int carry_in_tile,
                     int carry_in_phase, int carry_out_tile,
                     long long n_pad, cudaStream_t stream) {
  int wsum = 0;
  for (int w = 0; w < K; ++w) wsum += ss.width[w];
  const size_t smem =
      sizeof(float) * ((size_t)groups * tile_rows * slab +
                       (size_t)meta_slots(stages, mappers) *
                           meta_slot_ints(K, blk, wsum)) +
      sizeof(T) * (size_t)stages * wsum * frow * slab +
      sizeof(Barrier) *
          (2 * (size_t)stages + 3 * (size_t)meta_slots(stages, mappers));
  cudaError_t e =
      mttkrp_common::allow_smem(gather_stream_mttkrp_kernel<K, T>, smem);
  if (e != cudaSuccess) return e;
  e = mttkrp_common::launch_live_end(vals, blk_start, num_tiles, blk, n_pad,
                                     stream);
  if (e != cudaSuccess) return e;
  const dim3 grid(num_tiles, num_slabs);
  const int threads = consumer_threads(groups, lanes) +
                      32 * (mappers + kIssuerWarps + 1);
  gather_stream_mttkrp_kernel<K, T><<<grid, threads, smem, stream>>>(
      vals, idx, lrow, blk_start, fs, ss, out, carry_in, carry_out, blk,
      tile_rows, ld, slab, groups, lanes, frow, stages, mappers,
      carry_in_tile, carry_in_phase, carry_out_tile);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* vals, const void* idx, const void* lrow,
           void* blk_start, const void* f0, const void* f1,
           const void* f2, const void* f3, int rows0, int rows1, int rows2,
           int rows3, const void* s0, const void* s1, const void* s2,
           const void* s3, int width0, int width1, int width2, int width3,
           void* out, const void* carry_in, void* carry_out, int num_in,
           int num_tiles, int num_slabs, int blk, int tile_rows, int ld,
           int slab, int groups, int lanes, int frow, int stages,
           int mappers, int carry_in_tile, int carry_in_phase,
           int carry_out_tile, long long n_pad, void* stream) {
  const FactorSet<T> fs = mttkrp_common::make_factor_set<T>(
      f0, f1, f2, f3, rows0, rows1, rows2, rows3);
  ScheduleSet ss;
  const void* sp[kMaxInModes] = {s0, s1, s2, s3};
  const int widths[kMaxInModes] = {width0, width1, width2, width3};
  for (int w = 0; w < kMaxInModes; ++w) {
    ss.ptr[w] = static_cast<const int*>(sp[w]);
    ss.width[w] = widths[w];
  }
  if (stages < 1 || mappers < 1) return (int)cudaErrorInvalidValue;
  const float* v = static_cast<const float*>(vals);
  const int* ix = static_cast<const int*>(idx);
  const int* lr = static_cast<const int*>(lrow);
  int* bs = static_cast<int*>(blk_start);
  float* o = static_cast<float*>(out);
  const float* ci = static_cast<const float*>(carry_in);
  float* co = static_cast<float*>(carry_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH_K(KK)                                                        \
  launch_k<KK, T>(v, ix, lr, bs, fs, ss, o, ci, co, num_tiles, num_slabs,   \
                  blk, tile_rows, ld, slab, groups, lanes, frow, stages,    \
                  mappers, carry_in_tile, carry_in_phase, carry_out_tile,   \
                  n_pad, st)
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

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// Arguments past `num_in` input modes are ignored. carry_in / carry_out
// may be null when carry_in_tile / carry_out_tile is -1. The factors are
// float (gather_stream_mttkrp_launch) or bf16
// (gather_stream_mttkrp_bf16_launch, `lanes` = slab / 2 up to 32); every
// other argument is the same. `blk_start` and `n_pad` as for
// gather_mttkrp_launch: blk_start[-1] holds 0 and receives the live end of
// the last tile's run.
#define STREAM_ARGS                                                         \
  const void *vals, const void *idx, const void *lrow,                      \
      void *blk_start, const void *f0, const void *f1,                      \
      const void *f2, const void *f3, int rows0, int rows1, int rows2,      \
      int rows3, const void *s0, const void *s1, const void *s2,            \
      const void *s3, int width0, int width1, int width2, int width3,       \
      void *out, const void *carry_in, void *carry_out, int num_in,         \
      int num_tiles, int num_slabs, int blk, int tile_rows, int ld,         \
      int slab, int groups, int lanes, int frow, int stages, int mappers,   \
      int carry_in_tile, int carry_in_phase, int carry_out_tile,            \
      long long n_pad, void *stream
#define STREAM_PASS                                                         \
  vals, idx, lrow, blk_start, f0, f1, f2, f3, rows0, rows1, rows2, rows3,   \
      s0, s1, s2, s3, width0, width1, width2, width3, out, carry_in,        \
      carry_out, num_in, num_tiles, num_slabs, blk, tile_rows, ld, slab,    \
      groups, lanes, frow, stages, mappers, carry_in_tile, carry_in_phase,  \
      carry_out_tile, n_pad, stream

extern "C" int gather_stream_mttkrp_launch(STREAM_ARGS) {
  return launch<float>(STREAM_PASS);
}

extern "C" int gather_stream_mttkrp_bf16_launch(STREAM_ARGS) {
  return launch<__nv_bfloat16>(STREAM_PASS);
}

extern "C" const char* gather_stream_mttkrp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
