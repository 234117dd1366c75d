// Fused spMTTKRP on pre-gathered rows (B3, B4) and the blocked scatter of
// a materialized contribution (B5), for Hopper (sm_90a).
//
// Replaces repro/kernels/mttkrp/kernel.py:fused_mttkrp_nmode (B3, body
// _fused_nmode_body), fused_mttkrp_nmode_tiled (B4, the same body under a
// rank-slab grid axis) and segment_accumulate (B5, body
// _accum_body_aliased). One kernel serves B3 and B4: B3 is the case where
// the column slab is the whole padded rank, B4 splits the columns into
// slabs, each a separate work item, as B2 is to B1.
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
// bf16 element lands in shared memory as bf16 and becomes fp32 as it is
// read from there (to_f32), exactly, so the bf16 B3 == B4 == the bf16 B1
// bitwise. B5 takes only fp32: on the bf16 path its contribution is made
// in fp32 (the reference's ops.py:619-628).
//
// What bounds them. Per nonzero B3 reads 4 B of value, 4 B of local row
// and K rows of R elements (K * 64 B at R=16, K * 32 B in bf16); B5 reads
// 4 B of local row and one contribution row (64 B at R=16). Both are bound
// by these HBM bytes: the rows are read once, in slot order, with no reuse.
//
// What the B3/B4 design does about it. The first port read each row
// element by element with 4-byte loads, four slots in flight per group,
// one CTA per output tile, and staged a chunk's values before its rows:
// the count and latency of its requests, not bytes, set its time, so bf16
// rows took fp32's time. Now rows arrive in shared memory by bulk copies,
// and three roles of warps work on a ring, synchronised only by mbarriers:
//  * Persistent CTAs (as many as fit on the SMs at once) take work items,
//    an output tile and a column slab each, from an integer counter, the
//    last tile first: the padding blocks the layout clips onto the last
//    tile make its run the longest. A tile is owned by one CTA at a time,
//    so there are no float atomics and reruns are bitwise equal.
//  * The meta warp walks each item's run of slots in chunks of kMetaChunk
//    slots (aligned to the run's start) and copies their values and local
//    rows with two bulk copies into a meta ring of kMetaStages slots, well
//    ahead of use, crossing from one item into the next.
//  * The row warp takes the chunks in order. It reads the chunk's values
//    from shared memory and splits it into stages of `slots` slots; a
//    stage with a nonzero value gets one ring stage, filled by K bulk
//    copies (the K row slices are contiguous when the slab is the whole
//    row) or, for a slab narrower than the row (B4 with slab < R), by
//    2-D TMA tensor copies (boxes of slab x up to 256 rows; 16-byte
//    cp.async took 4.8x as long, bench_torch/kernel_ablation.py), all
//    completing the stage's full barrier. A stage of padding only is
//    never copied, and a chunk of padding only is handed back to the meta
//    warp at once: the clipped padding costs its values, not its rows.
//    This skip and the last tile first are what keep the mode with the
//    most tiles (the most clipped padding) as fast as the others; one CTA
//    per item instead of persistent CTAs measures the same.
//  * The consumer warps take the ring stages in order and add; after an
//    item's last stage they reduce its partial tiles into the output and
//    clear them, while the row warp already fills the ring with the next
//    item's stages. So copies overlap adds, and no item pays a pipeline
//    fill.
//  * Bitwise contracts (shared with B1, B2, B6). A stage starts at a slot
//    whose index in the tile's run is a multiple of `slots`, itself a
//    multiple of `groups`, so group g of `lanes` threads takes the slots
//    whose index in the run is g mod groups, in order; its lanes split the
//    columns; products are taken left to right with __fmul_rn and added
//    with __fadd_rn into the group's private partial tile; the partials
//    are reduced in the order 0..groups-1. `groups` depends on tile_rows
//    only. So on one aligned stream B3 == B4 == B1. Padding slots (value
//    0) and out-of-range local rows add nothing.
//
// Shared memory (kernel.fused_smem_bytes), in this order:
//   ring           stages x K x slots x slab elements of the rows' type
//                  (each row array's slice [slots][slab]; a multiple of
//                  512 bytes per stage, so every stage is 128-B aligned)
//   partial tiles  groups x part_stride floats (each tile_rows x slab,
//                  padded to an odd multiple of 16 floats)
//   meta ring      kMetaStages x kMetaChunk x (value float, local row int)
//   headers        (stages + kMetaStages) x kHdrInts ints
//   mbarriers      8 bytes each: full and empty per stage and per meta slot
// The wrapper picks (stages, slots) (kernel.fused_ring) and checks that
// vals, local rows and the row arrays are 16-byte aligned and blk a
// multiple of 4, so every bulk copy is aligned.
//
// B5 has no values to skip padding by, so it stages its contribution rows
// instead: per chunk, `chunk` rows one slab wide (32 KB) are copied with
// 16-byte cp.async by the whole CTA, then the groups add from shared
// memory. Its slab is chosen by the wrapper (<= 128 columns), so it runs at
// any rank: the last rung of the residency ladder.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ../build.py); bound with ctypes. cuda.h
// gives the tensor-map types; cuTensorMapEncodeTiled is looked up at run
// time through the runtime's entry-point query, so there is no -lcuda.

#include <cuda.h>

#include "mttkrp_common.cuh"

namespace {

using mttkrp_common::kMaxInModes;
using mttkrp_common::mbar_arrive;
using mttkrp_common::mbar_wait;
using Barrier = unsigned long long;

// The most rows of one 2-D tensor copy (the TMA's box limit).
constexpr int kBoxRows = 256;
// Slots of one group whose adds are batched (their loads issued first).
constexpr int kUnroll = 4;
// Meta ring slots, and the slots of a chunk of values and local rows
// (at most 64 ring stages of at least 16 slots).
constexpr int kMetaStages = 4;
constexpr int kMetaChunk = 1024;
// Ints of one header (a meta slot's or a ring stage's).
constexpr int kHdrInts = 8;
// Ring stage header flags.
constexpr int kRelease = 1;  // the consumers hand the meta slot back
constexpr int kItemEnd = 2;  // the item's last stage: reduce its partials
constexpr int kEnd = 4;      // no more work

// The K pre-gathered row arrays, each (n_pad, ld) row-major, of float or
// bf16 elements.
template <typename T>
struct RowSet {
  const T* ptr[kMaxInModes];
};

// One 2-D tensor map per row array (used when slab < ld).
struct TensorMaps {
  CUtensorMap map[kMaxInModes];
};

__host__ __device__ inline int consumer_threads(int groups, int lanes) {
  return (groups * lanes + 31) / 32 * 32;
}

// Floats from one group's partial tile to the next: the tile rounded up to
// an odd multiple of 16, so the two 16-lane groups of a warp, adding into
// the same row of their tiles, hit different banks.
__host__ __device__ inline int part_stride(int tile_elems) {
  return (tile_elems / 16 | 1) * 16;
}

// Shared-memory bytes of one CTA (kernel.fused_smem_bytes).
__host__ __device__ inline size_t fused_smem(int k, int itemsize, int groups,
                                             int tile_rows, int slab,
                                             int stages, int slots) {
  return (size_t)itemsize * stages * k * slots * slab +
         sizeof(float) * ((size_t)groups * part_stride(tile_rows * slab) +
                          (size_t)kMetaStages * kMetaChunk * 2 +
                          (size_t)(stages + kMetaStages) * kHdrInts) +
         sizeof(Barrier) * 2 * ((size_t)stages + kMetaStages);
}

__device__ __forceinline__ void consumer_sync(int consumers) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(consumers) : "memory");
}

// The TMA's 2-D tensor copy: the box at element coordinates (x, y) of
// `map` into shared memory, completing the transaction count of `bar`.
__device__ __forceinline__ void tensor_g2s(void* smem_dst,
                                           const CUtensorMap* map, int x,
                                           int y, Barrier* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          mttkrp_common::smem_addr(smem_dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(x), "r"(y),
      "r"(mttkrp_common::smem_addr(bar))
      : "memory");
}

template <int K, typename T>
__global__ void fused_mttkrp_kernel(
    const float* __restrict__ vals, RowSet<T> rs,
    const __grid_constant__ TensorMaps maps, const int* __restrict__ lrow,
    const int* __restrict__ blk_start, float* __restrict__ out,
    int* __restrict__ next_item, int num_tiles, int num_slabs, int blk,
    int tile_rows, int ld, int slab, int groups, int lanes, int stages,
    int slots) {
  constexpr int chunk = kMetaChunk;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tile_elems = tile_rows * slab;
  const int pstride = part_stride(tile_elems);
  const int stage_elems = K * slots * slab;
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* part = reinterpret_cast<float*>(ring + (size_t)stages * stage_elems);
  float* mval = part + groups * pstride;  // meta slot m: values
  int* mrow = reinterpret_cast<int*>(mval + (size_t)kMetaStages * chunk);
  int* mhdr = mrow + (size_t)kMetaStages * chunk;  // meta slot headers
  int* rhdr = mhdr + kMetaStages * kHdrInts;       // ring stage headers
  Barrier* full = reinterpret_cast<Barrier*>(rhdr + stages * kHdrInts);
  Barrier* empty = full + stages;
  Barrier* mfull = empty + stages;
  Barrier* mempty = mfull + kMetaStages;

  const int consumers = consumer_threads(groups, lanes);
  const int consumer_warps = consumers / 32;
  const int lane32 = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mttkrp_common::mbar_init(&full[s], 1);
      mttkrp_common::mbar_init(&empty[s], consumer_warps);
    }
    for (int m = 0; m < kMetaStages; ++m) {
      mttkrp_common::mbar_init(&mfull[m], 1);
      mttkrp_common::mbar_init(&mempty[m], consumer_warps);
    }
    mttkrp_common::mbar_init_fence();
  }
  for (int e = threadIdx.x; e < groups * pstride; e += blockDim.x)
    part[e] = 0.0f;
  __syncthreads();

  if (threadIdx.x >= consumers + 32) {
    // ---- the meta warp: items from the counter, each run's values and
    // local rows, chunk by chunk, into the meta ring ----
    const int items = num_tiles * num_slabs;
    int seq = 0;
    for (;;) {
      int item = 0;
      if (lane32 == 0) item = atomicAdd(next_item, 1);
      item = __shfl_sync(0xffffffffu, item, 0);
      if (item >= items) break;
      const int t = num_tiles - 1 - item / num_slabs;  // the last tile first
      const int sl = item % num_slabs;
      const int b0 = blk_start[t];
      const int b1 = blk_start[t + 1];
      if (b0 == b1) continue;  // no block maps here: the tile keeps out_init
      const long long end = (long long)b1 * blk;
      for (long long c0 = (long long)b0 * blk; c0 < end; c0 += chunk, ++seq) {
        const int m = seq % kMetaStages;
        mbar_wait(&mempty[m], ((seq / kMetaStages) & 1) ^ 1);
        if (lane32 == 0) {
          const int n = (int)min((long long)chunk, end - c0);
          int* h = mhdr + m * kHdrInts;
          h[0] = n;
          h[1] = t;
          h[2] = sl;
          h[3] = c0 + chunk >= end;  // the item's last chunk
          h[4] = (int)c0;  // the wrapper keeps the stream below 2^31
          mttkrp_common::mbar_arrive_expect_tx(&mfull[m], n * 8);
          mttkrp_common::bulk_g2s(mval + (size_t)m * chunk, vals + c0, n * 4,
                                  &mfull[m]);
          mttkrp_common::bulk_g2s(mrow + (size_t)m * chunk, lrow + c0, n * 4,
                                  &mfull[m]);
        }
        __syncwarp();
      }
    }
    const int m = seq % kMetaStages;  // the end marker
    mbar_wait(&mempty[m], ((seq / kMetaStages) & 1) ^ 1);
    if (lane32 == 0) {
      mhdr[m * kHdrInts] = -1;
      mbar_arrive(&mfull[m]);
    }
  } else if (threadIdx.x >= consumers) {
    // ---- the row warp: each chunk's stages that hold a nonzero, copied
    // into the ring ----
    const int shift = __ffs(slots) - 1;  // slots is a power of two
    const unsigned row_bytes = slab * sizeof(T);
    int rseq = 0;
    // Wait for ring stage rseq to be free, and write its header.
    auto open_stage = [&](int m, int off, int cnt, int flags, int t,
                          int sl) {
      const int s = rseq % stages;
      mbar_wait(&empty[s], ((rseq / stages) & 1) ^ 1);
      if (lane32 == 0) {
        int* h = rhdr + s * kHdrInts;
        h[0] = m;
        h[1] = off;
        h[2] = cnt;
        h[3] = flags;
        h[4] = t;
        h[5] = sl;
      }
      return s;
    };
    for (int cseq = 0;; ++cseq) {
      const int m = cseq % kMetaStages;
      mbar_wait(&mfull[m], (cseq / kMetaStages) & 1);
      const int* mh = mhdr + m * kHdrInts;
      const int n = mh[0];
      if (n < 0) {
        const int s = open_stage(0, 0, 0, kEnd, 0, 0);
        if (lane32 == 0) mbar_arrive(&full[s]);
        break;
      }
      const int t = mh[1];
      const int sl = mh[2];
      const bool last_chunk = mh[3] != 0;
      const long long c0 = mh[4];
      // Stages of this chunk holding a nonzero (chunk / slots <= 64).
      const float* cv = mval + (size_t)m * chunk;
      unsigned long long live = 0;
      for (int j = lane32; j < n; j += 32)
        if (cv[j] != 0.0f) live |= 1ull << (j >> shift);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        live |= __shfl_xor_sync(0xffffffffu, live, o);
      if (live == 0) {
        if (last_chunk) {  // the item still ends: one stage without rows
          const int s = open_stage(m, 0, 0, kRelease | kItemEnd, t, sl);
          if (lane32 == 0) mbar_arrive(&full[s]);
          ++rseq;
        } else if (lane32 == 0) {  // padding only: back to the meta warp
          mttkrp_common::mbar_arrive_n(&mempty[m], consumer_warps);
        }
        __syncwarp();
        continue;
      }
      const int top = 63 - __clzll(live);
      for (int q = 0; q <= top; ++q) {
        if (!((live >> q) & 1)) continue;
        const int off = q << shift;
        const int cnt = min(slots, n - off);
        const int flags =
            q == top ? kRelease | (last_chunk ? kItemEnd : 0) : 0;
        const int s = open_stage(m, off, cnt, flags, t, sl);
        T* dst = ring + (size_t)s * stage_elems;
        const long long i0 = c0 + off;
        if (ld == slab) {
          // The K slices are contiguous: one bulk copy each.
          if (lane32 == 0) {
            const unsigned bytes = cnt * row_bytes;
            mttkrp_common::mbar_arrive_expect_tx(&full[s], K * bytes);
#pragma unroll
            for (int w = 0; w < K; ++w)
              mttkrp_common::bulk_g2s(dst + (size_t)w * slots * slab,
                                      rs.ptr[w] + i0 * ld, bytes, &full[s]);
          }
        } else {
          // Boxes of at most kBoxRows rows x `slab` columns, `slots` rows
          // per row array; rows past `cnt` (the next run's, or zeros past
          // the array's end) land too and are never read.
          if (lane32 == 0) {
            const int box = min(slots, kBoxRows);
            mttkrp_common::mbar_arrive_expect_tx(&full[s],
                                                 K * slots * row_bytes);
#pragma unroll
            for (int w = 0; w < K; ++w)
              for (int b = 0; b < slots; b += box)
                tensor_g2s(dst + ((size_t)w * slots + b) * slab,
                           &maps.map[w], sl * slab, (int)i0 + b, &full[s]);
          }
        }
        __syncwarp();
        ++rseq;
      }
    }
  } else {
    // ---- the consumer warps: B1's accumulation, stage by stage ----
    const int g = threadIdx.x / lanes;
    const int lane = threadIdx.x % lanes;
    const bool adds = g < groups;
    float* mine = part + g * pstride;
    for (int rseq = 0;; ++rseq) {
      const int s = rseq % stages;
      mbar_wait(&full[s], (rseq / stages) & 1);
      const int* h = rhdr + s * kHdrInts;
      const int flags = h[3];
      if (flags & kEnd) break;
      const int m = h[0];
      const int cnt = h[2];
      const int t = h[4];
      const int sl = h[5];
      const float* sv = mval + (size_t)m * chunk + h[1];
      const int* sr = mrow + (size_t)m * chunk + h[1];
      const T* rows = ring + s * stage_elems;
      // Group g adds the stage's slots g, g+groups, ... in order (the
      // stage starts at a multiple of groups in the tile's run).
      for (int j0 = adds ? g : cnt; j0 < cnt; j0 += groups * kUnroll) {
        float v[kUnroll];
        int r[kUnroll];
        int at[kUnroll];  // slot u's row within the stage's slices
        bool use[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + u * groups;
          v[u] = j < cnt ? sv[j] : 0.0f;
          use[u] = v[u] != 0.0f;  // padding adds nothing
          r[u] = use[u] ? sr[j] : 0;
          use[u] = use[u] && (unsigned)r[u] < (unsigned)tile_rows;
          at[u] = use[u] ? j : 0;
        }
        for (int c = lane; c < slab; c += lanes) {
          float p[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            p[u] = v[u];
#pragma unroll
            for (int w = 0; w < K; ++w)
              p[u] = __fmul_rn(
                  p[u], use[u] ? mttkrp_common::to_f32(
                                     rows[(w * slots + at[u]) * slab + c])
                               : 0.0f);
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (use[u]) {
              float* dst = mine + r[u] * slab + c;
              *dst = __fadd_rn(*dst, p[u]);
            }
          }
        }
      }
      __syncwarp();
      if (lane32 == 0) {
        mbar_arrive(&empty[s]);
        if (flags & kRelease) mbar_arrive(&mempty[m]);
      }
      if (flags & kItemEnd) {
        // The ring already fills with the next item's stages.
        consumer_sync(consumers);
        mttkrp_common::reduce_partials_and_clear(
            part, groups, tile_elems, pstride, slab,
            out + (long long)t * tile_rows * ld + (long long)sl * slab, ld,
            threadIdx.x, consumers);
        consumer_sync(consumers);
      }
    }
  }
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


// cuTensorMapEncodeTiled, looked up at run time.
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

cudaError_t encode_tiled_fn(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// The 2-D map of one (n_rows, ld) row array with a box of `rows` rows x
// `slab` columns, no swizzle (the box lands as [rows][slab]), zeros past
// the array's end.
template <typename T>
cudaError_t encode_rows(CUtensorMap* map, const T* rows, long long n_rows,
                        int ld, int slab, int box_rows) {
  EncodeTiledFn encode;
  const cudaError_t e = encode_tiled_fn(&encode);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[2] = {(cuuint64_t)ld, (cuuint64_t)n_rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)slab, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map,
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<T*>(rows), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int K, typename T>
cudaError_t launch_fused_k(const float* vals, const RowSet<T>& rs,
                           const int* lrow, const int* blk_start, float* out,
                           int* next_item, int num_tiles, int num_slabs,
                           int blk, int tile_rows, int ld, int slab,
                           int groups, int lanes, int n_slots, int stages,
                           int slots, cudaStream_t stream) {
  if (stages < 1 || slots < 16 || slots < groups || kMetaChunk % slots ||
      (slots & (slots - 1)))
    return cudaErrorInvalidValue;
  TensorMaps maps = {};
  if (ld != slab) {
    if (slab > kBoxRows) return cudaErrorInvalidValue;
    for (int w = 0; w < K; ++w) {
      const cudaError_t e = encode_rows(&maps.map[w], rs.ptr[w], n_slots, ld,
                                        slab, min(slots, kBoxRows));
      if (e != cudaSuccess) return e;
    }
  }
  const size_t smem =
      fused_smem(K, sizeof(T), groups, tile_rows, slab, stages, slots);
  const auto kernel = fused_mttkrp_kernel<K, T>;
  cudaError_t e = mttkrp_common::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int threads = consumer_threads(groups, lanes) + 64;
  // Persistent CTAs: as many as are resident at once, or one per item.
  int device = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long items = (long long)num_tiles * num_slabs;
  const int grid = (int)min(items, (long long)sms * per_sm);
  if (grid < 1) return cudaSuccess;
  kernel<<<grid, threads, smem, stream>>>(
      vals, rs, maps, lrow, blk_start, out, next_item, num_tiles, num_slabs,
      blk, tile_rows, ld, slab, groups, lanes, stages, slots);
  return cudaGetLastError();
}

template <typename T>
int launch_fused(const void* vals, const void* r0, const void* r1,
                 const void* r2, const void* r3, const void* lrow,
                 const void* blk_start, void* out, void* next_item,
                 int num_in, int num_tiles, int num_slabs, int blk,
                 int tile_rows, int ld, int slab, int groups, int lanes,
                 int n_slots, int stages, int slots, void* stream) {
  RowSet<T> rs;
  const void* ptrs[kMaxInModes] = {r0, r1, r2, r3};
  for (int w = 0; w < kMaxInModes; ++w)
    rs.ptr[w] = static_cast<const T*>(ptrs[w]);
  const float* v = static_cast<const float*>(vals);
  const int* lr = static_cast<const int*>(lrow);
  const int* bs = static_cast<const int*>(blk_start);
  float* o = static_cast<float*>(out);
  int* ni = static_cast<int*>(next_item);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH_K(KK)                                                      \
  launch_fused_k<KK, T>(v, rs, lr, bs, o, ni, num_tiles, num_slabs, blk,  \
                        tile_rows, ld, slab, groups, lanes, n_slots,      \
                        stages, slots, s)
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
// success). r1..r3 are ignored beyond `num_in` input modes. `next_item`
// is one int holding 0 (the CTAs' work counter); `n_slots` is the stream's
// length; the ring has `stages` stages of `slots` slots (a power of two,
// at least 16 and a multiple of `groups`). The rows are float
// (fused_mttkrp_launch) or bf16 (fused_mttkrp_bf16_launch); every other
// argument is the same.
#define FUSED_ARGS                                                        \
  const void *vals, const void *r0, const void *r1, const void *r2,       \
      const void *r3, const void *lrow, const void *blk_start, void *out, \
      void *next_item, int num_in, int num_tiles, int num_slabs, int blk, \
      int tile_rows, int ld, int slab, int groups, int lanes,             \
      int n_slots, int stages, int slots, void *stream
#define FUSED_PASS                                                        \
  vals, r0, r1, r2, r3, lrow, blk_start, out, next_item, num_in,          \
      num_tiles, num_slabs, blk, tile_rows, ld, slab, groups, lanes,      \
      n_slots, stages, slots, stream

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
