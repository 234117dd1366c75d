// In-kernel-gather fused spMTTKRP for Hopper (sm_90a).
//
// Replaces repro/kernels/mttkrp/kernel.py:fused_mttkrp_nmode_gather (:632,
// pallas_call :711) and fused_mttkrp_nmode_gather_tiled (:728, pallas_call
// :799); the two share _fused_gather_body. One device function serves
// both: the untiled kernel is the case where the column slab is the whole
// padded rank; the tiled kernel adds a grid axis over column slabs
// (blockIdx.y).
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
// Element types. The factors are float, or bf16 (the reference's bf16
// gathers, kernel.py:664: bf16 factor operands, fp32 products and sums).
// Each kernel is instantiated for both, with one entry point each
// (gather_mttkrp_launch, gather_mttkrp_bf16_launch). A bf16 element
// becomes fp32 as it is loaded (exact), and each column sees the fp32
// kernel's operations in its order, so the bf16 variants of B1 and B2
// agree bitwise with each other and with the bf16 variants of B3, B4 and
// B6 on one aligned stream. The stream (values, local rows, indices) and
// the partial tiles' sums are the same in both; bf16 rows are loaded 16
// bytes a lane, by gather_mttkrp_vec_kernel at a slab of kVecMinSlab
// columns or more and by gather_mttkrp_narrow_kernel below it (below).
//
// What bounds it. Per nonzero the stream brings 4 B of value, 4 B of local
// row and 4 B per input mode of factor index: 16 B/nnz for a 3-mode tensor,
// read from HBM exactly once (the HBM bound). Each nonzero also gathers K
// factor rows of `slab` elements per slab (64 B each at R=16 in fp32; 32 B,
// one sector, in bf16) at random out of the 50 MB L2, where the factors
// stay: nnz * K * R * itemsize bytes through L2 (the L2 bound, against the
// card's measured L2 read rate). At R=16 in fp32 that is 128 B of rows per
// nonzero beside 16 B of stream, 8x the HBM bytes, so the L2 gathers,
// their latency and the run's serial phases are what bound the kernel.
//
// What the design does about it.
//  * The stream is read once and staged asynchronously: a CTA copies
//    kChunk slots at a time (values, local rows, K indices, all of them,
//    with 16-byte cp.async) into one of kBuffers = 2 shared-memory
//    buffers, so chunk c+1 lands while chunk c gathers; no HBM round trip
//    sits between two chunks' gathers. A chunk whose values are all zero
//    (padding) gathers nothing, decided from the staged values.
//  * CTAs take the output tiles last first (tile = num_tiles-1-blockIdx.x):
//    the all-padding blocks of the aligned stream are clipped onto the
//    last tile, so its run is the longest, and it now starts in the first
//    wave instead of running alone after the last. Its walk ends at its
//    last live block: live_end_kernel (mttkrp_common.cuh), launched first,
//    finds that block with the whole card, and run_end stops the walk
//    there, so the ~num_tiles x blk / 2 slots of padding behind it are
//    neither staged nor voted on.
//  * The factors are gathered straight from global memory through the
//    read-only path (L2-resident), and the TPU's one-hot MXU gather and
//    scatter are gone. Each group issues the factor loads of kUnroll slots
//    before it adds any of them, so several loads are in flight per thread.
//    A slot's rows are kept as 32-bit offsets into the factors, counted
//    in elements (the wrapper checks each has fewer than 2^31), not as 64-bit
//    pointers: the pointers' registers kept CTAs off the SMs, and cutting
//    them is what moved the time most (bench_torch/kernel_ablation.py).
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
//  * Wide bf16 slabs: 16-byte row loads. With a column a lane, a warp's
//    load of a row slab brings 64 bytes in bf16 against 128 in fp32, in
//    as many loads and L2 requests, so B2 moved half the bytes in the
//    same time. gather_mttkrp_vec_kernel gives each lane blocks of kVec
//    = 8 adjacent columns, each loaded with one 16-byte read (slab / 8
//    lanes a group, at most 32: kernel._gather_lanes): a row slab of 128
//    bf16 columns is one 16-lane load, 256 bytes in two L2 requests, and
//    a group loads the blocks of kUnrollBf16 / K slots before it adds.
//  * Narrow bf16 slabs (R=16 on the main path): gather_mttkrp_narrow_kernel.
//    A column a lane (the first bf16 kernel) kept 16 rows in flight a warp
//    and 5 CTAs an SM (the fp32 kernel's staging): ~640 random 32-byte
//    rows an SM, at 2.41 ms against a 0.67 ms L2 bound, the pace of fp32
//    B1 at twice the bytes; the rows in flight set it, not the bytes. Here a
//    group is slab / 8 lanes, each loading its 8 columns of a row with
//    one 16-byte read (a CTA is one warp at slab 16). A group walks its
//    slots of the run straight from device memory, with no staging and no
//    barrier: batch n+2's values, local rows and indices load into
//    registers while batch n+1's K rows per slot load and batch n adds
//    (kNarrowUnroll / K slots a batch), so the CTA's shared memory is its
//    partial tiles alone (8 KB at tile_rows 8) and the grid's tiles all
//    fit the SMs at once on the nell-2 stand-in's modes 0 and 1. Staging
//    the stream in shared memory as the wide kernels do, or the rows in a
//    cp.async ring of 2 or 4 batches (the rows then hold no register), was
//    no faster: those designs are kept as source text in
//    bench_torch/gather_mttkrp_designs.cu, which
//    bench_torch/kernel_ablation.py times. What bounds it now is the rate
//    of random 32-byte L2 reads an SM sustains (bench_torch/copy_rate.py's
//    rows lines), not the 7 TB/s the L2 gives whole lines at. Its partial
//    tiles are laid out by group row, row r of group g at (r * groups + g)
//    x slab floats, and swizzled (narrow_swizzle): a lane's columns
//    8l..8l+3 and 8l+4..8l+7 sit in the row's halves swz and 1 - swz, so
//    the 16-byte adds of one shared-memory phase fall on 8 distinct groups
//    of banks whatever the rows. The sums are add_products' and
//    reduce_partials_into's, in order.
//
// Shared memory (kernel.gather_smem_bytes): groups x tile_rows x slab
// floats of partial tiles, then kBuffers staging buffers, each kChunk
// values, kChunk local rows and kChunk x K indices (4 bytes each); for the
// narrow kernel the partial tiles alone.
// The wrapper checks that vals, idx and local rows are 16-byte aligned and
// blk a multiple of 4, so every 16-byte piece is aligned.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ../build.py); bound with ctypes.

#include <type_traits>

#include "mttkrp_common.cuh"


namespace {

template <typename T>
using FactorSet = mttkrp_common::FactorSet<T>;
// Slots of the stream one staging buffer holds (a multiple of every
// `groups`, <= 16). No __launch_bounds__: on the H100 it made the
// wide-slab kernel slower; at <= 96 registers a 512-thread CTA fits, and a
// refused launch is reported by the wrapper.
constexpr int kChunk = 1024;
constexpr int kBuffers = 2;
// Slots of one group whose factor loads are in flight together.
constexpr int kUnroll = 4;
// bf16 at slabs of kVecMinSlab columns or more: columns one 16-byte load
// brings, and a batch's slots times the input modes (kUnrollBf16 / K
// slots of K row blocks: 32 registers of loaded rows, so a 512-thread
// CTA, at slab 256, still fits the SM's registers).
constexpr int kVec = 8;
constexpr int kVecMinSlab = 64;
constexpr int kUnrollBf16 = 8;
// bf16 at slabs under kVecMinSlab (gather_mttkrp_narrow_kernel): a
// batch's slots times the input modes (kNarrowUnroll / K slots of K
// 16-byte row blocks a lane); two batches are in flight.
constexpr int kNarrowUnroll = 8;

// The output tile a CTA owns: the last first (see above).
__device__ __forceinline__ int cta_tile() {
  return gridDim.x - 1 - blockIdx.x;
}

// One bf16 group's adds for a batch of U slots: for each block of kVec
// columns c..c+7 this lane owns (c = 8 * lane, 8 * (lane + lanes), ...),
// the slots' K row blocks are loaded with one 16-byte read each, all of
// the batch's before its first add; then, slot by slot in order, each
// column's product v[u] * row(u,0)[c] * ... (left to right, __fmul_rn) is
// added with __fadd_rn into row r[u] of the partial tile: per column the
// operations of add_products.
template <int K, int U>
__device__ __forceinline__ void add_products_bf16x8(
    const float (&v)[U], const int (&r)[U], const int (&off)[U][K],
    const bool (&use)[U], const FactorSet<__nv_bfloat16>& fs, float* mine,
    int slab, int lane, int lanes) {
  for (int c = lane * kVec; c < slab; c += lanes * kVec) {
    uint4 x[U][K];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int w = 0; w < K; ++w)
        x[u][w] = use[u] ? __ldg(reinterpret_cast<const uint4*>(
                               fs.ptr[w] + off[u][w] + c))
                         : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!use[u]) continue;
      float p[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) p[e] = v[u];
#pragma unroll
      for (int w = 0; w < K; ++w) {
        float f[kVec];
        mttkrp_common::bf16x8_to_f32(x[u][w], f);
#pragma unroll
        for (int e = 0; e < kVec; ++e) p[e] = __fmul_rn(p[e], f[e]);
      }
      float4* dst = reinterpret_cast<float4*>(mine + r[u] * slab + c);
      float4 a = dst[0];
      float4 b = dst[1];
      a.x = __fadd_rn(a.x, p[0]);
      a.y = __fadd_rn(a.y, p[1]);
      a.z = __fadd_rn(a.z, p[2]);
      a.w = __fadd_rn(a.w, p[3]);
      b.x = __fadd_rn(b.x, p[4]);
      b.y = __fadd_rn(b.y, p[5]);
      b.z = __fadd_rn(b.z, p[6]);
      b.w = __fadd_rn(b.w, p[7]);
      dst[0] = a;
      dst[1] = b;
    }
  }
}

// Issue the copies of slots [base, base + cnt) (cnt a multiple of 4) into
// one staging buffer, and commit them as one group.
template <int K>
__device__ __forceinline__ void stage_chunk(const float* vals, const int* idx,
                                            const int* lrow, long long base,
                                            int cnt, float* s_val, int* s_row,
                                            int* s_idx) {
  const int pieces = cnt / 4;
  for (int p = threadIdx.x; p < pieces; p += blockDim.x) {
    mttkrp_common::cp_async16(s_val + 4 * p, vals + base + 4 * p);
    mttkrp_common::cp_async16(s_row + 4 * p, lrow + base + 4 * p);
  }
  for (int p = threadIdx.x; p < pieces * K; p += blockDim.x)
    mttkrp_common::cp_async16(s_idx + 4 * p, idx + base * K + 4 * p);
  mttkrp_common::cp_async_commit();
}

// The staged kernels' body: kVecRows (bf16 only) loads rows in 16-byte
// blocks of kVec columns a lane (add_products_bf16x8), else a column a
// lane (add_products).
template <int K, typename T, bool kVecRows>
__device__ __forceinline__ void gather_body(
    const float* __restrict__ vals, const int* __restrict__ idx,
    const int* __restrict__ lrow, const int* __restrict__ blk_start,
    const FactorSet<T>& fs, float* __restrict__ out, int blk, int tile_rows,
    int ld, int slab, int groups, int lanes) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tile_elems = tile_rows * slab;
  float* part = smem;
  // Staging buffer q: values, local rows, K indices of kChunk slots.
  float* stage = part + (size_t)groups * tile_elems;
  constexpr int kBufFloats = kChunk * (2 + K);

  const int t = cta_tile();
  const int col0 = blockIdx.y * slab;
  const int b0 = blk_start[t];
  if (b0 == blk_start[t + 1]) return;  // no block maps here: out_init stays
  const int b1 = mttkrp_common::run_end(blk_start, t, gridDim.x);

  for (int e = threadIdx.x; e < groups * tile_elems; e += blockDim.x)
    part[e] = 0.0f;

  const int g = threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  float* mine = part + (size_t)g * tile_elems;
  const long long first = (long long)b0 * blk;
  const long long end = (long long)b1 * blk;
  const int nchunks = (int)((end - first + kChunk - 1) / kChunk);
  auto buf_val = [&](int q) { return stage + (size_t)q * kBufFloats; };
  auto buf_row = [&](int q) {
    return reinterpret_cast<int*>(buf_val(q) + kChunk);
  };
  auto buf_idx = [&](int q) { return buf_row(q) + kChunk; };
  auto count = [&](int c) {
    const long long left = end - first - (long long)c * kChunk;
    return (int)(left < kChunk ? left : kChunk);
  };

  stage_chunk<K>(vals, idx, lrow, first, count(0), buf_val(0), buf_row(0),
                 buf_idx(0));
  for (int c = 0; c < nchunks; ++c) {
    const int q = c % kBuffers;
    const int cnt = count(c);
    // Chunk c+1's copies fly while chunk c gathers. Its buffer was last
    // read in iteration c-1, before that iteration's closing barrier.
    if (c + 1 < nchunks) {
      const int qn = (c + 1) % kBuffers;
      stage_chunk<K>(vals, idx, lrow, first + (long long)(c + 1) * kChunk,
                     count(c + 1), buf_val(qn), buf_row(qn), buf_idx(qn));
      mttkrp_common::cp_async_wait<1>();
    } else {
      mttkrp_common::cp_async_wait<0>();
    }
    const float* s_val = buf_val(q);
    const int* s_row = buf_row(q);
    const int* s_idx = buf_idx(q);
    // This thread's own pieces of the values have landed; the vote is also
    // the barrier after which every thread's pieces are visible. A chunk
    // of padding only is skipped as a whole.
    int any = 0;
    for (int p = threadIdx.x; p < cnt / 4; p += blockDim.x) {
      const float4 v = reinterpret_cast<const float4*>(s_val)[p];
      any |= (v.x != 0.0f) | (v.y != 0.0f) | (v.z != 0.0f) | (v.w != 0.0f);
    }
    if (!__syncthreads_or(any)) continue;

    // Group g takes the chunk's slots g, g+groups, ... (kChunk is a
    // multiple of groups, so across chunks it walks every groups-th slot
    // of the tile's run in order), kUnroll slots at a time: the factor
    // loads of a batch are issued before its adds, which run in slot order.
    if constexpr (kVecRows) {
      constexpr int U = kUnrollBf16 / K > 0 ? kUnrollBf16 / K : 1;
      for (int j0 = g; j0 < cnt; j0 += groups * U) {
        float v[U];
        int r[U];
        int off[U][K];  // slot u's row offset in factor w
        bool use[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + u * groups;
          v[u] = j < cnt ? s_val[j] : 0.0f;
          use[u] = v[u] != 0.0f;
          r[u] = use[u] ? s_row[j] : 0;
          use[u] = use[u] && (unsigned)r[u] < (unsigned)tile_rows;
#pragma unroll
          for (int w = 0; w < K; ++w) {
            const int ix = use[u] ? s_idx[j * K + w] : 0;
            use[u] = use[u] && (unsigned)ix < (unsigned)fs.rows[w];
            off[u][w] = ix * ld + col0;
          }
        }
        add_products_bf16x8<K, U>(v, r, off, use, fs, mine, slab, lane,
                                  lanes);
      }
    } else
    for (int j0 = g; j0 < cnt; j0 += groups * kUnroll) {
      float v[kUnroll];
      int r[kUnroll];
      int at[kUnroll][K];  // slot u's row offset in factor w
      bool use[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * groups;
        v[u] = j < cnt ? s_val[j] : 0.0f;
        // Padding slots and out-of-range rows or indices add nothing.
        use[u] = v[u] != 0.0f;
        r[u] = use[u] ? s_row[j] : 0;
        use[u] = use[u] && (unsigned)r[u] < (unsigned)tile_rows;
#pragma unroll
        for (int w = 0; w < K; ++w) {
          const int ix = use[u] ? s_idx[j * K + w] : 0;
          use[u] = use[u] && (unsigned)ix < (unsigned)fs.rows[w];
          at[u][w] = ix * ld + col0;
        }
      }
      mttkrp_common::add_products<K, kUnroll>(
          v, r, [&](int u, int w) { return fs.ptr[w] + at[u][w]; }, use,
          mine, slab, lane, lanes);
    }
    __syncthreads();  // chunk c+2's copies overwrite this buffer
  }

  // Fixed-order reduction of the group partials into the output tile.
  mttkrp_common::reduce_partials_into(
      part, groups, tile_elems, slab,
      out + (long long)t * tile_rows * ld + col0, ld);
}

// Slots of one narrow batch.
template <int K>
__host__ __device__ constexpr int narrow_batch() {
  return kNarrowUnroll / K > 0 ? kNarrowUnroll / K : 1;
}

// The swizzle of group g's bf16 row blocks: a lane's first 4 columns sit
// in the row's half swz (of 4 * lanes floats each), its last 4 in the
// other half, so that the 8 lanes of a phase (groups 4i..4i+3 at slab 16,
// 2i..2i+1 at slab 32) fall on 8 different groups of 4 banks whatever
// their rows. (None at slab 48.)
__device__ __forceinline__ int narrow_swizzle(int g, int lanes) {
  return lanes == 2 ? (g >> 1) & 1 : lanes == 4 ? g & 1 : 0;
}

// A narrow batch of U slots: their values, local rows and use flags, and
// the K 16-byte row blocks of each (this lane's 8 columns 8 * lane ..).
template <int K, int U>
struct NarrowBatch {
  float v[U];
  int r[U];
  bool use[U];
  uint4 x[U][K];
};

// A batch's values, local rows and indices, as read from the stream.
template <int K, int U>
struct NarrowMeta {
  float v[U];
  int r[U];
  int ix[U][K];
};

// Read the batch's slots j0, j0 + groups, ... of the run starting at slot
// `first` from device memory (read once: ld.global.cs); a slot at or past
// `n` reads nothing and holds value 0.
template <int K, int U>
__device__ __forceinline__ void narrow_meta(
    NarrowMeta<K, U>& m, const float* __restrict__ vals,
    const int* __restrict__ idx, const int* __restrict__ lrow,
    long long first, long long n, long long j0, int groups) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long j = j0 + (long long)u * groups;
    const bool in = j < n;
    m.v[u] = in ? __ldcs(vals + first + j) : 0.0f;
    m.r[u] = in ? __ldcs(lrow + first + j) : 0;
#pragma unroll
    for (int w = 0; w < K; ++w)
      m.ix[u][w] = in ? __ldcs(idx + (first + j) * K + w) : 0;
  }
}

// The batch from its meta: issue its row loads (a slot of padding, or
// with an out-of-range row or index, loads and adds nothing).
template <int K, int U>
__device__ __forceinline__ void narrow_issue(
    NarrowBatch<K, U>& bt, const NarrowMeta<K, U>& m,
    const FactorSet<__nv_bfloat16>& fs, int tile_rows, int ld, int col0,
    int lane) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    bt.v[u] = m.v[u];
    bt.r[u] = m.r[u];
    bool use = m.v[u] != 0.0f && (unsigned)m.r[u] < (unsigned)tile_rows;
#pragma unroll
    for (int w = 0; w < K; ++w)
      use = use && (unsigned)m.ix[u][w] < (unsigned)fs.rows[w];
    bt.use[u] = use;
#pragma unroll
    for (int w = 0; w < K; ++w)
      bt.x[u][w] = use ? __ldg(reinterpret_cast<const uint4*>(
                             fs.ptr[w] + m.ix[u][w] * ld + col0 +
                             lane * kVec))
                       : make_uint4(0u, 0u, 0u, 0u);
  }
}

// The batch's adds, slot by slot in order: each column's product
// v[u] * row(u,0)[c] * ... (left to right, __fmul_rn) is added with
// __fadd_rn into row r[u] of the group's partial tile: per column the
// operations of add_products. Row r of group g's partial tile starts at
// part + (r * groups + g) * slab; a lane's columns 8l..8l+3 sit at float
// 4 (swz * lanes + l) of it and 8l+4..8l+7 at 4 ((1 - swz) * lanes + l),
// swz = narrow_swizzle(g, lanes) (narrow_col).
template <int K, int U>
__device__ __forceinline__ void narrow_add(const NarrowBatch<K, U>& bt,
                                           float* part, int g, int groups,
                                           int slab, int lane, int lanes) {
  const int swz = narrow_swizzle(g, lanes);
  const int qa = swz * lanes + lane, qb = (1 - swz) * lanes + lane;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (!bt.use[u]) continue;
    float p[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) p[e] = bt.v[u];
#pragma unroll
    for (int w = 0; w < K; ++w) {
      float f[kVec];
      mttkrp_common::bf16x8_to_f32(bt.x[u][w], f);
#pragma unroll
      for (int e = 0; e < kVec; ++e) p[e] = __fmul_rn(p[e], f[e]);
    }
    float4* row = reinterpret_cast<float4*>(
        part + (size_t)(bt.r[u] * groups + g) * slab);
    float4 a = row[qa];
    float4 b = row[qb];
    a.x = __fadd_rn(a.x, p[0]);
    a.y = __fadd_rn(a.y, p[1]);
    a.z = __fadd_rn(a.z, p[2]);
    a.w = __fadd_rn(a.w, p[3]);
    b.x = __fadd_rn(b.x, p[4]);
    b.y = __fadd_rn(b.y, p[5]);
    b.z = __fadd_rn(b.z, p[6]);
    b.w = __fadd_rn(b.w, p[7]);
    row[qa] = a;
    row[qb] = b;
  }
}

// Float offset, within a group row of group g in the narrow layout, of
// column c.
__device__ __forceinline__ int narrow_col(int c, int lanes, int g) {
  const int q = c / 4;
  return (((q % 2) ^ narrow_swizzle(g, lanes)) * lanes + q / 2) * 4 + c % 4;
}

// The narrow kernel's body (bf16 factors, slab / 8 lanes a group). Each
// group walks its slots of the run straight from device memory: batch n+2's
// values, local rows and indices load into registers while batch n+1's
// rows load and batch n adds, with no staging and no barrier. Then
// reduce_partials_into's sums for the narrow layout, in the same order
// 0..groups-1, element by element.
template <int K>
__device__ __forceinline__ void narrow_body(
    const float* __restrict__ vals, const int* __restrict__ idx,
    const int* __restrict__ lrow, const int* __restrict__ blk_start,
    const FactorSet<__nv_bfloat16>& fs, float* __restrict__ out, int blk,
    int tile_rows, int ld, int slab, int groups, int lanes) {
  extern __shared__ float4 smem4[];
  float* part = reinterpret_cast<float*>(smem4);
  const int part_floats = tile_rows * groups * slab;

  const int t = cta_tile();
  const int col0 = blockIdx.y * slab;
  const int b0 = blk_start[t];
  if (b0 == blk_start[t + 1]) return;  // no block maps here: out_init stays
  const int b1 = mttkrp_common::run_end(blk_start, t, gridDim.x);

  for (int e = threadIdx.x; e < part_floats; e += blockDim.x) part[e] = 0.0f;

  const int g = threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  const long long first = (long long)b0 * blk;
  const long long n = (long long)b1 * blk - first;
  constexpr int U = narrow_batch<K>();
  const long long step = (long long)groups * U;
  const long long batches = (n - g + step - 1) / step;
  NarrowMeta<K, U> ma, mb;
  NarrowBatch<K, U> a, b;
  auto meta = [&](NarrowMeta<K, U>& m, long long i) {
    narrow_meta<K, U>(m, vals, idx, lrow, first, n, g + i * step, groups);
  };
  auto issue = [&](NarrowBatch<K, U>& bt, const NarrowMeta<K, U>& m) {
    narrow_issue<K, U>(bt, m, fs, tile_rows, ld, col0, lane);
  };
  auto add = [&](const NarrowBatch<K, U>& bt) {
    narrow_add<K, U>(bt, part, g, groups, slab, lane, lanes);
  };
  __syncthreads();  // the partial tiles are zeroed
  meta(ma, 0);
  meta(mb, 1);
  issue(a, ma);
  meta(ma, 2);
  for (long long i = 0; i < batches; i += 2) {
    issue(b, mb);
    meta(mb, i + 3);
    add(a);
    if (i + 1 >= batches) break;
    issue(a, ma);
    meta(ma, i + 4);
    add(b);
  }
  __syncthreads();  // every group's adds are in

  float* tile_out = out + (long long)t * tile_rows * ld + col0;
  for (int e = threadIdx.x; e < tile_rows * slab; e += blockDim.x) {
    const int row = e / slab, c = e % slab;
    const float* src = part + (size_t)row * groups * slab;
    float acc = src[narrow_col(c, lanes, 0)];
    for (int h = 1; h < groups; ++h)
      acc = __fadd_rn(acc, src[h * slab + narrow_col(c, lanes, h)]);
    float* o = tile_out + (long long)row * ld + c;
    *o = __fadd_rn(*o, acc);
  }
}

#define GATHER_KERNEL_ARGS                                                 \
  const float *__restrict__ vals, const int *__restrict__ idx,             \
      const int *__restrict__ lrow, const int *__restrict__ blk_start,     \
      FactorSet<T> fs, float *__restrict__ out, int blk, int tile_rows,    \
      int ld, int slab, int groups, int lanes
#define GATHER_KERNEL_PASS                                                 \
  vals, idx, lrow, blk_start, fs, out, blk, tile_rows, ld, slab, groups,   \
      lanes

// A column a lane: float factors.
template <int K, typename T>
__global__ void gather_mttkrp_kernel(GATHER_KERNEL_ARGS) {
  gather_body<K, T, false>(GATHER_KERNEL_PASS);
}

// bf16 factors at slabs of kVecMinSlab columns or more: 16-byte row loads.
template <int K, typename T>
__global__ void gather_mttkrp_vec_kernel(GATHER_KERNEL_ARGS) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "bf16 rows only");
  gather_body<K, T, true>(GATHER_KERNEL_PASS);
}

// bf16 factors at slabs under kVecMinSlab: 16-byte row loads, a group of
// slab / 8 lanes, the stream read into registers.
template <int K, typename T>
__global__ void gather_mttkrp_narrow_kernel(GATHER_KERNEL_ARGS) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "bf16 rows only");
  narrow_body<K>(GATHER_KERNEL_PASS);
}

// live_end_kernel, then `kernel` over the tiles and slabs.
template <typename T, typename Kernel>
cudaError_t launch_kernel(Kernel kernel, size_t smem, const float* vals,
                          const int* idx, const int* lrow, int* blk_start,
                          const FactorSet<T>& fs, float* out, int num_tiles,
                          int num_slabs, int blk, int tile_rows, int ld,
                          int slab, int groups, int lanes, long long n_pad,
                          cudaStream_t stream) {
  cudaError_t e = mttkrp_common::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  e = mttkrp_common::launch_live_end(vals, blk_start, num_tiles, blk, n_pad,
                                     stream);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(num_tiles, num_slabs), groups * lanes, smem, stream>>>(
      vals, idx, lrow, blk_start, fs, out, blk, tile_rows, ld, slab, groups,
      lanes);
  return cudaGetLastError();
}

template <int K, typename T>
cudaError_t launch_k(const float* vals, const int* idx, const int* lrow,
                     int* blk_start, const FactorSet<T>& fs, float* out,
                     int num_tiles, int num_slabs, int blk, int tile_rows,
                     int ld, int slab, int groups, int lanes, long long n_pad,
                     cudaStream_t stream) {
  // Shared memory (kernel.gather_smem_bytes): the partial tiles, then the
  // staging buffers (none in the narrow kernel).
  const size_t partials = (size_t)groups * tile_rows * slab * sizeof(float);
  const size_t staged =
      partials + (size_t)kBuffers * kChunk * (2 + K) * sizeof(float);
#define LAUNCH(KERNEL, SMEM)                                               \
  launch_kernel<T>(KERNEL<K, T>, SMEM, vals, idx, lrow, blk_start, fs,   \
                   out, num_tiles, num_slabs, blk, tile_rows, ld, slab,    \
                   groups, lanes, n_pad, stream)
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (slab >= kVecMinSlab)
      return LAUNCH(gather_mttkrp_vec_kernel, staged);
    return LAUNCH(gather_mttkrp_narrow_kernel, partials);
  } else {
    return LAUNCH(gather_mttkrp_kernel, staged);
  }
#undef LAUNCH
}

template <typename T>
int launch(const void* vals, const void* idx, const void* lrow,
           void* blk_start, const void* f0, const void* f1, const void* f2,
           const void* f3, int rows0, int rows1, int rows2, int rows3,
           void* out, int num_in, int num_tiles, int num_slabs, int blk,
           int tile_rows, int ld, int slab, int groups, int lanes,
           long long n_pad, void* stream) {
  const FactorSet<T> fs = mttkrp_common::make_factor_set<T>(
      f0, f1, f2, f3, rows0, rows1, rows2, rows3);
  const float* v = static_cast<const float*>(vals);
  const int* ix = static_cast<const int*>(idx);
  const int* lr = static_cast<const int*>(lrow);
  int* bs = static_cast<int*>(blk_start);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH_K(KK)                                                       \
  launch_k<KK, T>(v, ix, lr, bs, fs, o, num_tiles, num_slabs, blk,         \
                  tile_rows, ld, slab, groups, lanes, n_pad, s)
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
// f1..f3 / rows1..rows3 are ignored beyond `num_in` input modes. The
// factors are float (gather_mttkrp_launch) or bf16
// (gather_mttkrp_bf16_launch; they are 16-byte aligned and `lanes` = slab
// / 8, at most 32); every other argument is the same. `blk_start` points
// at num_tiles + 1 tile starts, preceded by an int that holds 0: the live
// end of the last tile's run is written there (live_end_kernel, launched
// first) and the last tile's walk stops at it; `n_pad` is the stream's
// length in slots.
#define GATHER_ARGS                                                        \
  const void *vals, const void *idx, const void *lrow, void *blk_start,    \
      const void *f0, const void *f1, const void *f2, const void *f3,      \
      int rows0, int rows1, int rows2, int rows3, void *out, int num_in,   \
      int num_tiles, int num_slabs, int blk, int tile_rows, int ld,        \
      int slab, int groups, int lanes, long long n_pad, void *stream
#define GATHER_PASS                                                        \
  vals, idx, lrow, blk_start, f0, f1, f2, f3, rows0, rows1, rows2, rows3,  \
      out, num_in, num_tiles, num_slabs, blk, tile_rows, ld, slab, groups, \
      lanes, n_pad, stream

extern "C" int gather_mttkrp_launch(GATHER_ARGS) {
  return launch<float>(GATHER_PASS);
}

extern "C" int gather_mttkrp_bf16_launch(GATHER_ARGS) {
  return launch<__nv_bfloat16>(GATHER_PASS);
}

// live_end_kernel alone (the cut the kernels above make): blk_start as
// above; blk_start[-1] must hold 0.
extern "C" int gather_mttkrp_live_end_launch(const void* vals,
                                              void* blk_start, int num_tiles,
                                              int blk, long long n_pad,
                                              void* stream) {
  return (int)mttkrp_common::launch_live_end(
      static_cast<const float*>(vals), static_cast<int*>(blk_start),
      num_tiles, blk, n_pad, static_cast<cudaStream_t>(stream));
}

extern "C" const char* gather_mttkrp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
