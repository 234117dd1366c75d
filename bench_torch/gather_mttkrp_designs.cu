// The design space of B1/B2's kernel for bf16 factors at narrow slabs,
// kept as source text for bench_torch/kernel_ablation.py and chip_smoke.py.
// It is not part of the port and the port never loads it.
//
// This is the port's src/repro_torch/kernels/mttkrp/csrc/gather_mttkrp.cu
// with gather_mttkrp_narrow_kernel's alternatives behind compile-time
// switches, which the ablation's text edits flip: kNarrowStaged (the
// stream staged in shared memory, as the wide kernels stage it),
// kNarrowRing (a per-lane cp.async ring of row batches: the rows in flight
// then hold no register), kNarrowPipelined (one batch in flight, not two),
// kNarrowSwizzle (false: padded partial rows), kNarrowCarveout, and the
// narrow kernel's float instantiation (4 columns a lane). None was faster
// than the port's design on the nell-2 stand-in (PERF.md, section 6). It
// also exports gather_mttkrp_bf16_column_launch: the first bf16 kernel (a
// column a lane, the fp32 kernel's staging) at any slab, the yardstick
// chip_smoke.py times the port's narrow kernel against. Its other extern
// "C" entry points are the port's, with the same arguments. Build it with
// the port's nvcc flags (build.NVCC_FLAGS) and
// -I src/repro_torch/kernels/mttkrp/csrc.
//
// The port's header as it stood with these switches follows.
//
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
//    no faster (kNarrowStaged, kNarrowRing: bench_torch/kernel_ablation.py).
//    What bounds it now is the rate of random 32-byte L2 reads an SM
//    sustains (bench_torch/copy_rate.py's rows lines), not the 7 TB/s the
//    L2 gives whole lines at. Its partial tiles are laid out by group
//    row, row r of group g at (r * groups + g) x narrow_row_floats(slab)
//    floats, and swizzled (narrow_swizzle): a lane's columns 8l..8l+3 and
//    8l+4..8l+7 sit in the row's halves swz and 1 - swz, so the 16-byte
//    adds of one shared-memory phase fall on 8 distinct groups of banks
//    whatever the rows. The sums are add_products' and
//    reduce_partials_into's, in order.
//
// Shared memory (kernel.gather_smem_bytes): groups x tile_rows x slab
// floats of partial tiles, then kBuffers staging buffers, each kChunk
// values, kChunk local rows and kChunk x K indices (4 bytes each); for the
// narrow kernel tile_rows x groups rows of narrow_row_floats(slab) floats,
// then each lane's ring of kNarrowRing batches (none: 0).
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
// 16-byte row blocks a lane), two batches in flight (kNarrowPipelined),
// each batch's values, local rows and indices read from device memory two
// batches ahead, into registers (kNarrowStaged false; true stages them in
// kNarrowBuffers shared-memory buffers of kNarrowChunk slots, as the wide
// kernels do), and partial rows swizzled (kNarrowSwizzle; false pads them).
// The alternatives are bench_torch/kernel_ablation.py's variants.
constexpr int kNarrowUnroll = 8;
constexpr bool kNarrowPipelined = true;
constexpr bool kNarrowStaged = false;
constexpr bool kNarrowSwizzle = true;
constexpr int kNarrowChunk = 256;
constexpr int kNarrowBuffers = 2;
// Batches of rows a lane keeps in flight in its own shared-memory ring,
// copied there by cp.async (an even count), or 0: two batches in
// registers. A ring of 2 or 4 was no faster on the nell-2 stand-in
// (bench_torch/kernel_ablation.py), so the rows stay in registers.
constexpr int kNarrowRing = 0;
// The narrow kernel's preferred shared-memory carveout, in percent of the
// most an SM has (-1: the CUDA runtime's choice); what is not carved out
// caches factor rows in L1.
constexpr int kNarrowCarveout = -1;

// Slots of one narrow batch.
template <int K>
__host__ __device__ constexpr int narrow_batch() {
  return kNarrowUnroll / K > 0 ? kNarrowUnroll / K : 1;
}

// Bytes of one lane's ring: kNarrowRing batches of K 16-byte row blocks
// and a value and a local row per slot.
template <int K>
__host__ __device__ constexpr int narrow_ring_lane_bytes() {
  return kNarrowRing * narrow_batch<K>() * (16 * K + 8);
}

// How B1/B2 load and add a factor row (kernel._gather_design): a column a
// lane (float factors), 16-byte blocks of 8 bf16 columns a lane at wide
// slabs, or the same at narrow slabs with their own staging and partial
// layout.
enum class Rows { kColumn, kVec, kNarrow };

template <Rows D>
struct Staging {
  static constexpr int chunk = kChunk;
  static constexpr int buffers = kBuffers;
};
template <>
struct Staging<Rows::kNarrow> {
  static constexpr int chunk = kNarrowStaged ? kNarrowChunk : 0;
  static constexpr int buffers = kNarrowStaged ? kNarrowBuffers : 0;
};

// Floats between two group rows of a narrow kernel's partial tiles: the
// slab (swizzled), or the slab and a pad that puts the 16-byte adds of the
// 8 lanes a shared-memory phase serves (4 groups of 2 lanes at slab 16, 2
// of 4 at slab 32) on 8 different groups of 4 banks whatever their rows.
__host__ __device__ constexpr int narrow_row_floats(int slab) {
  return kNarrowSwizzle ? slab : slab + (slab % 32 == 0 ? 16 : 8);
}

// The swizzle of group g's bf16 row blocks: a lane's first 4 columns sit
// in the row's half swz (of 4 * lanes floats each), its last 4 in the
// other half, so that, unpadded, the 8 lanes of a phase (groups 4i..4i+3
// at slab 16, 2i..2i+1 at slab 32) again fall on 8 different groups of 4
// banks whatever their rows. (None at slab 48.)
__device__ __forceinline__ int narrow_swizzle(int g, int lanes) {
  if (!kNarrowSwizzle) return 0;
  return lanes == 2 ? (g >> 1) & 1 : lanes == 4 ? g & 1 : 0;
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

// Columns of one 16-byte row block: 8 bf16, 4 float.
template <typename T>
__host__ __device__ constexpr int narrow_cols() {
  return std::is_same<T, float>::value ? 4 : kVec;
}

// One narrow group's batch of U slots: their values, local rows and use
// flags, and the K 16-byte row blocks of each (this lane's kCols =
// narrow_cols<T>() columns kCols * lane .. of a slab of kCols * lanes: 8
// bf16 columns; 4 float ones, which bench_torch/kernel_ablation.py times as
// a finding: the port runs float factors a column a lane).
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
template <int K, int U, typename T>
__device__ __forceinline__ void narrow_issue(
    NarrowBatch<K, U>& bt, const NarrowMeta<K, U>& m,
    const FactorSet<T>& fs, int tile_rows, int ld, int col0, int lane) {
  constexpr int kCols = narrow_cols<T>();
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
                             lane * kCols))
                       : make_uint4(0u, 0u, 0u, 0u);
  }
}

// The same from a staged chunk (kNarrowStaged): slots j0, j0 + groups, ...
// of the chunk's `cnt`.
template <int K, int U, typename T>
__device__ __forceinline__ void narrow_fetch(
    NarrowBatch<K, U>& bt, int j0, int cnt, const float* s_val,
    const int* s_row, const int* s_idx, const FactorSet<T>& fs, int groups,
    int tile_rows, int ld, int col0, int lane) {
  NarrowMeta<K, U> m;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = j0 + u * groups;
    m.v[u] = j < cnt ? s_val[j] : 0.0f;
    m.r[u] = m.v[u] != 0.0f ? s_row[j] : 0;
#pragma unroll
    for (int w = 0; w < K; ++w)
      m.ix[u][w] = m.v[u] != 0.0f ? s_idx[j * K + w] : 0;
  }
  narrow_issue<K, U, T>(bt, m, fs, tile_rows, ld, col0, lane);
}

// The batch's adds, slot by slot in order: each column's product
// v[u] * row(u,0)[c] * ... (left to right, __fmul_rn) is added with
// __fadd_rn into row r[u] of the group's partial tile: per column the
// operations of add_products. Row r of group g's partial tile starts at
// part + (r * groups + g) * rowf (narrow_row_floats); a bf16 lane's
// columns 8l..8l+3 sit at float 4 (swz * lanes + l) of it and 8l+4..8l+7
// at 4 ((1 - swz) * lanes + l), swz = narrow_swizzle(g, lanes)
// (narrow_col); a float lane's 4l..4l+3 at 4l.
template <int K, int U, typename T>
__device__ __forceinline__ void narrow_add(const NarrowBatch<K, U>& bt,
                                           float* part, int g, int groups,
                                           int rowf, int lane, int lanes) {
  constexpr int kCols = narrow_cols<T>();
  const int swz = kCols == kVec ? narrow_swizzle(g, lanes) : 0;
  const int qa = swz * lanes + lane, qb = (1 - swz) * lanes + lane;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (!bt.use[u]) continue;
    float p[kCols];
#pragma unroll
    for (int e = 0; e < kCols; ++e) p[e] = bt.v[u];
#pragma unroll
    for (int w = 0; w < K; ++w) {
      float f[kCols];
      if constexpr (kCols == kVec) {
        mttkrp_common::bf16x8_to_f32(bt.x[u][w], f);
      } else {
        f[0] = __uint_as_float(bt.x[u][w].x);
        f[1] = __uint_as_float(bt.x[u][w].y);
        f[2] = __uint_as_float(bt.x[u][w].z);
        f[3] = __uint_as_float(bt.x[u][w].w);
      }
#pragma unroll
      for (int e = 0; e < kCols; ++e) p[e] = __fmul_rn(p[e], f[e]);
    }
    float4* row = reinterpret_cast<float4*>(
        part + (size_t)(bt.r[u] * groups + g) * rowf);
    float4 a = row[qa];
    float4 b = kCols == kVec ? row[qb] : a;
    a.x = __fadd_rn(a.x, p[0]);
    a.y = __fadd_rn(a.y, p[1]);
    a.z = __fadd_rn(a.z, p[2]);
    a.w = __fadd_rn(a.w, p[3]);
    if constexpr (kCols == kVec) {
      b.x = __fadd_rn(b.x, p[4 % kCols]);
      b.y = __fadd_rn(b.y, p[5 % kCols]);
      b.z = __fadd_rn(b.z, p[6 % kCols]);
      b.w = __fadd_rn(b.w, p[7 % kCols]);
    }
    row[qa] = a;
    if constexpr (kCols == kVec) row[qb] = b;
  }
}

// The batch from its meta into slot d of the lane's ring (kNarrowRing):
// its row blocks by cp.async, its values (0 for a slot that adds nothing)
// and local rows by plain stores, then one commit group. Ring slot d of
// the CTA's `threads` lanes: row blocks rows[((d * U + u) * K + w) *
// threads + tid], values and rows vr[(d * U + u) * threads + tid], so a
// warp's lanes read adjacent 16 and 8 bytes.
template <int K, int U, typename T>
__device__ __forceinline__ void narrow_ring_issue(
    uint4* rows, int2* vr, int d, int threads, int tid,
    const NarrowMeta<K, U>& m, const FactorSet<T>& fs, int tile_rows,
    int ld, int col0, int lane) {
  constexpr int kCols = narrow_cols<T>();
#pragma unroll
  for (int u = 0; u < U; ++u) {
    bool use = m.v[u] != 0.0f && (unsigned)m.r[u] < (unsigned)tile_rows;
#pragma unroll
    for (int w = 0; w < K; ++w)
      use = use && (unsigned)m.ix[u][w] < (unsigned)fs.rows[w];
    vr[(d * U + u) * threads + tid] =
        make_int2(__float_as_int(use ? m.v[u] : 0.0f), m.r[u]);
    if (use) {
#pragma unroll
      for (int w = 0; w < K; ++w)
        mttkrp_common::cp_async16(
            rows + ((size_t)(d * U + u) * K + w) * threads + tid,
            fs.ptr[w] + m.ix[u][w] * ld + col0 + lane * kCols);
    }
  }
  mttkrp_common::cp_async_commit();
}

// Slot d of the lane's ring back as a batch (its copies have landed).
template <int K, int U>
__device__ __forceinline__ void narrow_ring_read(NarrowBatch<K, U>& bt,
                                                 const uint4* rows,
                                                 const int2* vr, int d,
                                                 int threads, int tid) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int2 e = vr[(d * U + u) * threads + tid];
    bt.v[u] = __int_as_float(e.x);
    bt.r[u] = e.y;
    bt.use[u] = bt.v[u] != 0.0f;
#pragma unroll
    for (int w = 0; w < K; ++w)
      bt.x[u][w] = bt.use[u]
                       ? rows[((size_t)(d * U + u) * K + w) * threads + tid]
                       : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Float offset, within a group row of group g in the narrow layout, of
// column c.
template <typename T>
__device__ __forceinline__ int narrow_col(int c, int lanes, int g) {
  if constexpr (narrow_cols<T>() == 4) return c;
  const int q = c / 4;
  return (((q % 2) ^ narrow_swizzle(g, lanes)) * lanes + q / 2) * 4 + c % 4;
}

// reduce_partials_into for the narrow layout: the same sums in the same
// order 0..groups-1, element by element.
template <typename T>
__device__ __forceinline__ void reduce_narrow_into(const float* part,
                                                   int groups, int tile_rows,
                                                   int slab, int lanes,
                                                   float* tile_out,
                                                   long long ld) {
  const int rowf = narrow_row_floats(slab);
  for (int e = threadIdx.x; e < tile_rows * slab; e += blockDim.x) {
    const int row = e / slab, c = e % slab;
    const float* src = part + (size_t)row * groups * rowf;
    float acc = src[narrow_col<T>(c, lanes, 0)];
    for (int h = 1; h < groups; ++h)
      acc = __fadd_rn(acc, src[h * rowf + narrow_col<T>(c, lanes, h)]);
    float* o = tile_out + (long long)row * ld + c;
    *o = __fadd_rn(*o, acc);
  }
}

// The kernels' body. D says how a row is loaded and added: a column a lane
// (add_products), or bf16 rows in 16-byte blocks of kVec columns a lane,
// at wide slabs (add_products_bf16x8) or narrow ones
// (add_products_narrow, with Staging<kNarrow>'s buffers).
template <int K, typename T, Rows D>
__device__ __forceinline__ void gather_body(
    const float* __restrict__ vals, const int* __restrict__ idx,
    const int* __restrict__ lrow, const int* __restrict__ blk_start,
    const FactorSet<T>& fs, float* __restrict__ out, int blk, int tile_rows,
    int ld, int slab, int groups, int lanes) {
  constexpr int kStageChunk = Staging<D>::chunk;
  constexpr int kStageBuffers = Staging<D>::buffers;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tile_elems = tile_rows * slab;
  const int rowf = narrow_row_floats(slab);
  const int part_floats =
      D == Rows::kNarrow ? tile_rows * groups * rowf : groups * tile_elems;
  float* part = smem;
  // Staging buffer q: values, local rows, K indices of kStageChunk slots.
  float* stage = part + part_floats;
  constexpr int kBufFloats = kStageChunk * (2 + K);

  const int t = gridDim.x - 1 - blockIdx.x;  // the last tile first
  const int col0 = blockIdx.y * slab;
  const int b0 = blk_start[t];
  if (b0 == blk_start[t + 1]) return;  // no block maps here: out_init stays
  const int b1 = mttkrp_common::run_end(blk_start, t, gridDim.x);

  for (int e = threadIdx.x; e < part_floats; e += blockDim.x) part[e] = 0.0f;

  const int g = threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  float* mine = part + (size_t)g * tile_elems;
  const long long first = (long long)b0 * blk;
  const long long end = (long long)b1 * blk;
  if constexpr (D == Rows::kNarrow && !kNarrowStaged) {
    // Each group walks its slots of the run straight from device memory:
    // batch n+2's values, local rows and indices load into registers while
    // batch n+1's rows load and batch n adds, with no staging and no
    // barrier.
    constexpr int U = narrow_batch<K>();
    const long long n = end - first;
    const long long step = (long long)groups * U;
    const long long batches = (n - g + step - 1) / step;
    NarrowMeta<K, U> ma, mb;
    NarrowBatch<K, U> a, b;
    auto meta = [&](NarrowMeta<K, U>& m, long long i) {
      narrow_meta<K, U>(m, vals, idx, lrow, first, n, g + i * step, groups);
    };
    auto issue = [&](NarrowBatch<K, U>& bt, const NarrowMeta<K, U>& m) {
      narrow_issue<K, U, T>(bt, m, fs, tile_rows, ld, col0, lane);
    };
    auto add = [&](const NarrowBatch<K, U>& bt) {
      narrow_add<K, U, T>(bt, part, g, groups, rowf, lane, lanes);
    };
    __syncthreads();  // the partial tiles are zeroed
    meta(ma, 0);
    meta(mb, 1);
    if constexpr (kNarrowRing > 0) {
      // Batch i's rows land in ring slot i % R by cp.async; batch i + R - 1
      // is issued before batch i is read back and added, so R - 1 batches
      // stay in flight without holding a register.
      constexpr int R = kNarrowRing;
      static_assert(R % 2 == 0, "the ring alternates two meta batches");
      const int threads = blockDim.x, tid = threadIdx.x;
      uint4* ring = reinterpret_cast<uint4*>(part + part_floats);
      int2* vr = reinterpret_cast<int2*>(ring + (size_t)R * U * K * threads);
      auto put = [&](long long i, const NarrowMeta<K, U>& m) {
        narrow_ring_issue<K, U, T>(ring, vr, (int)(i % R), threads, tid, m,
                                   fs, tile_rows, ld, col0, lane);
      };
      auto take = [&](long long i) {
        mttkrp_common::cp_async_wait<R - 1>();
        narrow_ring_read<K, U>(a, ring, vr, (int)(i % R), threads, tid);
        add(a);
      };
      for (int d = 0; d < R - 2; d += 2) {
        put(d, ma);
        meta(ma, d + 2);
        put(d + 1, mb);
        meta(mb, d + 3);
      }
      put(R - 2, ma);
      meta(ma, R);
      for (long long i = 0; i < batches; i += 2) {
        put(i + R - 1, mb);
        meta(mb, i + R + 1);
        take(i);
        if (i + 1 >= batches) break;
        put(i + R, ma);
        meta(ma, i + R + 2);
        take(i + 1);
      }
      mttkrp_common::cp_async_wait<0>();
    } else {
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
    }
    __syncthreads();  // every group's adds are in
  } else {
    const int nchunks =
        (int)((end - first + kStageChunk - 1) / kStageChunk);
    auto buf_val = [&](int q) { return stage + (size_t)q * kBufFloats; };
    auto buf_row = [&](int q) {
      return reinterpret_cast<int*>(buf_val(q) + kStageChunk);
    };
    auto buf_idx = [&](int q) { return buf_row(q) + kStageChunk; };
    auto count = [&](int c) {
      const long long left = end - first - (long long)c * kStageChunk;
      return (int)(left < kStageChunk ? left : kStageChunk);
    };
    auto stage_at = [&](int c) {
      const int q = c % kStageBuffers;
      stage_chunk<K>(vals, idx, lrow, first + (long long)c * kStageChunk,
                     count(c), buf_val(q), buf_row(q), buf_idx(q));
    };

    for (int c = 0; c < kStageBuffers - 1 && c < nchunks; ++c) stage_at(c);
    for (int c = 0; c < nchunks; ++c) {
      const int q = c % kStageBuffers;
      const int cnt = count(c);
      // Chunk c+B-1's copies fly while chunk c gathers (B buffers). Its
      // buffer was last read in iteration c-1, before its closing barrier.
      if (c + kStageBuffers - 1 < nchunks) {
        stage_at(c + kStageBuffers - 1);
        mttkrp_common::cp_async_wait<kStageBuffers - 1>();
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

      // Group g takes the chunk's slots g, g+groups, ... (the chunk is a
      // multiple of groups, so across chunks it walks every groups-th slot
      // of the tile's run in order), a batch of slots at a time: the factor
      // loads of a batch are issued before its adds, which run in slot order.
      if constexpr (D == Rows::kNarrow) {
        constexpr int U = kNarrowUnroll / K > 0 ? kNarrowUnroll / K : 1;
        const int step = groups * U;
        NarrowBatch<K, U> a, b;
        auto fetch = [&](NarrowBatch<K, U>& bt, int j0) {
          narrow_fetch<K, U, T>(bt, j0, cnt, s_val, s_row, s_idx, fs, groups,
                                tile_rows, ld, col0, lane);
        };
        auto add = [&](const NarrowBatch<K, U>& bt) {
          narrow_add<K, U, T>(bt, part, g, groups, rowf, lane, lanes);
        };
        // Two batches in flight: batch n+1's rows load while batch n adds
        // (kNarrowPipelined), or one batch at a time.
        int j0 = g;
        fetch(a, j0);
        for (;;) {
          if constexpr (kNarrowPipelined) fetch(b, j0 + step);
          add(a);
          if ((j0 += step) >= cnt) break;
          if constexpr (kNarrowPipelined) fetch(a, j0 + step);
          else fetch(b, j0);
          add(b);
          if ((j0 += step) >= cnt) break;
          if constexpr (!kNarrowPipelined) fetch(a, j0);
        }
      } else if constexpr (D == Rows::kVec) {
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
      __syncthreads();  // a later chunk's copies overwrite this buffer
    }
  }

  // Fixed-order reduction of the group partials into the output tile.
  float* tile_out = out + (long long)t * tile_rows * ld + col0;
  if constexpr (D == Rows::kNarrow)
    reduce_narrow_into<T>(part, groups, tile_rows, slab, lanes, tile_out,
                          ld);
  else
    mttkrp_common::reduce_partials_into(part, groups, tile_elems, slab,
                                        tile_out, ld);
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
  gather_body<K, T, Rows::kColumn>(GATHER_KERNEL_PASS);
}

// bf16 factors at slabs of kVecMinSlab columns or more: 16-byte row loads.
template <int K, typename T>
__global__ void gather_mttkrp_vec_kernel(GATHER_KERNEL_ARGS) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "bf16 rows only");
  gather_body<K, T, Rows::kVec>(GATHER_KERNEL_PASS);
}

// bf16 factors at slabs under kVecMinSlab: 16-byte row loads, a group of
// slab / 8 lanes, small staging buffers. (Its float instantiation, slab /
// 4 lanes, is launched only by bench_torch/kernel_ablation.py.)
template <int K, typename T>
__global__ void gather_mttkrp_narrow_kernel(GATHER_KERNEL_ARGS) {
  gather_body<K, T, Rows::kNarrow>(GATHER_KERNEL_PASS);
}

// Shared memory of one CTA of design D (kernel.gather_smem_bytes).
template <int K, Rows D>
size_t smem_bytes(int groups, int tile_rows, int slab, int lanes) {
  const size_t part = D == Rows::kNarrow
                          ? (size_t)tile_rows * groups * narrow_row_floats(slab)
                          : (size_t)groups * tile_rows * slab;
  const size_t ring = D == Rows::kNarrow && !kNarrowStaged
                          ? (size_t)groups * lanes * narrow_ring_lane_bytes<K>()
                          : 0;
  return (part + (size_t)Staging<D>::buffers * Staging<D>::chunk * (2 + K)) *
             sizeof(float) +
         ring;
}

template <int K, typename T, Rows D, typename Kernel>
cudaError_t launch_design(Kernel kernel, const float* vals, const int* idx,
                          const int* lrow, int* blk_start,
                          const FactorSet<T>& fs, float* out, int num_tiles,
                          int num_slabs, int blk, int tile_rows, int ld,
                          int slab, int groups, int lanes, long long n_pad,
                          cudaStream_t stream) {
  const size_t smem = smem_bytes<K, D>(groups, tile_rows, slab, lanes);
  cudaError_t e = mttkrp_common::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  if (D == Rows::kNarrow && kNarrowCarveout >= 0) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             kNarrowCarveout);
    if (e != cudaSuccess) return e;
  }
  e = mttkrp_common::launch_live_end(vals, blk_start, num_tiles, blk, n_pad,
                                     stream);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(num_tiles, num_slabs), groups * lanes, smem, stream>>>(
      vals, idx, lrow, blk_start, fs, out, blk, tile_rows, ld, slab, groups,
      lanes);
  return cudaGetLastError();
}

// kColumn: a column a lane whatever the element type (the first bf16
// kernel, gather_mttkrp_bf16_column_launch).
template <int K, typename T, bool kColumn>
cudaError_t launch_k(const float* vals, const int* idx, const int* lrow,
                     int* blk_start, const FactorSet<T>& fs, float* out,
                     int num_tiles, int num_slabs, int blk, int tile_rows,
                     int ld, int slab, int groups, int lanes, long long n_pad,
                     cudaStream_t stream) {
#define DESIGN(D, KERNEL)                                                  \
  launch_design<K, T, D>(KERNEL<K, T>, vals, idx, lrow, blk_start, fs, out, \
                         num_tiles, num_slabs, blk, tile_rows, ld, slab,   \
                         groups, lanes, n_pad, stream)
  if constexpr (std::is_same<T, __nv_bfloat16>::value && !kColumn) {
    if (slab >= kVecMinSlab)
      return DESIGN(Rows::kVec, gather_mttkrp_vec_kernel);
    return DESIGN(Rows::kNarrow, gather_mttkrp_narrow_kernel);
  } else {
    return DESIGN(Rows::kColumn, gather_mttkrp_kernel);
  }
#undef DESIGN
}

template <typename T, bool kColumn = false>
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
  launch_k<KK, T, kColumn>(v, ix, lr, bs, fs, o, num_tiles, num_slabs,    \
                           blk, tile_rows, ld, slab, groups, lanes, n_pad, \
                           s)
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

// The first bf16 kernel (a column a lane, the fp32 kernel's staging) at
// any slab, which gather_mttkrp_narrow_kernel replaced at
// narrow slabs: the yardstick chip_smoke.py times that kernel against in
// the same run (`lanes` = kernel._lanes(slab)). The port never calls it.
extern "C" int gather_mttkrp_bf16_column_launch(GATHER_ARGS) {
  return launch<__nv_bfloat16, true>(GATHER_PASS);
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
