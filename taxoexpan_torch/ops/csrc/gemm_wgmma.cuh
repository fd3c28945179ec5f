// The layer products of a bf16 star layer on Hopper: TMA loads into a
// shared-memory ring, warp-specialised, wgmma on bf16 operands with
// float32 accumulation. They replace the products of the bf16 Pallas
// kernels (pallas_gat.py:283-305, and _bwd_epilogue :607-651 of
// _bwd_kernel :507 / _bwd_pool_kernel :680: jnp.dot(..., preferred_
// element_type=float32) on bf16 operands), and serve every bf16 caller of
// product<> (gemm_tf32.cuh): the projections of K1-K4 and K5 and the dW
// and dx products of K2, K4 and K5b.
//
// What bounds it on an H100: the tensor cores (989 TFLOP/s dense bf16 on
// the data sheet) where the reduction is deep (the dW product over 262,144
// rows, the dx product over 2008 columns), the output bytes where it is
// not (config.mag.json layer 0's projection, where the backward runs it,
// writes 2.1 GB of float32 P for 320 GFLOP: 0.63 ms of bytes against 0.32
// ms of operations; the forward's star epilogue keeps that P in shared
// memory and writes the layer's bf16 output, 1.05 GB). Only wgmma reaches
// the tensor cores' full rate, and it must be fed from shared memory
// without the issuing threads spending instructions on copies.
//
// Design:
//  - Block: 3 warpgroups. Warpgroup 0 is the producer: one thread issues
//    the TMA loads of A and B tiles (BK = 64 deep) into a 4-stage ring,
//    128-byte swizzled, completion counted on a "full" mbarrier per stage;
//    it gives up registers (setmaxnreg 40). Warpgroups 1 and 2 are the
//    consumers (setmaxnreg 232): each multiplies 64 rows of the 128-row
//    tile by the BN (128, or 64 for narrow products) columns with
//    wgmma.mma_async m64nBNk16, accumulators in registers, and frees the
//    stage on its "empty" mbarrier.
//  - Clusters of two blocks on two SMs take M tiles 2i and 2i + 1 of the
//    same N tile and K range: each loads its own A tile and half of the
//    shared B tile (32 of the 64 K rows), multicast into both blocks' ring,
//    so that the B tiles cost half their L2 reads (the products at small
//    depth are bound by L2 reads: X is read again for every N tile); a
//    stage is empty when the consumers of both blocks have released it.
//  - Grid: persistent, as many clusters as fit on the card, walking the
//    (M tile pair, N tile, split) groups, N tiles fastest; the producer
//    runs up to 4 K tiles ahead, across tile boundaries, so a tile's
//    epilogue overlaps the next tile's loads.
//  - Layouts: A K-major (row-major [M][K]: the projection's X, the dx
//    product's D) as 128 rows x 128 bytes; A M-major ([K][M]: X read as X^T
//    by dW) as two 64-column blocks, read with the descriptor's transpose
//    bit; B row-major [K][N] as BN / 64 blocks of 64 columns, transposed
//    likewise. The tensor maps are encoded on the host for each call
//    (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint: no
//    -lcuda) and passed as __grid_constant__ kernel parameters. TMA fills
//    the ragged edges (rows past M, columns past N, K past the depth) with
//    zeros. Every stride is a 16-byte multiple (kxp, wdp, ntp round to 8).
//  - Rows counted on the card: with GemmArgs::rows set, the rows of the
//    row operand (M for a K-major A, the reduction for an M-major A) are
//    *rows, read by every block at its start (K4's valid rows, gat_bwd.cu);
//    the tensor maps span the allocated rows, and the grid is sized for
//    them. No host sync.
//  - Epilogues (gemm_tf32.cuh:GemmEpi): each consumer warpgroup writes its
//    64 x BN accumulators into its own shared C tile, then:
//    kEpiRowBias: P with its slot biases (float32; the biases copied into
//      the C tile by cp.async while the tile's products run), out by TMA;
//    kEpiStore: split-K float32 partials (reduced in a fixed order by
//      bwd_common.cuh), 16 bytes a thread;
//    kEpiDx: the float32 mask, x columns rounded to bf16, pe columns
//      float32, rows scattered through GemmArgs::row_map where set;
//    kEpiStar: the per-slot layer's star pass on the tile (wg_star_tile):
//      ft with its slot biases as kEpiRowBias, the star weights of the
//      tile's heads (computed once per egonet and head before the product,
//      gat_fwd.cu) copied by cp.async into the warpgroup's own shared
//      arrays beside the C tile while the tile's products run, then the
//      aggregation and the output leaky, the output in bf16 8 bytes a
//      thread; ft never leaves shared memory. Its M tiles are two
//      warpgroup tiles of whole egonets (floor(64 / n) of them), each
//      loaded as its own 64-row box, the rows past them computed and
//      dropped. Its barriers are the warpgroup's own named barriers (128
//      threads), never __syncthreads(): the producer warp does not take
//      part in the epilogue.
//    kEpiGcn: the star-GCN layer's pass on the tile (wg_gcn_tile, gcn.cu's
//      bf16 forward): the product's rows are the valid rows of whole
//      egonets packed into 64-row warpgroup tiles; the tile's row tables
//      (StarArgs::row_info, the row map) copied in by cp.async while its
//      products run; z_bias added by slot; the output in bf16 at the
//      original rows, z never stored.
//    No atomics: two calls give equal bits.
//
// Accuracy: the tensor cores add the products of one wgmma into the
// accumulator with truncation. Each 64-deep K tile (four k16 steps) is
// therefore summed into a fresh register tile (scale-d 0 on its first
// step) and added to the running float32 sum with an FADD (round to
// nearest): the truncation reaches only 64-deep partial sums, as in
// gemm_tf32.cuh. Two partial tiles take turns, so that the FADDs of one K
// tile overlap the next tile's products: three register tiles of 64 floats
// a thread at BN = 128, within the consumers' 232 registers. Measured on
// an NVIDIA H100 80GB HBM3 at 700 W against float64 products of the same
// bf16 operands: at depth 2056 (values up to 205) the largest error is
// 5.0e-5, cuBLAS's float32 product's 3.9e-5; over 4096 rows (dW, M-major,
// 3 splits) 5.7e-5 against cuBLAS's 8.6e-5 (tests/test_torch_cuda.py::
// test_wgmma_product_matches_float32 holds it to 1e-5 (|A| @ |B|)).
//
// The kernels live in namespace gat (see bwd_common.cuh on nvcc's stubs).
#pragma once

#include <cuda.h>  // CUtensorMap and the encoder's types (no libcuda link)

#include <type_traits>

#include "gemm_tf32.cuh"

namespace gat {

template <int BN_>
struct WgTile {
  static constexpr int BM = 128, BN = BN_, BK = 64, STAGES = 4;
  static constexpr int CONSUMERS = 2;  // warpgroups of 64 rows
  static constexpr int CLUSTER = 2;    // CTAs sharing B tiles (M tiles)
  static constexpr int THREADS = 128 * (1 + CONSUMERS);
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int BLOCK64 = 64 * 128;  // a 64-row x 128-byte block
  // a consumer's C tile: [64 rows][BN] floats as BN / 32 blocks of
  // [64][32], 128-byte swizzled (cs_at), the TMA store's boxes
  static constexpr int C_BYTES = BM * BN * 4;
  static constexpr int REGS = BN / 2;        // accumulators a thread
  // the ring 1024-byte aligned (the 128-byte swizzle's period), the C
  // tiles, the mbarriers (kEpiStar adds its arrays after them)
  static constexpr size_t SMEM =
      1024 + STAGES * STAGE_BYTES + C_BYTES + 2 * STAGES * 8;
};

// ------------------------------------------------------ PTX wrappers

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// a 2-D tile (c0 the inner coordinate) of the tensor map into shared
// memory, completion on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* tm,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// a 2-D box of shared memory out to the tensor map's tile at (c0, c1),
// clipped at its edges; completion tracked by bulk groups
__device__ __forceinline__ void tma_store(const CUtensorMap* tm,
                                          uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(tm)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until the bulk stores have read their shared memory (kRead) or are done
template <bool kRead>
__device__ __forceinline__ void bulk_wait() {
  if (kRead)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// this thread's shared-memory writes made visible to the TMA (async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the same, delivered to the same offset in every CTA of the cluster in
// `mask`, completion on the barrier at `bar`'s offset in each
__device__ __forceinline__ void tma_load_multicast(uint32_t dst,
                                                   const CUtensorMap* tm,
                                                   uint32_t bar, int c0,
                                                   int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(bar), "r"(c0), "r"(c1),
      "h"(mask)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// an arrival on the barrier at `bar`'s offset in cluster CTA `cta`
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n .reg .b32 ra;\n mapa.shared::cluster.u32 ra, %0, %1;\n"
      " mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n"
      ::"r"(bar), "r"(cta)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// A shared-memory matrix descriptor of a 128-byte swizzled operand: the
// start address, the leading byte offset (MN-major: the stride between
// 64-element column blocks; K-major: unused, 16) and the stride byte
// offset (between groups of 8 rows: 1024 bytes here).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most kPending committed groups are still running
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}
// keeps the compiler from moving reads of an accumulator register across
// the asynchronous product's wait
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

#define GAT_WG_R8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A @ B over one k16 step, a warpgroup's 64 x BN tile; kTA / kTB:
// A / B MN-major (transposed); scale = 0 starts a fresh sum
template <int BN, int kTA, int kTB>
__device__ __forceinline__ void wgmma_step(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db, int scale);

template <>
__device__ __forceinline__ void wgmma_step<128, 0, 1>(float (&d)[64],
                                                      uint64_t da,
                                                      uint64_t db,
                                                      int scale) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : GAT_WG_R8(0), GAT_WG_R8(8), GAT_WG_R8(16), GAT_WG_R8(24),
        GAT_WG_R8(32), GAT_WG_R8(40), GAT_WG_R8(48), GAT_WG_R8(56)
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_step<128, 1, 1>(float (&d)[64],
                                                      uint64_t da,
                                                      uint64_t db,
                                                      int scale) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : GAT_WG_R8(0), GAT_WG_R8(8), GAT_WG_R8(16), GAT_WG_R8(24),
        GAT_WG_R8(32), GAT_WG_R8(40), GAT_WG_R8(48), GAT_WG_R8(56)
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_step<64, 0, 1>(float (&d)[32],
                                                     uint64_t da,
                                                     uint64_t db,
                                                     int scale) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : GAT_WG_R8(0), GAT_WG_R8(8), GAT_WG_R8(16), GAT_WG_R8(24)
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_step<64, 1, 1>(float (&d)[32],
                                                     uint64_t da,
                                                     uint64_t db,
                                                     int scale) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : GAT_WG_R8(0), GAT_WG_R8(8), GAT_WG_R8(16), GAT_WG_R8(24)
      : "l"(da), "l"(db), "r"(scale));
}

#undef GAT_WG_R8

// ------------------------------------------------------ tile schedule

// The output tiles of one call: N tiles fastest, then M tiles, then the
// split; the rows of the row operand read on the card where g.rows is set.
// An M tile is bm rows, bm / 2 a consumer warpgroup: T::BM, or for the
// star epilogue two warpgroup tiles of whole egonets (StarArgs::rows_wg).
struct WgSchedule {
  long long m;        // output rows
  long long k;        // reduction depth
  long long k_chunk;  // depth a split takes
  int bm;             // rows of an M tile
  int mtiles, ntiles;
  int mgroups;        // groups of CLUSTER M tiles
  long long total;    // (M group, N tile, split)s
};

template <class T, bool kAKMajor>
__device__ __forceinline__ WgSchedule wg_schedule(const GemmArgsT<bf16>& g,
                                                  int splits, int bm) {
  WgSchedule s;
  s.bm = bm;
  s.m = g.m;
  s.k = g.k;
  s.k_chunk = g.k_chunk;
  if (g.rows != nullptr) {
    const long long r = *g.rows;
    if (kAKMajor) {
      s.m = min(r, g.m);
    } else {  // rows R, zero rows up to the next K tile (gat_bwd.cu)
      s.k = min(g.k, (r + T::BK - 1) / T::BK * T::BK);
      s.k_chunk = ((s.k + splits - 1) / splits + T::BK - 1) / T::BK * T::BK;
      if (s.k_chunk == 0) s.k_chunk = T::BK;
    }
  }
  s.mtiles = (int)((s.m + bm - 1) / bm);
  s.ntiles = (g.n + T::BN - 1) / T::BN;
  s.mgroups = (s.mtiles + T::CLUSTER - 1) / T::CLUSTER;
  s.total = (long long)s.mgroups * s.ntiles * splits;
  return s;
}

// ------------------------------------------------------ epilogue

// Element (r, c) of a consumer's C tile: block c / 32 of [64][32] floats,
// the 16-byte chunk of its 128-byte row XOR r % 8 (the TMA's 128-byte
// swizzle; also keeps a warp's float2 fragment stores off each other's
// banks).
__device__ __forceinline__ int cs_at(int r, int c) {
  return (((c >> 5) * 64 + r) << 5) + ((((c & 31) >> 2) ^ (r & 7)) << 2) +
         (c & 3);
}

// The row-bias epilogue's slot biases of a consumer warpgroup's rows
// [i0, i0 + 64) and columns [j0, j0 + BN), copied into its C tile cs by
// cp.async when the tile starts, so that their loads overlap the tile's
// products (the epilogue then adds the accumulators to them).
template <int BN>
__device__ __forceinline__ void wg_prefetch_bias(const GemmArgsT<bf16>& g,
                                                 float* cs, int t,
                                                 long long m, long long i0,
                                                 int j0) {
  const int bias_base = (int)(i0 % g.bias_rows);
#pragma unroll
  for (int q = 0; q < BN / 8; ++q) {
    const int e = t + q * 128;
    const int r = e / (BN / 4), c4 = (e % (BN / 4)) * 4;
    const long long i = i0 + r;
    const int j = j0 + c4;
    const int brow = g.row_map == nullptr ? (bias_base + r) % g.bias_rows
                     : i < m             ? g.row_map[i] % g.bias_rows
                                         : 0;
    const bool ok = j + 3 < g.ldc;
    cp_async16(&cs[cs_at(r, c4)],
               ok ? g.bias + (long long)brow * g.ldc + j : g.bias, ok);
  }
  cp_async_commit();
}

// One 4-column chunk q of a consumer warpgroup's C tile cs [64][BN + 4]
// (shared memory; the row-bias epilogue's biases already added) out to
// the output: row i0 + r, columns j0 + c4 .. + 3 (gemm_tf32.cuh:
// gemm_store_tile, with the split's output c, the rows m counted on the
// card and the row map of the dx epilogue).
template <int BN, int kEpi>
__device__ __forceinline__ void wg_store_chunk(const GemmArgsT<bf16>& g,
                                               const TrainArgs& ta,
                                               const float* cs, float* c,
                                               int e, long long m,
                                               long long i0, int j0,
                                               unsigned kf, unsigned kp) {
  const int r = e / (BN / 4), c4 = (e % (BN / 4)) * 4;
  const long long i = i0 + r;
  const int j = j0 + c4;
  if (i >= m || j >= g.n) return;
  const float4 v4 = *reinterpret_cast<const float4*>(&cs[cs_at(r, c4)]);
  float v[4] = {v4.x, v4.y, v4.z, v4.w};
  if (kEpi == kEpiDx) {
    const long long row = g.row_map != nullptr ? g.row_map[i] : i;
    const int k0 = g.kbeg + j;
    if (k0 + 3 < g.din && j + 3 < g.n) {  // four x columns
      if (ta.feat_on) {
        const unsigned rkf = row_key(kf, (unsigned)row);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] *= keep_at(ta, rkf, (unsigned)(k0 + u), ta.feat_thresh,
                          ta.feat_scale);
      }
      bf16* dst = g.dx + row * g.din + k0;
      if ((row * g.din + k0) % 4 == 0) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
        __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
        uint2 pack;
        pack.x = *reinterpret_cast<unsigned*>(&lo);
        pack.y = *reinterpret_cast<unsigned*>(&hi);
        *reinterpret_cast<uint2*>(dst) = pack;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) dst[u] = from_float<bf16>(v[u]);
      }
      return;
    }
    const unsigned rkf = row_key(kf, (unsigned)row);
    const unsigned rkp = row_key(kp, (unsigned)row);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u;
      if (j + u >= g.n) break;
      if (k < g.din) {
        if (ta.feat_on)
          v[u] *= keep_at(ta, rkf, (unsigned)k, ta.feat_thresh,
                          ta.feat_scale);
        g.dx[row * g.din + k] = from_float<bf16>(v[u]);
      } else {
        const int kp2 = k - g.din;
        if (ta.feat_on)
          v[u] *= keep_at(ta, rkp, (unsigned)kp2, ta.feat_thresh,
                          ta.feat_scale);
        g.pe_rows[row * ta.pos + kp2] = v[u];
      }
    }
    return;
  }
  float* out = c + i * g.ldc + j;
  if (g.ldc % 4 == 0 && j + 3 < g.n) {
    *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (j + u < g.n) out[u] = v[u];
  }
}

// A consumer warpgroup's C tile out to the rows [i0, i0 + 64) and columns
// [j0, j0 + BN), 4 columns a thread, neighbouring threads on neighbouring
// columns; the plain stores unrolled, the dx epilogue's hashing in a loop.
template <int BN, int kEpi>
__device__ __forceinline__ void wg_store_tile(const GemmArgsT<bf16>& g,
                                              const TrainArgs& ta,
                                              const float* cs, int t,
                                              long long m, long long i0,
                                              int j0, int z) {
  float* c = g.c + (long long)z * g.c_split;
  if constexpr (kEpi == kEpiDx) {
    const unsigned kf = stream_key(ta.seed, kStreamFeat);
    const unsigned kp = stream_key(ta.seed, kStreamPe);
#pragma unroll 1
    for (int e = t; e < 64 * BN / 4; e += 128)
      wg_store_chunk<BN, kEpi>(g, ta, cs, c, e, m, i0, j0, kf, kp);
  } else {
#pragma unroll
    for (int e = t; e < 64 * BN / 4; e += 128)
      wg_store_chunk<BN, kEpi>(g, ta, cs, c, e, m, i0, j0, 0, 0);
  }
}

// ------------------------------------------------------ star epilogue

// kEpiStar: a consumer warpgroup's star weights of up to kStarHeads heads,
// [head][64 rows] float4s, then its row table (64 ints: each row's slot,
// egonet within the tile and the egonet's first row), in shared memory
// after the mbarriers.
constexpr int kStarHeads = 4;
constexpr int kStarFloats = kStarHeads * 64 * 4 + 64;

// The star weights of the heads that columns [j0, jend) touch (up to
// kStarHeads of them) for a warpgroup's rows [iw, iw + 64), into sw by
// cp.async (committed with the slot biases' copies), so that their loads
// overlap the tile's products.
__device__ __forceinline__ void wg_prefetch_weights(const StarArgs& sa,
                                                    float* sw, int t,
                                                    long long m,
                                                    long long iw, int j0,
                                                    int jend) {
  const int h_lo = j0 / sa.dh;
#pragma unroll
  for (int q = 0; q < kStarHeads * 64 / 128; ++q) {
    const int e = t + q * 128;
    const int h = h_lo + e / 64;
    const long long i = iw + e % 64;
    const bool ok = h * sa.dh < jend && i < m;
    cp_async16(sw + 4 * e, ok ? sa.wts + i * sa.heads + h : sa.wts, ok);
  }
}

// 4 columns from c4 (a multiple of 4) of row r of a C tile
__device__ __forceinline__ float4 cs4(const float* cs, int r, int c4) {
  return *reinterpret_cast<const float4*>(&cs[cs_at(r, c4)]);
}

// Four output columns of the star aggregation, the optional out_alpha
// leaky, rounded to bf16 into dst: 8 bytes at once, or those columns that
// lie inside the output (hs[u] >= 0).
__device__ __forceinline__ void star_store(const StarArgs& sa,
                                           const int (&hs)[4], float (&v)[4],
                                           bf16* dst, int hd) {
  if (sa.has_out_alpha) {
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = leaky(v[u], sa.out_alpha);
  }
  if (hs[3] >= 0 && hd % 4 == 0) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 pack;
    pack.x = *reinterpret_cast<unsigned*>(&lo);
    pack.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(dst) = pack;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (hs[u] >= 0) dst[u] = from_float<bf16>(v[u]);
  }
}

// kEpiStar: the star pass of the per-slot layer (gat_fwd.cu) on a consumer
// warpgroup's C tile cs, ft + the slot biases of rows [iw, iw + 64) and
// columns [j0, j0 + BN), the rows from iw (a multiple of n) whole egonets.
// A lane takes one 4-column chunk of the tile (its head worked out once),
// the warpgroup's four warps every fourth row: gp rows take their own ft,
// the anchor the valid gps and itself, sib rows the anchor and themselves
// (invalid sib slots keep their formula value, as the TPU kernel's), with
// the star weights of the column's head (sw, prefetched; past its first
// kStarHeads heads, read from sa.wts), then the optional out_alpha leaky,
// rounded to bf16 into sa.out. Rows past the warpgroup's whole egonets or
// past the batch are dropped. No barriers: the caller's named barrier
// frees cs and sw for the next tile.
template <int BN>
__device__ __forceinline__ void wg_star_tile(const StarArgs& sa, int hd,
                                             const float* cs,
                                             const float4* sw,
                                             const int* tab, int t,
                                             long long iw, int j0) {
  static_assert(BN == 128, "a lane a 4-column chunk of the tile");
  const int n = sa.n, p = sa.p, dh = sa.dh;
  const long long b0 = iw / n;
  const long long egos = min((long long)(sa.rows_wg / n), sa.b - b0);
  const int rows = egos > 0 ? (int)egos * n : 0;
  const int jend = min(j0 + BN, hd);
  const int h_lo = j0 / dh;
  const int c4 = (t & 31) * 4, j = j0 + c4;
  int hs[4];  // each column's head, from h_lo (-1: past the output)
#pragma unroll
  for (int u = 0; u < 4; ++u) hs[u] = j + u < jend ? (j + u) / dh - h_lo : -1;
  // the weights of row r of head slot h
  auto weight = [&](int h, int r) {
    return h < kStarHeads ? sw[h * 64 + r]
                          : sa.wts[(iw + r) * sa.heads + h_lo + h];
  };
  const bool one = hs[0] >= 0 && hs[3] == hs[0] && hs[0] < kStarHeads;
  if (hs[0] < 0) return;
  if (one) {
    // the four columns in one prefetched head: every row's value is
    // w_self f + w_anchor fa (+ the valid gps' weighted ft at the anchor),
    // w_anchor being 0 on the gp rows and the anchor; rows unrolled so that
    // their shared-memory loads are in flight together
    const float4* w = sw + hs[0] * 64;
#pragma unroll 4
    for (int r = t >> 5; r < rows; r += 4) {
      const int info = tab[r];
      const int slot = info & 255, rb = info >> 16;
      const float4 f = cs4(cs, r, c4), fa = cs4(cs, rb + p, c4), wr = w[r];
      float g[4] = {0.f, 0.f, 0.f, 0.f};
      if (slot == p) {
        const int ngp = min(max(sa.ngp[b0 + ((info >> 8) & 255)], 0), p);
#pragma unroll 4
        for (int jj = 0; jj < ngp; ++jj) {
          const float wj = w[rb + jj].z;
          const float4 fj = cs4(cs, rb + jj, c4);
          g[0] += wj * fj.x, g[1] += wj * fj.y;
          g[2] += wj * fj.z, g[3] += wj * fj.w;
        }
      }
      float v[4] = {wr.x * f.x + (wr.y * fa.x + g[0]),
                    wr.x * f.y + (wr.y * fa.y + g[1]),
                    wr.x * f.z + (wr.y * fa.z + g[2]),
                    wr.x * f.w + (wr.y * fa.w + g[3])};
      star_store(sa, hs, v, sa.out + (iw + r) * hd + j, hd);
    }
    return;
  }
  // a head boundary inside the chunk, or a head past sw (Dh < BN / 3)
  for (int r = t >> 5; r < rows; r += 4) {
    const int info = tab[r];
    const int slot = info & 255, q = (info >> 8) & 255, rb = info >> 16;
    const float4 f = cs4(cs, r, c4);
    const float4 fa = cs4(cs, rb + p, c4);
    const float fv[4] = {f.x, f.y, f.z, f.w};
    const float av[4] = {fa.x, fa.y, fa.z, fa.w};
    const int ngp = slot == p ? min(max(sa.ngp[b0 + q], 0), p) : 0;
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[u] = 0.f;
      if (hs[u] < 0) continue;
      float g = 0.f;
      for (int jj = 0; jj < ngp; ++jj) {
        const float4 fj = cs4(cs, rb + jj, c4);
        const float fju[4] = {fj.x, fj.y, fj.z, fj.w};
        g += weight(hs[u], rb + jj).z * fju[u];
      }
      const float4 wr = weight(hs[u], r);
      v[u] = wr.x * fv[u] + (wr.y * av[u] + g);
    }
    star_store(sa, hs, v, sa.out + (iw + r) * hd + j, hd);
  }
}

// kEpiGcn: the star-GCN pass (gcn.cu) on a consumer warpgroup's C tile cs,
// the product of its packed rows [0, rows) and columns [j0, j0 + BN): each
// row's slot, its egonet's ngp and first row in the tile from tab
// (StarArgs::row_info), its original row from rmap (GemmArgs::row_map),
// both prefetched; -1: no row. z = the product + z_bias (zb [slot][ldz],
// read from the cache as each row is taken: a row's slot is known only
// from the table). A lane takes one 4-column chunk, the warpgroup's four
// warps every fourth row: a gp row its own z, the anchor itself and the
// valid gps, a sibling itself and the anchor, with the closed-form norms,
// then the bias, the leaky (has_out_alpha) and bf16 into sa.out at the
// original row. The expressions are gcn.cu:gcn_star_fwd_kernel's on the
// two-pass form's z, so the two forms give equal bits. No barriers: the
// caller's named barrier frees cs and the tables.
template <int BN>
__device__ __forceinline__ void wg_gcn_tile(const StarArgs& sa, int dout,
                                            const float* cs,
                                            const float* zb, long long ldz,
                                            const int* tab, const int* rmap,
                                            int t, int rows, int j0) {
  const int c4 = (t & 31) * 4, j = j0 + c4;
  if (j >= dout) return;
  const int p = sa.p;
  const float ns = rsqrtf(2.f);
  float bc[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) bc[u] = j + u < dout ? sa.bias[j + u] : 0.f;
  const int hs[4] = {0, j + 1 < dout ? 0 : -1, j + 2 < dout ? 0 : -1,
                     j + 3 < dout ? 0 : -1};
  // z of tile row r at slot `slot`: the product plus the slot's z_bias
  auto zat = [&](int r, int slot) {
    const float4 a = cs4(cs, r, c4);
    const float4 b = *reinterpret_cast<const float4*>(zb + slot * ldz + j);
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  };
#pragma unroll 2
  for (int r = t >> 5; r < rows; r += 4) {
    const int info = tab[r];
    if (info < 0) continue;
    const int slot = info & 255, ngp = (info >> 8) & 255, fr = info >> 16;
    const float4 z4 = zat(r, slot);
    const float z[4] = {z4.x, z4.y, z4.z, z4.w};
    float v[4];
    if (slot < p) {  // a valid gp: norm 1
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = z[u] + bc[u];
    } else {
      const float na = rsqrtf(1.f + (float)ngp);
      if (slot == p) {  // the anchor: itself and the valid gps, in order
        float acc[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] = z[u] * na;
        for (int jj = 0; jj < ngp; ++jj) {  // gp jj: tile row fr + jj
          const float4 g = zat(fr + jj, jj);
          acc[0] += g.x, acc[1] += g.y, acc[2] += g.z, acc[3] += g.w;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = acc[u] * na + bc[u];
      } else {  // a valid sibling: itself and the anchor
        const float4 a4 = zat(fr + ngp, p);
        const float za[4] = {a4.x * na, a4.y * na, a4.z * na, a4.w * na};
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = (z[u] * ns + za[u]) * ns + bc[u];
      }
    }
    star_store(sa, hs, v, sa.out + (long long)rmap[r] * dout + j, dout);
  }
}

// ------------------------------------------------------ the kernel

template <class T, bool kAKMajor, int kEpi>
__global__ void __launch_bounds__(T::THREADS, 1)
wgmma_gemm_kernel(const GemmArgsT<bf16> g, const TrainArgs ta, int splits,
                  const StarArgs sa, const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_b,
                  const __grid_constant__ CUtensorMap tm_c) {
  extern __shared__ uint8_t wg_smem_raw[];
  const uint32_t raw = smem_u32(wg_smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  uint8_t* base = wg_smem_raw + (ring - raw);
  float* ctile = reinterpret_cast<float*>(base + T::STAGES * T::STAGE_BYTES);
  const uint32_t bars = ring + T::STAGES * T::STAGE_BYTES + T::C_BYTES;
  // full[s] at bars + 8 s, empty[s] at bars + 8 (STAGES + s); a stage is
  // empty when the consumers of both CTAs of the cluster have read it (the
  // B tile comes half from each CTA's TMA, multicast to both)
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (T::STAGES + s), T::CONSUMERS * T::CLUSTER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  // kEpiStar: an M tile is two warpgroup tiles of whole egonets, loaded
  // as two 64-row boxes
  constexpr bool kStar = kEpi == kEpiStar;
  constexpr bool kGcn = kEpi == kEpiGcn;
  const WgSchedule sc =
      wg_schedule<T, kAKMajor>(g, splits, kStar ? 2 * sa.rows_wg : T::BM);
  const int wg_rows = sc.bm / 2;
  const int per_split = sc.mgroups * sc.ntiles;
  const int wg = threadIdx.x / 128;
  const uint32_t rank = cluster_rank();
  const long long cid = blockIdx.x / T::CLUSTER;
  const long long clusters = gridDim.x / T::CLUSTER;

  if (wg == 0) {  // ------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
    uint32_t it = 0;
    for (long long tile = cid; tile < sc.total; tile += clusters) {
      const int z = (int)(tile / per_split);
      const int rem = (int)(tile % per_split);
      const int i0 = ((rem / sc.ntiles) * T::CLUSTER + (int)rank) * sc.bm;
      const int j0 = (rem % sc.ntiles) * T::BN;
      const long long k_beg = (long long)z * sc.k_chunk;
      const long long k_end = min(sc.k, k_beg + sc.k_chunk);
      const int ktiles =
          k_end > k_beg ? (int)((k_end - k_beg + T::BK - 1) / T::BK) : 0;
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const uint32_t s = it % T::STAGES, ph = (it / T::STAGES) & 1;
        const uint32_t full = bars + 8 * s;
        mbar_wait(bars + 8 * (T::STAGES + s), ph ^ 1);
        mbar_expect_tx(full, T::STAGE_BYTES);
        const uint32_t a = ring + s * T::STAGE_BYTES;
        const uint32_t b = a + T::A_BYTES;
        const int k0 = (int)(k_beg + (long long)kt * T::BK);
        if (kStar) {  // [64 rows][64 k] of each warpgroup's egonets
          tma_load(a, &tm_a, full, k0, i0);
          tma_load(a + T::BLOCK64, &tm_a, full, k0, i0 + wg_rows);
        } else if (kAKMajor) {
          tma_load(a, &tm_a, full, k0, i0);  // [128 rows][64 k]
        } else {                             // [64 k][64 m], twice
          tma_load(a, &tm_a, full, i0, k0);
          tma_load(a + T::BLOCK64, &tm_a, full, i0 + 64, k0);
        }
        // this CTA's half of the B tile's [64 k][64 n] blocks: K rows
        // [32 rank, 32 rank + 32), to both CTAs
#pragma unroll
        for (int q = 0; q < T::BN / 64; ++q)
          tma_load_multicast(b + q * T::BLOCK64 + rank * (T::BLOCK64 / 2),
                             &tm_b, full, j0 + 64 * q,
                             k0 + (int)rank * (T::BK / 2),
                             (1u << T::CLUSTER) - 1);
      }
    }
    }
    cluster_sync();  // the partner's last arrivals and copies are done
    return;
  }

  // ------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  float* cs = ctile + c * 64 * T::BN;
  // kEpiStar: the warpgroup's star weights and row table, after the
  // mbarriers; the table (slot, egonet in the tile, its first row) is the
  // same for every tile. kEpiGcn: the tile's row tables there (row_info,
  // then the row map), 64 ints each, prefetched for every tile
  float* sw = reinterpret_cast<float*>(base + T::STAGES * T::STAGE_BYTES +
                                       T::C_BYTES + 2 * T::STAGES * 8) +
              c * kStarFloats;
  int* star_tab = reinterpret_cast<int*>(sw + kStarHeads * 64 * 4);
  int* gcn_tab = reinterpret_cast<int*>(sw);
  if (kStar && t < 64) {
    const int q = t / sa.n;
    star_tab[t] = (t - q * sa.n) | (q << 8) | ((q * sa.n) << 16);
  }
  // two partial sets in turn: the tensor cores run K tile t + 1 while the
  // FADDs add K tile t into acc
  float acc[T::REGS], pa[T::REGS], pb[T::REGS];
#pragma unroll
  for (int v = 0; v < T::REGS; ++v) pa[v] = pb[v] = 0.f;
  uint32_t it = 0;
  // K tile `k` (the ring's `k`-th) into the fresh partial pp
  auto issue = [&](float(&pp)[T::REGS], uint32_t k) {
    const uint32_t s = k % T::STAGES, ph = (k / T::STAGES) & 1;
    mbar_wait(bars + 8 * s, ph);
    const uint32_t a = ring + s * T::STAGE_BYTES + c * T::BLOCK64;
    const uint32_t b = ring + s * T::STAGE_BYTES + T::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::BK / 16; ++kk) {
      // K-major A: 16 k a step = 32 bytes along the swizzled row;
      // MN-major operands: 16 rows of 128 bytes
      const uint64_t da = kAKMajor
                              ? sw128_desc(a + kk * 32, 16, 1024)
                              : sw128_desc(a + kk * 2048, T::BLOCK64, 1024);
      const uint64_t db = sw128_desc(b + kk * 2048, T::BLOCK64, 1024);
      wgmma_step<T::BN, kAKMajor ? 0 : 1, 1>(pp, da, db, kk > 0);
    }
    wgmma_commit();
  };
  // K tile k's products are done: free its stage in both CTAs, add them
  // into acc
  auto retire = [&](float(&pp)[T::REGS], uint32_t k) {
#pragma unroll
    for (int v = 0; v < T::REGS; ++v) fence_reg(pp[v]);
    if (t == 0)
      for (uint32_t cta = 0; cta < T::CLUSTER; ++cta)
        mbar_arrive_cluster(bars + 8 * (T::STAGES + k % T::STAGES), cta);
#pragma unroll
    for (int v = 0; v < T::REGS; ++v) acc[v] = __fadd_rn(acc[v], pp[v]);
  };
  for (long long tile = cid; tile < sc.total; tile += clusters) {
    const int z = (int)(tile / per_split);
    const int rem = (int)(tile % per_split);
    const long long i0 =
        (long long)((rem / sc.ntiles) * T::CLUSTER + (int)rank) * sc.bm;
    const long long iw = i0 + (long long)wg_rows * c;  // this warpgroup's
    const int j0 = (rem % sc.ntiles) * T::BN;
    const long long k_beg = (long long)z * sc.k_chunk;
    const long long k_end = min(sc.k, k_beg + sc.k_chunk);
    const int ktiles =
        k_end > k_beg ? (int)((k_end - k_beg + T::BK - 1) / T::BK) : 0;
#pragma unroll
    for (int v = 0; v < T::REGS; ++v) acc[v] = 0.f;
    // kBias: the slot biases prefetched into cs; kPre: cs (or kEpiGcn's
    // tables) refilled for this tile, asynchronously
    constexpr bool kBias = kEpi == kEpiRowBias || kStar;
    constexpr bool kPre = kBias || kGcn;
    if (kPre) {  // the last tile's store or star pass has read cs
      if (kEpi == kEpiRowBias && t == 0) bulk_wait<true>();
      named_sync(1 + c, 128);
      if (kStar)
        wg_prefetch_weights(sa, sw, t, sc.m, iw, j0, min(j0 + T::BN, g.n));
      if (kGcn) {
        if (t < 32) {  // 16 chunks of row_info, 16 of the row map
          const int* src = t < 16 ? sa.row_info : g.row_map;
          const long long i = iw + 4 * (t & 15);
          const bool ok = i + 3 < g.m;
          cp_async16(gcn_tab + 4 * t, ok ? src + i : src, ok);
        }
        cp_async_commit();
      } else {
        wg_prefetch_bias<T::BN>(g, cs, t, sc.m, iw, j0);
      }
    }
    if (ktiles > 0) {
      issue(pa, it);
      for (int kt = 1; kt < ktiles; kt += 2) {
        issue(pb, it + kt);
        wgmma_wait<1>();
        retire(pa, it + kt - 1);
        if (kt + 1 < ktiles) {
          issue(pa, it + kt + 1);
          wgmma_wait<1>();
          retire(pb, it + kt);
        } else {
          wgmma_wait<0>();
          retire(pb, it + kt);
        }
      }
      if (ktiles % 2 == 1) {
        wgmma_wait<0>();
        retire(pa, it + ktiles - 1);
      }
      it += ktiles;
    }
    // epilogue: thread (warp, lane) holds rows warp * 16 + lane / 4 (+ 8)
    // and columns 8 q + 2 (lane % 4) (+ 1) of each 8-column block q
    // (the row-bias and star epilogues add them to the prefetched biases)
    const int r0 = warp * 16 + lane / 4;
    if (kPre) {
      cp_async_wait<0>();
      named_sync(1 + c, 128);
    }
#pragma unroll
    for (int q = 0; q < T::BN / 8; ++q) {
      const int col = q * 8 + 2 * (lane % 4);
      float2* lo = reinterpret_cast<float2*>(&cs[cs_at(r0, col)]);
      float2* hi = reinterpret_cast<float2*>(&cs[cs_at(r0 + 8, col)]);
      if (kBias) {
        const float2 bl = *lo, bh = *hi;
        *lo = make_float2(acc[4 * q] + bl.x, acc[4 * q + 1] + bl.y);
        *hi = make_float2(acc[4 * q + 2] + bh.x, acc[4 * q + 3] + bh.y);
      } else {
        *lo = make_float2(acc[4 * q], acc[4 * q + 1]);
        *hi = make_float2(acc[4 * q + 2], acc[4 * q + 3]);
      }
    }
    if constexpr (kEpi == kEpiRowBias) {  // P out by TMA, while the next
      fence_async_shared();               // tile runs
      named_sync(1 + c, 128);
      if (t == 0) {
#pragma unroll
        for (int q = 0; q < T::BN / 32; ++q)
          tma_store(&tm_c, smem_u32(cs + q * 64 * 32), j0 + 32 * q,
                    (int)iw);
        bulk_commit();
      }
    } else if constexpr (kStar) {  // the next tile's barrier frees cs
      named_sync(1 + c, 128);
      wg_star_tile<T::BN>(sa, g.n, cs, reinterpret_cast<const float4*>(sw),
                          star_tab, t, iw, j0);
    } else if constexpr (kGcn) {  // likewise
      named_sync(1 + c, 128);
      wg_gcn_tile<T::BN>(sa, g.n, cs, g.bias, g.ldc, gcn_tab, gcn_tab + 64,
                         t, (int)max(0LL, min(64LL, sc.m - iw)), j0);
    } else {
      named_sync(1 + c, 128);
      wg_store_tile<T::BN, kEpi>(g, ta, cs, t, sc.m, iw, j0, z);
      named_sync(1 + c, 128);  // the C tile is free for the next tile
    }
  }
  if (kEpi == kEpiRowBias && t == 0) bulk_wait<false>();
  cluster_sync();
}

// ------------------------------------------------------ host side

typedef CUresult (*TensorMapEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
#endif
    fn = reinterpret_cast<TensorMapEncodeTiled>(p);
  }
  return fn;
}

// A row-major matrix [outer][inner] of `type` (element `bytes`) with row
// stride `ld` elements, in boxes of [box_outer][box_inner] (128 bytes a
// box row), 128-byte swizzled; zeros outside on loads, clipped on stores.
inline cudaError_t tensor_map(CUtensorMap* tm, CUtensorMapDataType type,
                              int bytes, const void* ptr, long long inner,
                              long long outer, long long ld, int box_inner,
                              int box_outer) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (inner <= 0 || outer <= 0 || (ld * bytes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld * bytes)};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      tm, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline cudaError_t bf16_tensor_map(CUtensorMap* tm, const bf16* ptr,
                                   long long inner, long long outer,
                                   long long ld, int box_outer) {
  return tensor_map(tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, inner,
                    outer, ld, 64, box_outer);
}

inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
      count = 132;
  }
  return count;
}

// The bf16 product (gemm_tf32.cuh:product dispatches here): A K-major
// (kAKMajor) or M-major, B row-major, the epilogue kEpi, `splits` partial
// products, BN 128 or 64 columns a tile; sa: the star epilogue's arguments
// (kEpiStar, A K-major, one split; else unread).
template <bool kAKMajor, int kEpi, int BN>
inline cudaError_t product_wgmma(const GemmArgsT<bf16>& g,
                                 const TrainArgs& ta, int splits,
                                 const StarArgs& sa, cudaStream_t st) {
  using T = WgTile<BN>;
  constexpr bool kStar = kEpi == kEpiStar;
  constexpr bool kGcn = kEpi == kEpiGcn;
  if (g.m <= 0 || g.n <= 0) return cudaSuccess;
  if ((kEpi == kEpiRowBias || kStar || kGcn) && g.ldc % 4 != 0)
    return cudaErrorInvalidValue;
  if (kStar && (!kAKMajor || splits != 1 || sa.n < 1 || sa.n > 64 ||
                sa.rows_wg != 64 / sa.n * sa.n || sa.dh < 1))
    return cudaErrorInvalidValue;
  if (kGcn && (!kAKMajor || splits != 1 || BN != 128 || sa.n < 1 ||
               sa.n > 64 || sa.p < 0 || sa.p >= sa.n || g.rows == nullptr ||
               g.row_map == nullptr || sa.row_info == nullptr))
    return cudaErrorInvalidValue;
  const int bm = kStar ? 2 * sa.rows_wg : T::BM;
  CUtensorMap tm_a, tm_b;
  cudaError_t err =
      kAKMajor ? bf16_tensor_map(&tm_a, g.a, g.k, g.m, g.lda,
                                 kStar ? 64 : T::BM)
               : bf16_tensor_map(&tm_a, g.a, g.m, g.k, g.lda, T::BK);
  if (err != cudaSuccess) return err;
  err = bf16_tensor_map(&tm_b, g.b, g.n, g.k, g.ldb, T::BK / T::CLUSTER);
  if (err != cudaSuccess) return err;
  // the row-bias epilogue's P [c_rows][ldc] float32, stored by TMA in
  // boxes of [64][32]; the other epilogues store with their threads
  CUtensorMap tm_c = tm_b;
  if (kEpi == kEpiRowBias) {
    err = tensor_map(&tm_c, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, g.c, g.n,
                     g.c_rows > 0 ? g.c_rows : g.m, g.ldc, 32, 64);
    if (err != cudaSuccess) return err;
  }
  auto kernel = wgmma_gemm_kernel<T, kAKMajor, kEpi>;
  const size_t smem =
      T::SMEM +
      (kStar || kGcn ? sizeof(float) * T::CONSUMERS * kStarFloats : 0);
  err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = T::CLUSTER;
  attr[0].val.clusterDim.y = attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // persistent: as many clusters as the card holds at once (the grid for
  // the host's row count, an upper bound of the card's)
  static int resident = 0;
  if (resident == 0) {
    cfg.gridDim = dim3(T::CLUSTER * sm_count());
    err = cudaOccupancyMaxActiveClusters(&resident, (const void*)kernel,
                                         &cfg);
    if (err != cudaSuccess) return err;
    if (resident < 1) return cudaErrorInvalidConfiguration;
  }
  const long long groups = ((g.m + bm - 1) / bm + T::CLUSTER - 1) /
                           T::CLUSTER *
                           (long long)((g.n + T::BN - 1) / T::BN) * splits;
  const long long clusters = groups < resident ? groups : resident;
  cfg.gridDim = dim3((unsigned)(clusters * T::CLUSTER));
  err = cudaLaunchKernelEx(&cfg, kernel, g, ta, splits, sa, tm_a, tm_b,
                           tm_c);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace gat
