// The layer products of the star kernels on Hopper's tensor cores, at
// float32 accuracy: 3xTF32 (split precision). Each float32 operand a is
// split as a = a_hi + a_lo, a_hi = tf32(a), a_lo = a - a_hi (the tensor
// core reads its TF32 bits), and a * b ~ a_hi * b_hi + a_hi * b_lo +
// a_lo * b_hi, each term an mma.sync.m16n8k8 TF32 product with float32
// accumulation (a_lo * b_lo, about 2^-22 of a * b, is dropped).
//
// What bounds it on an H100: the tensor cores and the path that feeds
// them. Three TF32 products a float32 one put the data sheet's ceiling at
// 495 / 3 = 165 TFLOP/s against 67 TFLOP/s for float32 FMAs outside the
// tensor cores; mma.sync itself reaches less of the TF32 rate than wgmma
// (scripts/tf32_probe.py measures both on the card). The products are
// large (for the config.mag.json layer 0, 262,144 rows x 300 x 2008), so
// device-memory bytes do not bound them: each operand tile is read once
// and reused from shared memory across a 128 x 128 output tile. What is
// left is the work around each MMA: the fragment loads from shared memory,
// the hi / lo split, the K tile's sum (below), with two warps a scheduler,
// and feeding shared memory from L2 (PERF.md has the measured split).
//
// Accuracy: the tensor cores add the products of one mma into the
// accumulator with truncation, not round-to-nearest, a bias that grows
// with the depth of the sum (up to 65,536 rows a split in the split-K dW
// sums). Each 64-deep K tile is therefore summed into a fresh register
// tile and added to the running sum with a float32 FADD (round to
// nearest): the truncation reaches only 64-deep partial sums.
//
// Design: one block of 256 threads (8 warps, 2 x 4, each 64 x 32 of the
// output) per 128 x 128 output tile, K tiles of 64 copied into shared
// memory by cp.async (16-byte chunks) in a 3-stage ring, so two tiles are
// in flight while one is multiplied; the operands are split into hi / lo
// as their fragments are read from shared memory. A is read either K-major
// (row-major [M][K]) or M-major (A^T stored row-major, [K][M]: the dW
// product X^T @ D reads X so); B is row-major [K][N]. Every stride and the
// reduction depth are multiples of a chunk, with zeros in the padding, so
// a 16-byte chunk is either wholly inside or wholly outside the operand
// and is zero-filled outside. The epilogue goes through shared memory, so
// that the output rows are written 16 bytes a thread, coalesced. Split-K
// over blockIdx.z (the dW product over the batch's rows) writes one partial
// product per split; the caller adds them in a fixed order
// (bwd_common.cuh). Deterministic: no atomics.
//
// The argument struct, the epilogues' meaning and the operand preparation
// (staging, packing) are templated on E (float, or bf16 for a bf16 layer's
// X, W and dx); product<> runs this file's 3xTF32 pipeline for float and
// gemm_wgmma.cuh's TMA-fed wgmma kernel for bf16.
//
// The kernels live in namespace gat (see bwd_common.cuh on nvcc's stubs).
#pragma once

#include <type_traits>

#include "gat_common.cuh"

namespace gat {

// A tile shape in element type E: 8 warps, 2 x 4, each 4 x NI fragments
// of 16 x 8 (an output tile of 128 x 32 NI), K tiles of 64 in a 3-deep
// ring; a 16-byte chunk holds CHUNK elements (4 floats, 8 bf16). The rows
// of a K-major A tile are padded by a chunk, the others by 8 elements, so
// that the rows a warp reads at once fall on distinct banks. The C tile
// [BM][BN + 4] floats reuses the ring after the last K tile.
template <class E, int NI_>
struct GemmTile {
  static constexpr int MI = 4, NI = NI_, WARPS_M = 2, WARPS_N = 4;
  static constexpr int STAGES = 3;
  static constexpr int BM = WARPS_M * MI * 16, BN = WARPS_N * NI * 8,
                       BK = 64;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int CHUNK = 16 / (int)sizeof(E);
  static constexpr int A_STRIDE_K = BK + CHUNK;  // K-major A [BM][BK + C]
  static constexpr int A_STRIDE_M = BM + 8;      // M-major A [BK][BM + 8]
  static constexpr int B_STRIDE = BN + 8;        // B tile [BK][BN + 8]
  static constexpr int A_STAGE =
      BM * A_STRIDE_K > BK * A_STRIDE_M ? BM * A_STRIDE_K : BK * A_STRIDE_M;
  static constexpr int B_STAGE = BK * B_STRIDE;
  static constexpr size_t RING = sizeof(E) * STAGES * (A_STAGE + B_STAGE);
  static constexpr size_t CTILE = sizeof(float) * BM * (BN + 4);
  static constexpr size_t SMEM = RING > CTILE ? RING : CTILE;
};

// the tiles the layers use: 128 x 128, and 128 x 64 for narrow products
// (the pe columns' dx alone)
constexpr int kNarrowBN = GemmTile<float, 2>::BN;

// What the epilogue does with the product's element (i, j):
enum GemmEpi {
  kEpiStore = 0,    // c[i * ldc + j] = v
  kEpiRowBias = 1,  // c[i * ldc + j] = v + bias[(i % bias_rows) * ldc + j]
  kEpiDx = 2,       // column k = kbeg + j of the layer input's grad: times
                    // its dropout mask, into dx [i][din] (k < din) or
                    // pe_rows [i][pos] (k >= din)
  kEpiStar = 3,     // bf16 only (gemm_wgmma.cuh): ft = v + the slot bias
                    // as kEpiRowBias, never stored; the star pass of the
                    // per-slot layer on it (StarArgs), out in bf16
  kEpiGcn = 4,      // bf16 only (gemm_wgmma.cuh): z = v + z_bias as
                    // kEpiRowBias through the row map, never stored; the
                    // star-GCN pass on it (StarArgs: the packed rows of
                    // gcn.cu), out in bf16
};

template <class E>
struct GemmArgsT {
  const E* a;          // K-major: (i, k) at a[i * lda + k]; M-major:
  long long lda;       //   a[k * lda + i], i < lda
  const E* b;          // (k, j) at b[k * ldb + j], j < ldb
  long long ldb;
  float* c;            // output, row stride ldc; split z at c + z * c_split
  long long ldc;
  long long c_split;
  long long m;         // output rows
  int n;               // output columns (stored: j < n)
  long long k;         // reduction depth (16 bytes of E a multiple)
  long long k_chunk;   // rows of the reduction a split takes (multiple of BK)
  const float* bias;   // kEpiRowBias: [bias_rows][ldc]
  int bias_rows;
  E* dx;               // kEpiDx (rounded to E)
  float* pe_rows;
  int din, kbeg;
  // bf16 only (gemm_wgmma.cuh), null otherwise: the rows of the row
  // operand counted on the card (M of a K-major A, the reduction of an
  // M-major A; m or k is then the allocated rows), and the original row
  // of each output row (the row-bias and dx epilogues)
  const int* rows;
  const int* row_map;
  long long c_rows;    // rows allocated for c (0: m), bf16 only
};

// The star pass of kEpiStar (gat_fwd.cu's fused per-slot forward): the
// product's m rows are whole egonets of n slots, rows_wg = floor(64 / n) * n
// of them a consumer warpgroup's tile; its columns are ft, heads * dh.
// kEpiGcn (gcn.cu's bf16 forward) reads ngp, out, n, p, out_alpha (the
// leaky's slope), has_out_alpha, row_info and bias: its rows are the valid
// rows of whole egonets packed into 64-row warpgroup tiles, the original
// row of each in GemmArgs::row_map.
struct StarArgs {
  const float4* wts;   // [m][heads] each row's star weights (after dropout):
                       //   w_self, w_anchor, w_to_anchor (gp rows), 0
  const int* ngp;      // [b]
  bf16* out;           // [m][heads * dh] the per-slot output (kEpiGcn:
                       //   [b * n][dout])
  long long b;         // egonets
  int n, p, heads, dh;
  int rows_wg;
  float out_alpha;
  int has_out_alpha;
  const int* row_info;  // kEpiGcn: [rows] a packed row's slot | its
                        //   egonet's ngp << 8 | the egonet's first row in
                        //   the warpgroup tile << 16, or -1 (no row)
  const float* bias;    // kEpiGcn: [dout] the layer bias
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ unsigned tf32_bits(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// a = hi + lo: hi rounded to TF32; lo, exact in float32, goes in as it is
// (the tensor core reads its TF32 bits, dropping about 2^-22 of a)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32_bits(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The epilogue's second half: the C tile cs [BM][BN + 4] (shared memory)
// out to the rows [i0, i0 + BM) and columns [j0, j0 + BN) of the product,
// 4 columns a thread, neighbouring threads on neighbouring columns.
template <int BM, int BN, int THREADS, int kEpi, class E>
__device__ __forceinline__ void gemm_store_tile(const GemmArgsT<E>& g,
                                                const TrainArgs& ta,
                                                const float* cs, long long i0,
                                                int j0) {
  constexpr int CS = BN + 4;
  float* c = g.c + (long long)blockIdx.z * g.c_split;
  const bool vec = g.ldc % 4 == 0;
  const int bias_base = kEpi == kEpiRowBias ? (int)(i0 % g.bias_rows) : 0;
  unsigned kf = 0, kp = 0;
  if (kEpi == kEpiDx) {
    kf = stream_key(ta.seed, kStreamFeat);
    kp = stream_key(ta.seed, kStreamPe);
  }
  for (int e = threadIdx.x; e < BM * BN / 4; e += THREADS) {
    const int r = e / (BN / 4), c4 = (e % (BN / 4)) * 4;
    const long long i = i0 + r;
    const int j = j0 + c4;
    if (i >= g.m || j >= g.n) continue;
    const float4 v4 = *reinterpret_cast<const float4*>(&cs[r * CS + c4]);
    float v[4] = {v4.x, v4.y, v4.z, v4.w};
    if (kEpi == kEpiDx) {
      const unsigned rkf = row_key(kf, (unsigned)i);
      const unsigned rkp = row_key(kp, (unsigned)i);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = g.kbeg + j + q;
        if (j + q >= g.n) break;
        if (k < g.din) {
          if (ta.feat_on)
            v[q] *= keep_at(ta, rkf, (unsigned)k, ta.feat_thresh,
                            ta.feat_scale);
          g.dx[i * g.din + k] = from_float<E>(v[q]);
        } else {
          const int kp2 = k - g.din;
          if (ta.feat_on)
            v[q] *= keep_at(ta, rkp, (unsigned)kp2, ta.feat_thresh,
                            ta.feat_scale);
          g.pe_rows[i * ta.pos + kp2] = v[q];
        }
      }
      continue;
    }
    float* out = c + i * g.ldc + j;
    const bool full = vec && j + 3 < g.n;
    if (kEpi == kEpiRowBias) {
      const float* bb =
          g.bias + (long long)((bias_base + r) % g.bias_rows) * g.ldc + j;
      if (full) {
        const float4 b4 = *reinterpret_cast<const float4*>(bb);
        v[0] += b4.x, v[1] += b4.y, v[2] += b4.z, v[3] += b4.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j + q < g.n) v[q] += bb[q];
      }
    }
    if (full) {
      *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (j + q < g.n) out[q] = v[q];
    }
  }
}

// One K tile of A and B into stage buffers As / Bs (rows of the reduction
// [k0, k0 + BK) of this block's split, which ends at k_end), a 16-byte
// chunk (T::CHUNK elements) a cp.async.
template <class T, bool kAKMajor, class E>
__device__ __forceinline__ void gemm_load_tile(const GemmArgsT<E>& g,
                                               long long i0, int j0,
                                               long long k0, long long k_end,
                                               E* As, E* Bs) {
  constexpr int C = T::CHUNK;
  const int t = threadIdx.x;
#pragma unroll
  for (int q = 0; q < T::BM * T::BK / C / T::THREADS; ++q) {
    const int e = t + q * T::THREADS;
    if (kAKMajor) {  // [BM rows][BK / C chunks]
      const int r = e / (T::BK / C), cc = (e % (T::BK / C)) * C;
      const long long i = i0 + r, kk = k0 + cc;
      const bool ok = i < g.m && kk < k_end;
      cp_async16(As + r * T::A_STRIDE_K + cc, ok ? g.a + i * g.lda + kk : g.a,
                 ok);
    } else {  // [BK rows][BM / C chunks]
      const int r = e / (T::BM / C), cc = (e % (T::BM / C)) * C;
      const long long kk = k0 + r, i = i0 + cc;
      const bool ok = kk < k_end && i < g.lda;
      cp_async16(As + r * T::A_STRIDE_M + cc, ok ? g.a + kk * g.lda + i : g.a,
                 ok);
    }
  }
#pragma unroll
  for (int q = 0; q < T::BK * T::BN / C / T::THREADS; ++q) {
    const int e = t + q * T::THREADS;
    const int r = e / (T::BN / C), cc = (e % (T::BN / C)) * C;
    const long long kk = k0 + r;
    const int j = j0 + cc;
    const bool ok = kk < k_end && j < g.ldb;
    cp_async16(Bs + r * T::B_STRIDE + cc, ok ? g.b + kk * g.ldb + j : g.b, ok);
  }
}

// A warp's products over one K tile in shared memory (as, bs), added into
// part: 3xTF32.
struct MmaStep {
  // mma.sync.m16n8k8 TF32 fragments read from shared memory element by
  // element (thread (gid, tig): rows +gid / +gid + 8, k +tig / +tig + 4),
  // each split into hi / lo there.
  template <class T, bool kAKMajor>
  static __device__ __forceinline__ void tile(
      const float* as, const float* bs, int wm, int wn, int lane,
      float (&part)[T::MI][T::NI][4]) {
    constexpr int MI = T::MI, NI = T::NI;
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int kk = 0; kk < T::BK; kk += 8) {
      const int k = kk + tig;
      unsigned bhi[NI][2], blo[NI][2];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = wn * NI * 8 + ni * 8 + gid;
        split_tf32(bs[k * T::B_STRIDE + col], bhi[ni][0], blo[ni][0]);
        split_tf32(bs[(k + 4) * T::B_STRIDE + col], bhi[ni][1], blo[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = wm * MI * 16 + mi * 16 + gid;
        float v[4];
        if (kAKMajor) {
          v[0] = as[r * T::A_STRIDE_K + k];
          v[1] = as[(r + 8) * T::A_STRIDE_K + k];
          v[2] = as[r * T::A_STRIDE_K + k + 4];
          v[3] = as[(r + 8) * T::A_STRIDE_K + k + 4];
        } else {
          v[0] = as[k * T::A_STRIDE_M + r];
          v[1] = as[k * T::A_STRIDE_M + r + 8];
          v[2] = as[(k + 4) * T::A_STRIDE_M + r];
          v[3] = as[(k + 4) * T::A_STRIDE_M + r + 8];
        }
        unsigned ahi[4], alo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(v[q], ahi[q], alo[q]);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {  // the small terms first
          mma_tf32(part[mi][ni], alo, bhi[ni]);
          mma_tf32(part[mi][ni], ahi, blo[ni]);
          mma_tf32(part[mi][ni], ahi, bhi[ni]);
        }
      }
    }
  }
};

// C = A @ B (+ the epilogue) over one BM x BN output tile a block; grid
// (tiles of M x tiles of N, 1, splits), N tiles fastest so that blocks
// running together share their A rows in L2.
template <class E, class T, bool kAKMajor, int kEpi>
__global__ void __launch_bounds__(T::THREADS, 1)
gemm_kernel(GemmArgsT<E> g, TrainArgs ta) {
  constexpr int MI = T::MI, NI = T::NI;
  extern __shared__ float4 gemm_smem4[];
  E* As = reinterpret_cast<E*>(gemm_smem4);
  E* Bs = As + T::STAGES * T::A_STAGE;

  const int ntiles = (g.n + T::BN - 1) / T::BN;
  const long long i0 = (long long)(blockIdx.x / ntiles) * T::BM;
  const int j0 = (blockIdx.x % ntiles) * T::BN;
  const long long k_beg = (long long)blockIdx.z * g.k_chunk;
  const long long k_end = min(g.k, k_beg + g.k_chunk);
  const int ktiles =
      k_end > k_beg ? (int)((k_end - k_beg + T::BK - 1) / T::BK) : 0;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const int gid = lane >> 2, tig = lane & 3;

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < ktiles)
      gemm_load_tile<T, kAKMajor>(g, i0, j0, k_beg + s * T::BK, k_end,
                                  As + s * T::A_STAGE, Bs + s * T::B_STAGE);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();  // tile kt landed; stage (kt - 1) % S is free
    {
      const int nk = kt + T::STAGES - 1;
      if (nk < ktiles) {
        const int st = nk % T::STAGES;
        gemm_load_tile<T, kAKMajor>(g, i0, j0,
                                    k_beg + (long long)nk * T::BK, k_end,
                                    As + st * T::A_STAGE,
                                    Bs + st * T::B_STAGE);
      }
      cp_async_commit();
    }

    float part[MI][NI][4];  // this K tile's products, summed apart
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[mi][ni][q] = 0.f;
    MmaStep::template tile<T, kAKMajor>(
        As + (kt % T::STAGES) * T::A_STAGE, Bs + (kt % T::STAGES) * T::B_STAGE,
        wm, wn, lane, part);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[mi][ni][q] = __fadd_rn(acc[mi][ni][q], part[mi][ni][q]);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the C tile next

  // epilogue: the accumulators through shared memory (thread (gid, tig)
  // holds rows +gid / +gid + 8 and columns +2 tig / +2 tig + 1 of each
  // 16 x 8 fragment, in either element type), then rows of the tile out,
  // 4 columns a thread and neighbouring threads on neighbouring columns
  constexpr int CS = T::BN + 4;
  float* cs = reinterpret_cast<float*>(gemm_smem4);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int r = wm * MI * 16 + mi * 16 + gid + h * 8;
        const int col = wn * NI * 8 + ni * 8 + 2 * tig;
        *reinterpret_cast<float2*>(&cs[r * CS + col]) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
  __syncthreads();

  gemm_store_tile<T::BM, T::BN, T::THREADS, kEpi>(g, ta, cs, i0, j0);
}

template <bool kAKMajor, int kEpi, int BN>
inline cudaError_t product_wgmma(const GemmArgsT<bf16>& g,
                                 const TrainArgs& ta, int splits,
                                 const StarArgs& sa, cudaStream_t st);

// The layer product in the layer's element type E (3xTF32 for float here;
// bf16: gemm_wgmma.cuh) on `st`: A K-major (kAKMajor) or M-major, the
// epilogue kEpi, `splits` partial products over blockIdx.z; kNarrow takes
// the 128 x 64 tile.
template <bool kAKMajor, int kEpi, bool kNarrow = false, class E>
inline cudaError_t product(const GemmArgsT<E>& g, const TrainArgs& ta,
                           int splits, cudaStream_t st) {
  if constexpr (sizeof(E) == 2) {
    return product_wgmma<kAKMajor, kEpi, kNarrow ? 64 : 128>(
        g, ta, splits, StarArgs{}, st);
  } else {
    using T = GemmTile<E, kNarrow ? 2 : 4>;
    if (g.m <= 0 || g.n <= 0) return cudaSuccess;
    const void* kernel = (const void*)gemm_kernel<E, T, kAKMajor, kEpi>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
    if (err != cudaSuccess) return err;
    const long long tiles = ((g.m + T::BM - 1) / T::BM) *
                            (long long)((g.n + T::BN - 1) / T::BN);
    if (tiles > 0x7fffffffLL || splits > 65535) return cudaErrorInvalidValue;
    gemm_kernel<E, T, kAKMajor, kEpi>
        <<<dim3((unsigned)tiles, 1, splits), T::THREADS, T::SMEM, st>>>(g,
                                                                       ta);
    return cudaGetLastError();
  }
}

// ------------------------------------------------- operand preparation

// The layer's input and weight rows. W's columns are up to three row-major
// blocks [0, c1), [c1, c2), [c2, wd) (GAT: fc, wa1, wa2; GCN: W alone,
// c1 = c2 = wd); the pe rows' blocks wp[i] follow the same split. The pe
// rows themselves, pos and the masks come with the TrainArgs.
// A bf16 layer's x and W_h are bf16; its pe rows and W_p stay float32.
template <class E>
struct OperandT {
  const E* x;          // [b*n, din]
  const E* w[3];       // [din, width of block i]
  const float* wp[3];  // [pos, width of block i] (pos > 0)
  int n, din, c1, c2, wd;
};
using Operand = OperandT<float>;

// Element (k, j) of row block `blocks` (column blocks [0, c1), [c1, c2),
// [c2, wd)).
template <class T, class E>
__device__ __forceinline__ float wblock(const T* const* blocks,
                                        const OperandT<E>& op, int k,
                                        int j) {
  if (j < op.c1) return to_float(blocks[0][(size_t)k * op.c1 + j]);
  if (j < op.c2)
    return to_float(blocks[1][(size_t)k * (op.c2 - op.c1) + j - op.c1]);
  return to_float(blocks[2][(size_t)k * (op.wd - op.c2) + j - op.c2]);
}

// Element (k, j) of W = [W_h; W_p] (k < din + pos, j < wd).
template <class E>
__device__ __forceinline__ float wcat(const OperandT<E>& op, int k, int j) {
  return k < op.din ? wblock(op.w, op, k, j)
                    : wblock(op.wp, op, k - op.din, j);
}

// The x columns of a bf16 row, V (8 or 2) a lane at a time, 16 or 4 bytes
// a load and a store: x times its mask rounded to bf16, as stage_row.
template <int V>
__device__ __forceinline__ void stage_x_bf16(const bf16* __restrict__ xr,
                                             bf16* __restrict__ out, int din,
                                             const TrainArgs& ta,
                                             unsigned rkf, int lane) {
  using Vec = typename std::conditional<V == 8, uint4, unsigned>::type;
  for (int k = lane * V; k < din; k += 32 * V) {
    Vec raw = *reinterpret_cast<const Vec*>(xr + k);
    if (ta.feat_on) {
      bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
      for (int u = 0; u < V; ++u)
        e[u] = from_float<bf16>(
            to_float(e[u]) *
            to_float(from_float<bf16>(keep_at(ta, rkf, (unsigned)(k + u),
                                              ta.feat_thresh,
                                              ta.feat_scale))));
    }
    *reinterpret_cast<Vec*>(out + k) = raw;
  }
}

// xm [m][kxp] = the layer input X = [x*m | pe*m_pe], zero past din + pos:
// each element's mask bits hashed once, for every product that reads X.
// A warp a row, its lanes over the columns (eight loads in flight a
// lane; a bf16 row 8 or 2 columns a lane where its width and x's address
// allow): no division per element, the row keys once a row; bound by
// bytes. In a bf16 layer (pallas_gat.py:282-283, :296-297) an x column is
// x times its mask rounded to bf16, the product rounded to bf16; a pe
// column is pe times the float32 mask, rounded to bf16.
template <class E>
__device__ __forceinline__ void stage_row(const OperandT<E>& op,
                                          const TrainArgs& ta, unsigned kf,
                                          unsigned kp, long long r,
                                          E* __restrict__ out, int kxp,
                                          int lane) {
  const int kx = op.din + ta.pos;
  const unsigned rkf = row_key(kf, (unsigned)r);
  const unsigned rkp = row_key(kp, (unsigned)r);
  const E* xr = op.x + r * op.din;
  const float* per = ta.pe + (r % op.n) * ta.pos;
  int k_done = 0;  // x columns staged by the bf16 vector path
  if constexpr (sizeof(E) == 2) {
    const uintptr_t at = reinterpret_cast<uintptr_t>(op.x);
    if (op.din % 8 == 0 && at % 16 == 0) {
      stage_x_bf16<8>(xr, out, op.din, ta, rkf, lane);
      k_done = op.din;
    } else if (op.din % 2 == 0 && at % 4 == 0) {
      stage_x_bf16<2>(xr, out, op.din, ta, rkf, lane);
      k_done = op.din;
    }
  }
#pragma unroll 8
  for (int k = k_done + lane; k < op.din; k += 32) {  // the x columns
    float v = to_float(xr[k]);
    if (ta.feat_on)
      v *= to_float(from_float<E>(
          keep_at(ta, rkf, (unsigned)k, ta.feat_thresh, ta.feat_scale)));
    out[k] = from_float<E>(v);
  }
  for (int k = op.din + lane; k < kxp; k += 32) {  // pe columns, padding
    float v = 0.f;
    if (k < kx) {
      v = per[k - op.din];
      if (ta.feat_on)
        v *= keep_at(ta, rkp, (unsigned)(k - op.din), ta.feat_thresh,
                     ta.feat_scale);
    }
    out[k] = from_float<E>(v);
  }
}

template <class E>
__global__ void stage_input_kernel(OperandT<E> op, TrainArgs ta,
                                   E* __restrict__ xm, long long m,
                                   int kxp) {
  const unsigned kf = stream_key(ta.seed, kStreamFeat);
  const unsigned kp = stream_key(ta.seed, kStreamPe);
  const int warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  for (long long r = (long long)blockIdx.x * warps + (threadIdx.x >> 5);
       r < m; r += (long long)gridDim.x * warps)
    stage_row(op, ta, kf, kp, r, xm + r * kxp, kxp, lane);
}

// The weight rows in the products' layouts, zero-padded: wcat_out
// [kxp][wdp] = W (the projection's B), wt [wdp][ntp] = W^T restricted to
// the input columns [kbeg, kbeg + ntp) (the dx product's B). Either may be
// null. A bf16 layer's W_p rows are rounded to bf16 (pallas_gat.py:298).
template <class E>
__global__ void pack_weights_kernel(OperandT<E> op, TrainArgs ta,
                                    E* __restrict__ wcat_out, int kxp,
                                    int wdp, E* __restrict__ wt,
                                    int kbeg, int ntp) {
  const int kx = op.din + ta.pos;
  const int krows = max(kxp, kbeg + ntp);
  const long long total = (long long)krows * wdp;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int k = (int)(e / wdp), j = (int)(e % wdp);
    const E v = from_float<E>((k < kx && j < op.wd) ? wcat(op, k, j) : 0.f);
    if (wcat_out != nullptr && k < kxp) wcat_out[(size_t)k * wdp + j] = v;
    if (wt != nullptr && k >= kbeg && k < kbeg + ntp)
      wt[(size_t)j * ntp + (k - kbeg)] = v;
  }
}

// out [rows][wdp] = [b0 | b1 | b2] ([rows][c1], [rows][c2 - c1],
// [rows][wd - c2]), zero past wd: the slot biases of the projection's
// columns (its row-bias epilogue).
__global__ void pack_bias_kernel(const float* __restrict__ b0,
                                 const float* __restrict__ b1,
                                 const float* __restrict__ b2, int rows,
                                 int c1, int c2, int wd, int wdp,
                                 float* __restrict__ out) {
  const long long total = (long long)rows * wdp;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(e / wdp), j = (int)(e % wdp);
    float v = 0.f;
    if (j < c1)
      v = b0[(size_t)r * c1 + j];
    else if (j < c2)
      v = b1[(size_t)r * (c2 - c1) + j - c1];
    else if (j < wd)
      v = b2[(size_t)r * (wd - c2) + j - c2];
    out[e] = v;
  }
}

// Blocks of 256 threads for a grid-stride loop over `count` elements.
inline unsigned grid_for(long long count) {
  const long long blocks = (count + 255) / 256;
  return (unsigned)(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096);
}

}  // namespace gat
