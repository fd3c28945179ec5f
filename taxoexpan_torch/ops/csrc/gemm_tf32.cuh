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
// reduction depth are multiples of 4 floats, with zeros in the padding, so
// a 16-byte chunk is either wholly inside or wholly outside the operand
// and is zero-filled outside. The epilogue goes through shared memory, so
// that the output rows are written 16 bytes a thread, coalesced. Split-K
// over blockIdx.z (the dW product over the batch's rows) writes one partial
// product per split; the caller adds them in a fixed order
// (bwd_common.cuh). Deterministic: no atomics.
//
// The kernels live in namespace gat (see bwd_common.cuh on nvcc's stubs).
#pragma once

#include "gat_common.cuh"

namespace gat {

// A tile shape: 8 warps, 2 x 4, each 4 x NI fragments of 16 x 8 (an output
// tile of 128 x 32 NI), K tiles of 64 in a 3-deep ring.
template <int NI_>
struct GemmTile {
  static constexpr int MI = 4, NI = NI_, WARPS_M = 2, WARPS_N = 4;
  static constexpr int STAGES = 3;
  static constexpr int BM = WARPS_M * MI * 16, BN = WARPS_N * NI * 8,
                       BK = 64;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int A_STRIDE_K = BK + 4;  // K-major A tile [BM][BK + 4]
  static constexpr int A_STRIDE_M = BM + 8;  // M-major A tile [BK][BM + 8]
  static constexpr int B_STRIDE = BN + 8;    // B tile [BK][BN + 8]
  static constexpr int A_STAGE =
      BM * A_STRIDE_K > BK * A_STRIDE_M ? BM * A_STRIDE_K : BK * A_STRIDE_M;
  static constexpr int B_STAGE = BK * B_STRIDE;
  static constexpr size_t SMEM = sizeof(float) * STAGES * (A_STAGE + B_STAGE);
};

// the tiles the layers use: 128 x 128, and 128 x 64 for narrow products
// (the pe columns' dx alone)
using GemmTileDefault = GemmTile<4>;
using GemmTileNarrow = GemmTile<2>;

// What the epilogue does with the product's element (i, j):
enum GemmEpi {
  kEpiStore = 0,    // c[i * ldc + j] = v
  kEpiRowBias = 1,  // c[i * ldc + j] = v + bias[(i % bias_rows) * ldc + j]
  kEpiDx = 2,       // column k = kbeg + j of the layer input's grad: times
                    // its dropout mask, into dx [i][din] (k < din) or
                    // pe_rows [i][pos] (k >= din)
};

struct GemmArgs {
  const float* a;      // K-major: (i, k) at a[i * lda + k]; M-major:
  long long lda;       //   a[k * lda + i], i < lda
  const float* b;      // (k, j) at b[k * ldb + j], j < ldb
  long long ldb;
  float* c;            // output, row stride ldc; split z at c + z * c_split
  long long ldc;
  long long c_split;
  long long m;         // output rows
  int n;               // output columns (stored: j < n)
  long long k;         // reduction depth (a multiple of 4)
  long long k_chunk;   // rows of the reduction a split takes (multiple of BK)
  const float* bias;   // kEpiRowBias: [bias_rows][ldc]
  int bias_rows;
  float* dx;           // kEpiDx
  float* pe_rows;
  int din, kbeg;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
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
template <int BM, int BN, int THREADS, int kEpi>
__device__ __forceinline__ void gemm_store_tile(const GemmArgs& g,
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
          g.dx[i * g.din + k] = v[q];
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
// [k0, k0 + BK) of this block's split, which ends at k_end).
template <class T, bool kAKMajor>
__device__ __forceinline__ void gemm_load_tile(const GemmArgs& g,
                                               long long i0, int j0,
                                               long long k0, long long k_end,
                                               float* As, float* Bs) {
  const int t = threadIdx.x;
#pragma unroll
  for (int q = 0; q < T::BM * T::BK / 4 / T::THREADS; ++q) {
    const int e = t + q * T::THREADS;
    if (kAKMajor) {  // [BM rows][BK / 4 chunks]
      const int r = e / (T::BK / 4), c4 = (e % (T::BK / 4)) * 4;
      const long long i = i0 + r, kk = k0 + c4;
      const bool ok = i < g.m && kk < k_end;
      cp_async16(As + r * T::A_STRIDE_K + c4, ok ? g.a + i * g.lda + kk : g.a,
                 ok);
    } else {  // [BK rows][BM / 4 chunks]
      const int r = e / (T::BM / 4), c4 = (e % (T::BM / 4)) * 4;
      const long long kk = k0 + r, i = i0 + c4;
      const bool ok = kk < k_end && i < g.lda;
      cp_async16(As + r * T::A_STRIDE_M + c4, ok ? g.a + kk * g.lda + i : g.a,
                 ok);
    }
  }
#pragma unroll
  for (int q = 0; q < T::BK * T::BN / 4 / T::THREADS; ++q) {
    const int e = t + q * T::THREADS;
    const int r = e / (T::BN / 4), c4 = (e % (T::BN / 4)) * 4;
    const long long kk = k0 + r;
    const int j = j0 + c4;
    const bool ok = kk < k_end && j < g.ldb;
    cp_async16(Bs + r * T::B_STRIDE + c4, ok ? g.b + kk * g.ldb + j : g.b, ok);
  }
}

// C = A @ B (+ the epilogue) over one BM x BN output tile a block; grid
// (tiles of M x tiles of N, 1, splits), N tiles fastest so that blocks
// running together share their A rows in L2.
template <class T, bool kAKMajor, int kEpi>
__global__ void __launch_bounds__(T::THREADS, 1)
gemm_tf32x3_kernel(GemmArgs g, TrainArgs ta) {
  constexpr int MI = T::MI, NI = T::NI;
  extern __shared__ float4 gemm_smem4[];
  float* As = reinterpret_cast<float*>(gemm_smem4);
  float* Bs = As + T::STAGES * T::A_STAGE;

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
    const float* as = As + (kt % T::STAGES) * T::A_STAGE;
    const float* bs = Bs + (kt % T::STAGES) * T::B_STAGE;

    float part[MI][NI][4];  // this K tile's products, summed apart
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[mi][ni][q] = 0.f;

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
  // 16 x 8 fragment), then rows of the tile out, 4 columns a thread and
  // neighbouring threads on neighbouring columns
  constexpr int CS = T::BN + 4;
  static_assert(T::BM * CS <= T::STAGES * (T::A_STAGE + T::B_STAGE),
                "C tile");
  float* cs = As;
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

// Launches the product on `st` with tile T: A K-major (kAKMajor) or
// M-major, the epilogue kEpi, `splits` partial products over blockIdx.z.
template <bool kAKMajor, int kEpi, class T = GemmTileDefault>
inline cudaError_t gemm_tf32x3(const GemmArgs& g, const TrainArgs& ta,
                               int splits, cudaStream_t st) {
  if (g.m <= 0 || g.n <= 0) return cudaSuccess;
  const void* kernel = (const void*)gemm_tf32x3_kernel<T, kAKMajor, kEpi>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (err != cudaSuccess) return err;
  const long long tiles = ((g.m + T::BM - 1) / T::BM) *
                          (long long)((g.n + T::BN - 1) / T::BN);
  if (tiles > 0x7fffffffLL || splits > 65535) return cudaErrorInvalidValue;
  gemm_tf32x3_kernel<T, kAKMajor, kEpi>
      <<<dim3((unsigned)tiles, 1, splits), T::THREADS, T::SMEM, st>>>(g, ta);
  return cudaGetLastError();
}

// ------------------------------------------------- operand preparation

// The layer's input and weight rows. W's columns are up to three row-major
// blocks [0, c1), [c1, c2), [c2, wd) (GAT: fc, wa1, wa2; GCN: W alone,
// c1 = c2 = wd); the pe rows' blocks wp[i] follow the same split. The pe
// rows themselves, pos and the masks come with the TrainArgs.
struct Operand {
  const float* x;      // [b*n, din]
  const float* w[3];   // [din, width of block i]
  const float* wp[3];  // [pos, width of block i] (pos > 0)
  int n, din, c1, c2, wd;
};

// Element (k, j) of W = [W_h; W_p] (k < din + pos, j < wd).
__device__ __forceinline__ float wcat(const Operand& op, int k, int j) {
  const float* const* blocks = op.w;
  if (k >= op.din) {
    blocks = op.wp;
    k -= op.din;
  }
  if (j < op.c1) return blocks[0][(size_t)k * op.c1 + j];
  if (j < op.c2) return blocks[1][(size_t)k * (op.c2 - op.c1) + j - op.c1];
  return blocks[2][(size_t)k * (op.wd - op.c2) + j - op.c2];
}

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// xm [m][kxp] = the layer input X = [x*m | pe*m_pe], zero past din + pos:
// each element's mask bits hashed once, for every product that reads X.
// A warp a row, its lanes over the columns (eight loads in flight a
// lane): no division per element, the row keys once a row; bound by bytes.
__global__ void stage_input_kernel(Operand op, TrainArgs ta,
                                   float* __restrict__ xm, long long m,
                                   int kxp) {
  const unsigned kf = stream_key(ta.seed, kStreamFeat);
  const unsigned kp = stream_key(ta.seed, kStreamPe);
  const int kx = op.din + ta.pos;
  const int warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  for (long long r = (long long)blockIdx.x * warps + (threadIdx.x >> 5);
       r < m; r += (long long)gridDim.x * warps) {
    const unsigned rkf = row_key(kf, (unsigned)r);
    const unsigned rkp = row_key(kp, (unsigned)r);
    const float* xr = op.x + r * op.din;
    const float* per = ta.pe + (r % op.n) * ta.pos;
    float* out = xm + r * kxp;
#pragma unroll 8
    for (int k = lane; k < op.din; k += 32) {  // the x columns
      float v = xr[k];
      if (ta.feat_on)
        v *= keep_at(ta, rkf, (unsigned)k, ta.feat_thresh, ta.feat_scale);
      out[k] = v;
    }
    for (int k = op.din + lane; k < kxp; k += 32) {  // pe columns, padding
      float v = 0.f;
      if (k < kx) {
        v = per[k - op.din];
        if (ta.feat_on)
          v *= keep_at(ta, rkp, (unsigned)(k - op.din), ta.feat_thresh,
                       ta.feat_scale);
      }
      out[k] = v;
    }
  }
}

// The weight rows in the products' layouts, zero-padded: wcat_out
// [kxp][wdp] = W (the projection's B), wt [wdp][ntp] = W^T restricted to
// the input columns [kbeg, kbeg + ntp) (the dx product's B). Either may be
// null.
__global__ void pack_weights_kernel(Operand op, TrainArgs ta,
                                    float* __restrict__ wcat_out, int kxp,
                                    int wdp, float* __restrict__ wt,
                                    int kbeg, int ntp) {
  const int kx = op.din + ta.pos;
  const int krows = max(kxp, kbeg + ntp);
  const long long total = (long long)krows * wdp;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int k = (int)(e / wdp), j = (int)(e % wdp);
    const float v = (k < kx && j < op.wd) ? wcat(op, k, j) : 0.f;
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
