// The layer products' arguments, epilogues, dispatch and operand
// preparation, shared by every layer kernel (gat_fwd.cu, gat_bwd.cu,
// gcn.cu). Both element types run on the TMA-fed, warp-specialised wgmma
// ring of gemm_wgmma.cuh: bf16 layers on bf16 wgmma, float32 layers at
// float32 accuracy in 3xTF32 (split precision). Each float32 operand a is
// split as a = a_hi + a_lo, a_hi = tf32(a) (round to nearest), a_lo = a -
// a_hi (the tensor core reads its TF32 bits), and a * b ~ a_hi * b_hi +
// a_hi * b_lo + a_lo * b_hi, each term a TF32 wgmma with float32
// accumulation (a_lo * b_lo, about 2^-22 of a * b, is dropped). Every
// float32 caller of product<> (the projections of K1-K5, the dW and dx
// products of K2, K4 and K5b) runs it; the mma.sync pipeline that served
// them before is gone.
//
// Accuracy: the tensor cores add the products of one wgmma into the
// accumulator with truncation, not round-to-nearest, a bias that grows
// with the depth of the sum (up to 65,536 rows a split in the split-K dW
// sums). Each 64 deep slice of K (two 32-deep K tiles in float32, one K
// tile in bf16) is therefore summed into a fresh register tile and added
// to the running sum with a float32 FADD (round to nearest): the
// truncation reaches only those 64-deep partial sums.
//
// What this file prepares for the float32 product, and what it costs: TF32
// wgmma reads its shared-memory operand K-major only, so B comes as B^T in
// a hi and a lo plane. pack_weights_kernel writes W^T (the projection's
// B) and W's rows (the dx product's B) so, twice the bytes of W, once a
// call (W is at most 2052 x 2008 floats, 16 MB a plane); the dW product's
// B, X^T or D^T (bwd_common.cuh), twice the bytes of the narrower of the
// two. A is read raw and split in registers.
//
// The argument struct, the epilogues' meaning and the operand preparation
// (staging, packing) are templated on E (float, or bf16 for a bf16 layer's
// X, W and dx).
//
// The kernels live in namespace gat (see bwd_common.cuh on nvcc's stubs).
#pragma once

#include <type_traits>

#include "gat_common.cuh"

namespace gat {

// The narrow product tile's columns (the pe columns' dx alone): 64, the
// wide one's 128.
constexpr int kNarrowBN = 64;

// What the epilogue does with the product's element (i, j):
enum GemmEpi {
  kEpiStore = 0,    // c[i * ldc + j] = v
  kEpiRowBias = 1,  // c[i * ldc + j] = v + bias[(i % bias_rows) * ldc + j]
  kEpiDx = 2,       // column k = kbeg + j of the layer input's grad: times
                    // its dropout mask, into dx [i][din] (k < din) or
                    // pe_rows [i][pos] (k >= din)
  kEpiStar = 3,     // (gemm_wgmma.cuh) ft = v + the slot bias as
                    // kEpiRowBias, never stored; the star pass of the
                    // per-slot layer on it (StarArgs), out in the layer's
                    // element type
  kEpiGcn = 4,      // (gemm_wgmma.cuh) z = v + z_bias as kEpiRowBias
                    // through the row map, never stored; the star-GCN
                    // pass on it (StarArgs: the packed rows of gcn.cu),
                    // out in the layer's element type
};

template <class E>
struct GemmArgsT {
  const E* a;          // K-major: (i, k) at a[i * lda + k]; M-major:
  long long lda;       //   a[k * lda + i], i < lda
  const E* b;          // bf16: (k, j) at b[k * ldb + j], j < ldb; float:
  const E* b_lo;       //   B^T, (j, k) at b[j * ldb + k] rounded to TF32
  long long ldb;       //   and its rest at b_lo[j * ldb + k] (gemm_wgmma.cuh)
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
  // or null: the rows of the row operand counted on the card (M of a
  // K-major A, the reduction of an M-major A; m or k is then the
  // allocated rows), and the original row of each output row (the
  // row-bias, dx and star-GCN epilogues)
  const int* rows;
  const int* row_map;
  long long c_rows;    // rows allocated for c (0: m), bf16 only
};

// The star pass of kEpiStar (gat_fwd.cu's fused per-slot forward): the
// product's m rows are whole egonets of n slots, rows_wg = floor(64 / n) * n
// of them a consumer warpgroup's tile; its columns are ft, heads * dh; the
// output out (bf16) or out_f (float32).
// kEpiGcn (gcn.cu's valid-rows forward) reads ngp, out (bf16) or out_f
// (float32), n, p, out_alpha (the leaky's slope), has_out_alpha, row_info
// and bias: its rows are the valid rows of whole egonets packed into
// 64-row warpgroup tiles, the original row of each in GemmArgs::row_map.
struct StarArgs {
  const float4* wts;   // [m][heads] each row's star weights (after dropout):
                       //   w_self, w_anchor, w_to_anchor (gp rows),
                       //   the valid gp count (the anchor's row) or 0
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
  float* out_f;         // float32: [b * n][heads * dh] (kEpiStar),
                        //   [b * n][dout] (kEpiGcn)
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

template <bool kAKMajor, int kEpi, int BN>
inline cudaError_t product_wgmma(const GemmArgsT<bf16>& g,
                                 const TrainArgs& ta, int splits,
                                 const StarArgs& sa, cudaStream_t st);
template <bool kAKMajor, int kEpi, int BN>
inline cudaError_t product_wgmma_f32(const GemmArgsT<float>& g,
                                     const TrainArgs& ta, int splits,
                                     const StarArgs& sa, cudaStream_t st);

// The layer product in the layer's element type E on `st`, on the TMA-fed
// wgmma ring of gemm_wgmma.cuh: 3xTF32 for float, bf16 for bf16. A K-major
// (kAKMajor) or M-major, the epilogue kEpi, `splits` partial products over
// the K range; kNarrow takes the 128 x 64 tile.
template <bool kAKMajor, int kEpi, bool kNarrow = false, class E>
inline cudaError_t product(const GemmArgsT<E>& g, const TrainArgs& ta,
                           int splits, cudaStream_t st) {
  constexpr int BN = kNarrow ? kNarrowBN : 128;
  if constexpr (sizeof(E) == 2)
    return product_wgmma<kAKMajor, kEpi, BN>(g, ta, splits, StarArgs{}, st);
  else
    return product_wgmma_f32<kAKMajor, kEpi, BN>(g, ta, splits,
                                                 StarArgs{}, st);
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

// The weight rows in the products' B layouts, zero-padded; either output
// may be null. bf16 (row-major B, gemm_wgmma.cuh reads it transposed):
// wcat_out [kxp][wdp] = W (the projection's B), wt [wdp][ntp] = W^T
// restricted to the input columns [kbeg, kbeg + ntp) (the dx product's B);
// a bf16 layer's W_p rows are rounded to bf16 (pallas_gat.py:298). float
// (TF32 wgmma reads B K-major only): B^T in two planes, hi = tf32(w) and
// lo = w - hi: wcat_out [2][wdp][kxp] = W^T, wt [2][ntp][wdp] = W's rows
// [kbeg, kbeg + ntp).
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
    const float w = (k < kx && j < op.wd) ? wcat(op, k, j) : 0.f;
    if constexpr (sizeof(E) == 4) {
      const float hi = __uint_as_float(tf32_bits(w)), lo = w - hi;
      if (wcat_out != nullptr && k < kxp) {
        wcat_out[(size_t)j * kxp + k] = hi;
        wcat_out[(size_t)(wdp + j) * kxp + k] = lo;
      }
      if (wt != nullptr && k >= kbeg && k < kbeg + ntp) {
        wt[(size_t)(k - kbeg) * wdp + j] = hi;
        wt[(size_t)(ntp + k - kbeg) * wdp + j] = lo;
      }
    } else {
      const E v = from_float<E>(w);
      if (wcat_out != nullptr && k < kxp) wcat_out[(size_t)k * wdp + j] = v;
      if (wt != nullptr && k >= kbeg && k < kbeg + ntp)
        wt[(size_t)j * ntp + (k - kbeg)] = v;
    }
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
