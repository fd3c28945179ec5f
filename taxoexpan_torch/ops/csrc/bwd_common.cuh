// Backward passes shared by the layer backwards (gat_bwd.cu, gcn.cu). Each
// layer's product is X @ W over the layer input X = [x*m | pe*m_pe]
// ([b*n, din + pos], the masks replayed from the seed) and the weight rows
// W = [W_h; W_p] ([din + pos, wd]). Given D, the grad of that product
// ([b*n, wd] with row stride ldd, zero in the padding columns; a workspace
// the layer's own first pass writes):
//   stage_input_kernel     X once into a workspace (gemm_tf32.cuh), when the
//                          layer has masks or a pe path or x's rows are not
//                          16-byte multiples; else the products read x;
//   pack_weights_kernel    W^T over the input columns the dx product needs;
//   dW = X^T @ D           the 3xTF32 tensor-core product of gemm_tf32.cuh,
//                          A read M-major, split-K over the rows, partial
//                          sums per split in a workspace;
//   reduce_scatter_kernel  adds the splits in a fixed order and scatters
//                          the rows and column blocks into the weight grads;
//   dX = (D @ W^T) * mask  the same product, A = D read K-major, its
//                          epilogue masking and scattering the columns into
//                          dx (the x columns) and the pe rows (the pe
//                          columns);
//   colsum_partial_kernel  chunked sums over egonets (slot grads, dpe),
//                          reduced again by reduce_scatter_kernel.
// Deterministic: no atomics. The kernels live in namespace gat, not in an
// unnamed namespace: nvcc's registration stub cannot name an unnamed
// namespace nested in a named one beside the including file's own.
#pragma once

#include "gemm_tf32.cuh"

namespace gat {

// part[c][i] = sum over the egonets of chunk c of src[b][i], i < rw
__global__ void colsum_partial_kernel(const float* __restrict__ src,
                                      long long nb, long long rw,
                                      long long chunk_b,
                                      float* __restrict__ part) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rw) return;
  const long long b0 = blockIdx.y * chunk_b;
  const long long b1 = min(nb, b0 + chunk_b);
  float sum = 0.f;
  for (long long bb = b0; bb < b1; ++bb) sum += src[bb * rw + i];
  part[blockIdx.y * rw + i] = sum;
}

// Adds nsplit partial [rows, cols] matrices in split order and scatters the
// result into up to six outputs: row blocks [0, row_split) and
// [row_split, rows), column blocks [0, c1), [c1, c2), [c2, c3); columns
// from c3 on (padding) are dropped.
__global__ void reduce_scatter_kernel(const float* __restrict__ part,
                                      int nsplit, long long rows, int cols,
                                      int row_split, int c1, int c2, int c3,
                                      float* o0, float* o1, float* o2,
                                      float* o3, float* o4, float* o5) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = rows * cols;
  if (i >= total) return;
  const long long r = i / cols;
  const int c = (int)(i % cols);
  if (c >= c3) return;
  float sum = 0.f;
  for (int s = 0; s < nsplit; ++s) sum += part[(size_t)s * total + i];
  const bool lower = r >= row_split;
  const long long rr = lower ? r - row_split : r;
  float* outs[6] = {o0, o1, o2, o3, o4, o5};
  int blk, cc, width;
  if (c < c1) {
    blk = 0, cc = c, width = c1;
  } else if (c < c2) {
    blk = 1, cc = c - c1, width = c2 - c1;
  } else {
    blk = 2, cc = c - c2, width = c3 - c2;
  }
  float* o = outs[blk + (lower ? 3 : 0)];
  if (o != nullptr) o[rr * width + cc] = sum;
}

inline unsigned blocks_for(long long count) {
  return (unsigned)((count + kThreads - 1) / kThreads);
}

// The sum over egonets of src [nb, rows, cols] into out [rows, width]
// (columns from width on dropped): chunked partial sums into part
// [chunks, rows * cols], then the fixed-order reduction.
inline cudaError_t sum_over_egonets(const float* src, long long nb,
                                    long long rows, int cols, int width,
                                    int chunks, float* part, float* out,
                                    cudaStream_t st) {
  const long long rw = rows * cols;
  const long long chunk_b = (nb + chunks - 1) / chunks;
  colsum_partial_kernel<<<dim3(blocks_for(rw), chunks), kThreads, 0, st>>>(
      src, nb, rw, chunk_b, part);
  reduce_scatter_kernel<<<blocks_for(rw), kThreads, 0, st>>>(
      part, chunks, rows, cols, (int)rows, width, width, width, out, nullptr,
      nullptr, nullptr, nullptr, nullptr);
  return cudaGetLastError();
}

// Device events between a backward's passes (or a forward's launches),
// recorded only while a caller has switched timing on (the C entry points
// `*_set_timing` / `*_pass_ms`); one set per library.
struct PassMarks {
  cudaEvent_t ev[8];
  int on = 0;
  int count = 0;
};

inline void mark(PassMarks& mk, cudaStream_t st) {
  if (mk.on && mk.count < 8) cudaEventRecord(mk.ev[mk.count++], st);
}

inline int set_timing(PassMarks& mk, int on) {
  if (on && !mk.on)
    for (cudaEvent_t& e : mk.ev)
      if (cudaEventCreate(&e) != cudaSuccess) return (int)cudaGetLastError();
  mk.on = on;
  mk.count = 0;
  return 0;
}

// Milliseconds between consecutive marks of the last timed call into
// out[0 .. count - 2]; returns count - 1 (after synchronising on the last).
inline int pass_ms(PassMarks& mk, float* out) {
  if (mk.count < 2) return 0;
  cudaEventSynchronize(mk.ev[mk.count - 1]);
  for (int i = 1; i < mk.count; ++i)
    cudaEventElapsedTime(&out[i - 1], mk.ev[i - 1], mk.ev[i]);
  const int n = mk.count - 1;
  mk.count = 0;
  return n;
}

// Scratch of the product passes, allocated by the caller.
struct ProductWork {
  float* xm;      // [m, kxp] the staged layer input, or null (read x)
  float* wt;      // [wdp, ntp] W^T over the input columns [kbeg, din + pos)
  float* part_w;  // [splits, din + pos, wd]
  int kxp, wdp, ntp, splits;
};

// X staged (when work.xm is set) and the weights packed: W^T over the
// input columns [kbeg, din + pos) for the dx product into work.wt (kbeg =
// din when dx is not needed: the pe columns alone), and, given wcat_out, W
// [kxp, wdp] for the projection.
inline cudaError_t stage_and_pack(const Operand& op, const TrainArgs& ta,
                                  long long m, const ProductWork& work,
                                  int kbeg, float* wcat_out,
                                  cudaStream_t st) {
  if (work.xm != nullptr)  // 8 rows a block of 256 threads
    stage_input_kernel<<<grid_for(m * 32), 256, 0, st>>>(op, ta, work.xm, m,
                                                         work.kxp);
  if (wcat_out == nullptr && work.ntp == 0) return cudaGetLastError();
  int krows = kbeg + work.ntp;
  if (wcat_out != nullptr && work.kxp > krows) krows = work.kxp;
  pack_weights_kernel<<<grid_for((long long)krows * work.wdp), 256, 0, st>>>(
      op, ta, wcat_out, work.kxp, work.wdp, work.wt, kbeg, work.ntp);
  return cudaGetLastError();
}

// The star-GAT projection P = X @ [fc | wa1 | wa2; wp | wpa1 | wpa2] +
// the slot biases, [m, wdp] over all m = b*n rows (X staged and W packed
// into wcat [kxp, wdp] by stage_and_pack; X is x itself when xm is null):
// the product the per-slot forward's star pass and K2's head core read.
inline cudaError_t gat_projection(const Operand& op, const float* xm,
                                  int kxp, const float* wcat, int wdp,
                                  const float* bias_ft, const float* bias_a1,
                                  const float* bias_a2, float* biascat,
                                  float* proj, long long m, cudaStream_t st) {
  pack_bias_kernel<<<grid_for((long long)op.n * wdp), 256, 0, st>>>(
      bias_ft, bias_a1, bias_a2, op.n, op.c1, op.c2, op.wd, wdp, biascat);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  GemmArgs g = {};
  g.a = xm != nullptr ? xm : op.x;
  g.lda = xm != nullptr ? kxp : op.din;
  g.b = wcat;
  g.ldb = wdp;
  g.c = proj;
  g.ldc = wdp;
  g.m = m;
  g.n = wdp;
  g.k = g.lda;
  g.k_chunk = g.lda;
  g.bias = biascat;
  g.bias_rows = op.n;
  return gemm_tf32x3<true, kEpiRowBias>(g, TrainArgs{}, 1, st);
}

// The passes after the layer's own first one, from D [m, ldd] (X staged
// and W^T packed by stage_and_pack):
//  - dW = X^T @ D split-K into work.part_w, reduced into dw[i] (x rows) and
//    dwp[i] (pe rows), column block i;
//  - dx (need_dx) and the pe rows' grads pe_rows [m, pos] = (D @ W^T) *
//    mask, then dpe [n, pos] = their sum over egonets via part_pe
//    [chunks, n * pos].
inline cudaError_t product_grads(const Operand& op, const TrainArgs& ta,
                                 const float* d, int ldd, long long m,
                                 const ProductWork& work, int chunks,
                                 float* const dw[3], float* const dwp[3],
                                 int need_dx, float* dx, float* pe_rows,
                                 float* part_pe, float* dpe, PassMarks& mk,
                                 cudaStream_t st) {
  cudaError_t err;
  const int kx = op.din + ta.pos;
  const bool staged = work.xm != nullptr;
  GemmArgs g = {};
  g.a = staged ? work.xm : op.x;
  g.lda = staged ? work.kxp : op.din;
  g.b = d;
  g.ldb = ldd;
  g.c = work.part_w;
  g.ldc = op.wd;
  g.c_split = (long long)kx * op.wd;
  g.m = kx;
  g.n = op.wd;
  g.k = m;
  constexpr int bk = GemmTileDefault::BK;
  g.k_chunk = ((m + work.splits - 1) / work.splits + bk - 1) / bk * bk;
  err = gemm_tf32x3<false, kEpiStore>(g, ta, work.splits, st);
  if (err != cudaSuccess) return err;
  reduce_scatter_kernel<<<blocks_for((long long)kx * op.wd), kThreads, 0,
                          st>>>(work.part_w, work.splits, kx, op.wd, op.din,
                                op.c1, op.c2, op.wd, dw[0], dw[1], dw[2],
                                dwp[0], dwp[1], dwp[2]);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mark(mk, st);

  const int kbeg = need_dx ? 0 : op.din;  // else the pe columns alone
  if (kx > kbeg) {
    GemmArgs x = {};
    x.a = d;
    x.lda = ldd;
    x.b = work.wt;
    x.ldb = work.ntp;
    x.m = m;
    x.n = kx - kbeg;
    x.k = ldd;
    x.k_chunk = ldd;
    x.dx = dx;
    x.pe_rows = pe_rows;
    x.din = op.din;
    x.kbeg = kbeg;
    err = x.n <= GemmTileNarrow::BN
              ? gemm_tf32x3<true, kEpiDx, GemmTileNarrow>(x, ta, 1, st)
              : gemm_tf32x3<true, kEpiDx>(x, ta, 1, st);
    if (err != cudaSuccess) return err;
  }
  if (ta.pos > 0) {
    err = sum_over_egonets(pe_rows, m / op.n, op.n, ta.pos, ta.pos, chunks,
                           part_pe, dpe, st);
    if (err != cudaSuccess) return err;
  }
  mark(mk, st);
  return cudaSuccess;
}

}  // namespace gat
