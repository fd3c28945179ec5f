// Backward passes shared by the layer backwards (gat_bwd.cu, gcn.cu). Each
// layer's product is X @ W over the layer input X = [x*m | pe*m_pe]
// ([b*n, din + pos], the masks replayed from the seed) and the weight rows
// W = [W_h; W_p] ([din + pos, wd]). Given D, the grad of that product
// ([b*n, wd] with row stride ldd, zero in the padding columns; a workspace
// the layer's own first pass writes):
//   stage_input_kernel     X once into a workspace (gemm_tf32.cuh), when the
//                          layer has masks or a pe path or x's rows are not
//                          16-byte multiples; else the products read x;
//   pack_weights_kernel    W^T over the input columns the dx product needs
//                          (float32: W's rows, TF32 hi / lo planes);
//   dW = X^T @ D           the tensor-core product (gemm_wgmma.cuh: 3xTF32,
//                          or in a bf16 layer bf16 on D in bf16), A read
//                          M-major (float32: B, the narrower of X and D,
//                          transposed into planes, dw_operands), split-K
//                          over the rows, float32 partial sums per split
//                          in a workspace;
//   reduce_scatter_kernel  adds the splits in a fixed order and scatters
//                          the rows and column blocks into the weight grads
//                          (the x rows' in the layer's element type, so
//                          rounded to bf16 in a bf16 layer, pallas_gat.py:
//                          1097; the pe rows' float32);
//   dX = (D @ W^T) * mask  the same product, A = D read K-major, its
//                          epilogue masking and scattering the columns into
//                          dx (the x columns) and the pe rows (the pe
//                          columns);
//   colsum_partial_kernel  chunked sums over egonets (slot grads, dpe),
//                          reduced again by reduce_scatter_kernel.
// Deterministic: no atomics. The functions are templated on the layer's
// element type E (float, or bf16: x, W_h, the staged X, the packed W and
// dx in bf16; P, D, the slot and pe grads float32). The kernels live in
// namespace gat, not in an unnamed namespace: nvcc's registration stub
// cannot name an unnamed namespace nested in a named one beside the
// including file's own.
#pragma once

#include "gemm_wgmma.cuh"

namespace gat {

// Rows after the valid ones that a compacted operand holds as zeros (one
// K tile of the bf16 product), so that the dW product's last K tile reads
// zeros past the valid rows (gat_bwd.cu).
constexpr int kRowPad = 64;

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

// Adds nsplit partial [rows, cols] matrices (trans: [cols, rows]) in split
// order and scatters the result into up to six outputs: row blocks
// [0, row_split) (o0-o2, of element type O) and [row_split, rows) (o3-o5,
// float), column blocks [0, c1), [c1, c2), [c2, c3); columns from c3 on
// (padding) are dropped.
template <class O>
__global__ void reduce_scatter_kernel(const float* __restrict__ part,
                                      int nsplit, long long rows, int cols,
                                      int row_split, int c1, int c2, int c3,
                                      O* o0, O* o1, O* o2, float* o3,
                                      float* o4, float* o5, int trans = 0) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = rows * cols;
  if (i >= total) return;
  const long long r = i / cols;
  const int c = (int)(i % cols);
  if (c >= c3) return;
  const long long at = trans ? c * rows + r : i;
  float sum = 0.f;
  for (int s = 0; s < nsplit; ++s) sum += part[(size_t)s * total + at];
  const bool lower = r >= row_split;
  const long long rr = lower ? r - row_split : r;
  int blk, cc, width;
  if (c < c1) {
    blk = 0, cc = c, width = c1;
  } else if (c < c2) {
    blk = 1, cc = c - c1, width = c2 - c1;
  } else {
    blk = 2, cc = c - c2, width = c3 - c2;
  }
  if (lower) {
    float* outs[3] = {o3, o4, o5};
    if (outs[blk] != nullptr) outs[blk][rr * width + cc] = sum;
  } else {
    O* outs[3] = {o0, o1, o2};
    if (outs[blk] != nullptr) outs[blk][rr * width + cc] = from_float<O>(sum);
  }
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
  reduce_scatter_kernel<float><<<blocks_for(rw), kThreads, 0, st>>>(
      part, chunks, rows, cols, (int)rows, width, width, width, out, nullptr,
      nullptr, nullptr, nullptr, nullptr);
  return cudaGetLastError();
}

// The dW product of a float32 layer, dW = X^T @ D over the batch's rows,
// reads its B K-major (gemm_wgmma.cuh), neither X [rows][kx] nor D
// [rows][wd] is, so B is the transpose of the narrower of the two, in hi /
// lo planes [2][cols_p][ldr] (transpose_split_kernel: twice the bytes of
// the narrower operand, written once; config.mag.json's layer 0 X^T, 2 x
// 315 MB at B = 4096, its final layer D^T on the valid rows, 2 x 267 MB),
// and A the other, read M-major as it lies. bx: B = X^T (kx <= wd), the
// product then computes dW^T, which the reduction reads transposed.
struct DwOperands {
  bool bx;
  int cols, cols_p;  // B's rows: X's or D's columns, and their padding
  long long ldr;     // the planes' row stride: the rows rounded up to 4
};

inline DwOperands dw_operands(int kx, int kxp, int wd, int wdp,
                              long long rows_alloc) {
  DwOperands o;
  o.bx = kx <= wd;
  o.cols = o.bx ? kx : wd;
  o.cols_p = o.bx ? kxp : wdp;
  o.ldr = (rows_alloc + 3) / 4 * 4;
  return o;
}

// dst [2][cols_p][ldr]: dst[c][r] = tf32(src[r][c]) (the hi plane,
// rounded to nearest) and src[r][c] - hi (the lo plane, from cols_p * ldr
// on), for rows r < R (*rows_dev, counted on the card, where given; else
// `rows`) and columns c < cols, zero for the columns [cols, cols_p) and the
// rows [R, R rounded up to 32) (the product's last K tile); rows past
// those are not written (the product reads no further). 32 x 32 tiles
// through shared memory, so that reads and writes are coalesced; bound by
// bytes (one read, two writes).
__global__ void transpose_split_kernel(const float* __restrict__ src,
                                       long long lds, int cols, int cols_p,
                                       long long rows,
                                       const int* __restrict__ rows_dev,
                                       long long ldr,
                                       float* __restrict__ dst) {
  __shared__ float tile[32][33];
  const long long nr =
      rows_dev != nullptr ? min((long long)*rows_dev, rows) : rows;
  const long long r0 = (long long)blockIdx.x * 32;
  if (r0 >= (nr + 31) / 32 * 32) return;
  const int c0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;  // 32 x 8 threads
  for (int q = ty; q < 32; q += 8) {
    const long long r = r0 + q;
    const int c = c0 + tx;
    tile[q][tx] = r < nr && c < cols ? src[r * lds + c] : 0.f;
  }
  __syncthreads();
  const long long plane = (long long)cols_p * ldr;
  for (int q = ty; q < 32; q += 8) {
    const long long c = c0 + q, r = r0 + tx;
    if (c < cols_p && r < ldr) {
      const float v = tile[tx][q];
      const float hi = __uint_as_float(tf32_bits(v));
      dst[c * ldr + r] = hi;
      dst[plane + c * ldr + r] = v - hi;
    }
  }
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
template <class E>
struct ProductWorkT {
  E* xm;          // [m, kxp] the staged layer input, or null (read x)
  E* wt;          // [wdp, ntp] W^T over the input columns [kbeg, din + pos)
  float* part_w;  // [splits, din + pos, wd]
  int kxp, wdp, ntp, splits;
  float* bt = nullptr;  // float only: the dW product's B planes
                        // (dw_operands), [2][kxp or wdp][ldr]
};
using ProductWork = ProductWorkT<float>;

// X staged (when work.xm is set) and the weights packed: W^T over the
// input columns [kbeg, din + pos) for the dx product into work.wt (kbeg =
// din when dx is not needed: the pe columns alone), and, given wcat_out, W
// [kxp, wdp] for the projection.
template <class E>
inline cudaError_t stage_and_pack(const OperandT<E>& op, const TrainArgs& ta,
                                  long long m, const ProductWorkT<E>& work,
                                  int kbeg, E* wcat_out, cudaStream_t st) {
  if (work.xm != nullptr)  // 8 rows a block of 256 threads
    stage_input_kernel<E><<<grid_for(m * 32), 256, 0, st>>>(op, ta, work.xm,
                                                            m, work.kxp);
  if (wcat_out == nullptr && work.ntp == 0) return cudaGetLastError();
  int krows = kbeg + work.ntp;
  if (wcat_out != nullptr && work.kxp > krows) krows = work.kxp;
  pack_weights_kernel<E>
      <<<grid_for((long long)krows * work.wdp), 256, 0, st>>>(
          op, ta, wcat_out, work.kxp, work.wdp, work.wt, kbeg, work.ntp);
  return cudaGetLastError();
}

// ------------------------------------------------------- the valid rows
// K3 bf16 (gat_fwd.cu) and K4 (gat_bwd.cu, both dtypes) run their products
// on the valid rows of the batch alone, compacted in order (each egonet's
// grandparents, anchor, siblings), counted and scanned on the card.

// The slot of row r in egonet b's valid rows (0..ngp-1 the grandparents,
// ngp the anchor, then the siblings), or -1 for an invalid slot: a valid
// egonet's slots are the two runs 0..ngp and p+1..p+nsib.
__device__ __forceinline__ int valid_pos(int r, int ngp, int nsib, int p) {
  if (r < p) return r < ngp ? r : -1;
  if (r == p) return ngp;
  return r - p - 1 < nsib ? ngp + 1 + (r - p - 1) : -1;
}

// off[b] = the first valid row of egonet b among the valid rows of all
// egonets in order; off[nb] = R, their count. One block of 1024 threads: a
// contiguous run of egonets a thread, then an exclusive scan of the runs'
// counts.
__global__ void valid_row_offsets_kernel(const int* __restrict__ ngp,
                                         const int* __restrict__ nsib,
                                         int nb, int n, int p,
                                         int* __restrict__ off) {
  __shared__ int warp_sums[32];
  const int per = (nb + blockDim.x - 1) / blockDim.x;
  const int beg = min(nb, (int)threadIdx.x * per), end = min(nb, beg + per);
  auto count = [&](int b) {
    return min(max(ngp[b], 0), p) + 1 + min(max(nsib[b], 0), n - p - 1);
  };
  int local = 0;
  for (int b = beg; b < end; ++b) local += count(b);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sums[w] = incl;
  __syncthreads();
  if (w == 0) {
    const int v = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0;
    int sc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, sc, o);
      if (lane >= o) sc += u;
    }
    warp_sums[lane] = sc - v;  // the warps' exclusive prefixes
  }
  __syncthreads();
  int run = warp_sums[w] + incl - local;
  for (int b = beg; b < end; ++b) {
    off[b] = run;
    run += count(b);
  }
  if (threadIdx.x == blockDim.x - 1) off[nb] = run;
}

// The valid rows staged compacted: a warp a row of the m = nb*n rows. A
// valid row r is staged as stage_input_kernel stages it (its own masks,
// the keys of row r) into xc at its compacted row, which row_map records.
// The backward (K4) also passes dx (need_dx) and pe_rows: an invalid row's
// dx and pe-row grads are zeroed, the values the reference's formula
// gives there; and dpad, the products' D (bf16 D, or float32 Dcat). The
// kRowPad rows after the R valid ones are zero in xc and, where given,
// dpad, for the dW product's last K tile. The forward (K3) passes null for
// all three.
template <class E, class D>
__global__ void stage_valid_rows_kernel(OperandT<E> op, TrainArgs ta,
                                        const int* __restrict__ ngp,
                                        const int* __restrict__ nsib, int p,
                                        const int* __restrict__ off, int nb,
                                        E* __restrict__ xc, int kxp,
                                        int* __restrict__ row_map,
                                        E* __restrict__ dx,
                                        float* __restrict__ pe_rows,
                                        D* __restrict__ dpad, int wdp) {
  const unsigned kf = stream_key(ta.seed, kStreamFeat);
  const unsigned kp = stream_key(ta.seed, kStreamPe);
  const int n = op.n;
  const long long m = (long long)nb * n;
  const int warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  for (long long r = (long long)blockIdx.x * warps + (threadIdx.x >> 5);
       r < m + kRowPad; r += (long long)gridDim.x * warps) {
    if (r >= m) {
      const long long q = off[nb] + (r - m);
      for (int k = lane; k < kxp; k += 32)
        xc[q * kxp + k] = from_float<E>(0.f);
      if (dpad != nullptr)
        for (int k = lane; k < wdp; k += 32)
          dpad[q * wdp + k] = from_float<D>(0.f);
      continue;
    }
    const long long b = r / n;
    const int slot = (int)(r % n);
    const int q = valid_pos(slot, min(max(ngp[b], 0), p),
                            min(max(nsib[b], 0), n - p - 1), p);
    if (q < 0) {
      if (dx != nullptr)
        for (int k = lane; k < op.din; k += 32)
          dx[r * op.din + k] = from_float<E>(0.f);
      if (pe_rows != nullptr)
        for (int k = lane; k < ta.pos; k += 32) pe_rows[r * ta.pos + k] = 0.f;
      continue;
    }
    const long long ci = off[b] + q;
    if (lane == 0) row_map[ci] = (int)r;
    stage_row(op, ta, kf, kp, r, xc + ci * kxp, kxp, lane);
  }
}

// The layer projection P = X @ W + the slot biases, [m, wdp] over all
// m = b*n rows (X staged and W packed into wcat by stage_and_pack; X is
// x itself when xm is null): star-GAT W = [fc | wa1 |
// wa2; wp | wpa1 | wpa2] with bias_ft, bias_a1, bias_a2, the product the
// GAT star passes and K2's head core read; star-GCN (gcn.cu) W = [W_h;
// W_p] with z_bias alone (bias_a1, bias_a2 null), z. P is float32 in
// either element type (pallas_gat.py:289-291). With `rows`, the m
// allocated rows of xm hold *rows valid rows (counted on the card, K4's
// compaction in gat_bwd.cu), the original row of each in row_map.
template <class E>
inline cudaError_t gat_projection(const OperandT<E>& op, const E* xm,
                                  int kxp, const E* wcat, int wdp,
                                  const float* bias_ft, const float* bias_a1,
                                  const float* bias_a2, float* biascat,
                                  float* proj, long long m, cudaStream_t st,
                                  const int* rows = nullptr,
                                  const int* row_map = nullptr) {
  pack_bias_kernel<<<grid_for((long long)op.n * wdp), 256, 0, st>>>(
      bias_ft, bias_a1, bias_a2, op.n, op.c1, op.c2, op.wd, wdp, biascat);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  GemmArgsT<E> g = {};
  g.a = xm != nullptr ? xm : op.x;
  g.lda = xm != nullptr ? kxp : op.din;
  g.b = wcat;
  g.ldb = wdp;
  if constexpr (sizeof(E) == 4) {  // W^T planes [2][wdp][kxp]
    g.b_lo = wcat + (long long)wdp * kxp;
    g.ldb = kxp;
  }
  g.c = proj;
  g.ldc = wdp;
  g.m = rows != nullptr ? m + kRowPad : m;
  g.c_rows = m;
  g.n = wdp;
  g.k = g.lda;
  g.k_chunk = g.lda;
  g.bias = biascat;
  g.bias_rows = op.n;
  g.rows = rows;
  g.row_map = row_map;
  return product<true, kEpiRowBias>(g, TrainArgs{}, 1, st);
}

// The passes after the layer's own first one, from D [m, ldd] in the
// layer's element type (X staged and W^T packed by stage_and_pack):
//  - dW = X^T @ D split-K into work.part_w, reduced into dw[i] (x rows) and
//    dwp[i] (pe rows), column block i;
//  - dx (need_dx) and the pe rows' grads pe_rows [m, pos] = (D @ W^T) *
//    mask, then dpe [n, pos] = their sum over egonets via part_pe
//    [chunks, n * pos].
// With `rows`, X and D hold *rows valid rows of the m allocated ones (zero
// rows after them up to a K tile), dx and pe_rows keep the original rows
// (row_map) and are zero elsewhere (gat_bwd.cu).
template <class E>
inline cudaError_t product_grads(const OperandT<E>& op, const TrainArgs& ta,
                                 const E* d, int ldd, long long m,
                                 const ProductWorkT<E>& work, int chunks,
                                 E* const dw[3], float* const dwp[3],
                                 int need_dx, E* dx, float* pe_rows,
                                 float* part_pe, float* dpe, PassMarks& mk,
                                 cudaStream_t st, const int* rows = nullptr,
                                 const int* row_map = nullptr) {
  cudaError_t err;
  const int kx = op.din + ta.pos;
  const bool staged = work.xm != nullptr;
  const long long rows_alloc = rows != nullptr ? m + kRowPad : m;
  const E* xs = staged ? work.xm : op.x;
  const long long ldx = staged ? work.kxp : op.din;
  GemmArgsT<E> g = {};
  g.c = work.part_w;
  g.c_split = (long long)kx * op.wd;
  g.k = rows_alloc;
  g.k_chunk = ((m + work.splits - 1) / work.splits + 63) / 64 * 64;
  g.rows = rows;
  int trans = 0;
  if constexpr (sizeof(E) == 4) {  // B = X^T or D^T in planes (DwOperands)
    const DwOperands o =
        dw_operands(kx, work.kxp, op.wd, work.wdp, rows_alloc);
    if (work.bt == nullptr || (o.cols_p + 31) / 32 > 65535)
      return cudaErrorInvalidValue;
    transpose_split_kernel<<<dim3((unsigned)((rows_alloc + 31) / 32),
                                  (unsigned)((o.cols_p + 31) / 32)),
                             dim3(32, 8), 0, st>>>(
        o.bx ? xs : d, o.bx ? ldx : ldd, o.cols, o.cols_p, rows_alloc, rows,
        o.ldr, work.bt);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    g.a = o.bx ? d : xs;
    g.lda = o.bx ? ldd : ldx;
    g.b = work.bt;
    g.b_lo = work.bt + (long long)o.cols_p * o.ldr;
    g.ldb = o.ldr;
    g.m = o.bx ? op.wd : kx;
    g.n = o.bx ? kx : op.wd;
    trans = o.bx;
  } else {
    g.a = xs;
    g.lda = ldx;
    g.b = d;
    g.ldb = ldd;
    g.m = kx;
    g.n = op.wd;
  }
  g.ldc = g.n;
  err = product<false, kEpiStore>(g, ta, work.splits, st);
  if (err != cudaSuccess) return err;
  reduce_scatter_kernel<E><<<blocks_for((long long)kx * op.wd), kThreads, 0,
                             st>>>(work.part_w, work.splits, kx, op.wd,
                                   op.din, op.c1, op.c2, op.wd, dw[0], dw[1],
                                   dw[2], dwp[0], dwp[1], dwp[2], trans);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mark(mk, st);

  const int kbeg = need_dx ? 0 : op.din;  // else the pe columns alone
  if (kx > kbeg) {
    GemmArgsT<E> x = {};
    x.a = d;
    x.lda = ldd;
    x.b = work.wt;
    x.ldb = work.ntp;
    if constexpr (sizeof(E) == 4) {  // W's rows [kbeg, kx): [2][ntp][wdp]
      x.b_lo = work.wt + (long long)work.ntp * work.wdp;
      x.ldb = work.wdp;
    }
    x.m = rows_alloc;
    x.n = kx - kbeg;
    x.k = ldd;
    x.k_chunk = ldd;
    x.dx = dx;
    x.pe_rows = pe_rows;
    x.din = op.din;
    x.kbeg = kbeg;
    x.rows = rows;
    x.row_map = row_map;
    err = x.n <= kNarrowBN
              ? product<true, kEpiDx, true>(x, ta, 1, st)
              : product<true, kEpiDx>(x, ta, 1, st);
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
