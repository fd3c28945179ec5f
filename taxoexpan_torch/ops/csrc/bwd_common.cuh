// Backward passes shared by the layer backwards (gat_bwd.cu, gcn.cu). Each
// layer's product is X @ W over the layer input X = [x*m | pe*m_pe]
// ([b*n, din + pos], the masks replayed from the seed as X is staged) and
// the weight rows W = [W_h; W_p] ([din + pos, wd]). Given D, the grad of
// that product ([b*n, wd], a workspace the layer's own first pass writes):
//   xt_d_splitk_kernel     dW = X^T @ D as a split-K product, partial sums
//                          per split in a workspace;
//   reduce_scatter_kernel  adds the splits in a fixed order and scatters
//                          the rows and column blocks into the weight grads;
//   d_wt_kernel            dX = (D @ W^T) * mask, into dx (the x columns)
//                          and the pe rows (the pe columns);
//   colsum_partial_kernel  chunked sums over egonets (slot grads, dpe),
//                          reduced again by reduce_scatter_kernel.
// Deterministic: no atomics. The products are register-tiled (4 x 8 a
// thread, 64 x 128 a block, K tiles of 16 in shared memory), float32 FMAs.
// The kernels live in namespace gat, not in an unnamed namespace: nvcc's
// registration stub cannot name an unnamed namespace nested in a named one
// beside the including file's own.
#pragma once

#include "gat_common.cuh"

namespace gat {

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

// Element (m, k) of X (k < din + pos).
__device__ __forceinline__ float xcat(const Operand& op, const TrainArgs& ta,
                                      long long m, int k, unsigned rkf,
                                      unsigned rkp) {
  if (k < op.din) {
    float v = op.x[(size_t)m * op.din + k];
    if (ta.feat_on)
      v *= keep_at(ta, rkf, (unsigned)k, ta.feat_thresh, ta.feat_scale);
    return v;
  }
  const int kp = k - op.din;
  float v = ta.pe[(size_t)(m % op.n) * ta.pos + kp];
  if (ta.feat_on)
    v *= keep_at(ta, rkp, (unsigned)kp, ta.feat_thresh, ta.feat_scale);
  return v;
}

// Element (k, j) of W.
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

// part[split][k][j] = sum over the rows m of the split of X(m, k) D[m][j]
__global__ void __launch_bounds__(kThreads)
xt_d_splitk_kernel(Operand op, TrainArgs ta, const float* __restrict__ d,
                   float* __restrict__ part, int kx, long long m_total,
                   long long chunk) {
  __shared__ __align__(16) float xs[kTileK][kXsStride];
  __shared__ __align__(16) float ds[kTileK][kTileCols];
  __shared__ unsigned rkf[kTileK], rkp[kTileK];
  const int wd = op.wd;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int j0 = blockIdx.x * kTileCols, k0 = blockIdx.y * kRowsPerChunk;
  const long long m_beg = blockIdx.z * chunk;
  const long long m_end = min(m_total, m_beg + chunk);
  const unsigned kf = stream_key(ta.seed, kStreamFeat);
  const unsigned kp = stream_key(ta.seed, kStreamPe);
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (long long m0 = m_beg; m0 < m_end; m0 += kTileK) {
    if (t < kTileK) {
      rkf[t] = row_key(kf, (unsigned)(m0 + t));
      rkp[t] = row_key(kp, (unsigned)(m0 + t));
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kTileK * kRowsPerChunk / kThreads; ++q) {
      const int e = t + q * kThreads;
      const int mm = e / kRowsPerChunk, kk = e % kRowsPerChunk;
      const long long m = m0 + mm;
      const int k = k0 + kk;
      xs[mm][kk] =
          (m < m_end && k < kx) ? xcat(op, ta, m, k, rkf[mm], rkp[mm]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kTileK * kTileCols / kThreads; ++q) {
      const int e = t + q * kThreads;
      const int mm = e / kTileCols, jj = e % kTileCols;
      const long long m = m0 + mm;
      const int j = j0 + jj;
      ds[mm][jj] = (m < m_end && j < wd) ? d[(size_t)m * wd + j] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < kTileK; ++mm) {
      const float4 xv = *reinterpret_cast<const float4*>(&xs[mm][ty * 4]);
      const float4 d0 = *reinterpret_cast<const float4*>(&ds[mm][tx * 4]);
      const float4 d1 = *reinterpret_cast<const float4*>(&ds[mm][64 + tx * 4]);
      const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
      const float dc[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xr[i], dc[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.z * kx * wd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= kx) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j0 + ((j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (c < wd) out[(size_t)k * wd + c] = acc[i][j];
    }
  }
}

// out(m, k) = sum_j D[m][j] W(k, j) for k in [kbeg, kx): k < din -> dx
// (times the feature mask), else pe_rows (times the pe mask)
__global__ void __launch_bounds__(kThreads)
d_wt_kernel(Operand op, TrainArgs ta, const float* __restrict__ d,
            float* __restrict__ dx, float* __restrict__ pe_rows, int kbeg,
            int kx, long long m_total) {
  __shared__ __align__(16) float ds[kTileK][kXsStride];
  __shared__ __align__(16) float ws[kTileK][kTileCols];
  const int wd = op.wd;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int k0 = kbeg + blockIdx.x * kTileCols;
  const long long m0 = (long long)blockIdx.y * kRowsPerChunk;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int j0 = 0; j0 < wd; j0 += kTileK) {
#pragma unroll
    for (int q = 0; q < kRowsPerChunk * kTileK / kThreads; ++q) {
      const int e = t + q * kThreads;
      const int mm = e / kTileK, jj = e % kTileK;
      const long long m = m0 + mm;
      const int j = j0 + jj;
      ds[jj][mm] = (m < m_total && j < wd) ? d[(size_t)m * wd + j] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kTileK * kTileCols / kThreads; ++q) {
      const int e = t + q * kThreads;
      const int kk = e / kTileK, jj = e % kTileK;
      const int k = k0 + kk, j = j0 + jj;
      ws[jj][kk] = (k < kx && j < wd) ? wcat(op, k, j) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < kTileK; ++jj) {
      const float4 dv = *reinterpret_cast<const float4*>(&ds[jj][ty * 4]);
      const float4 w0 = *reinterpret_cast<const float4*>(&ws[jj][tx * 4]);
      const float4 w1 = *reinterpret_cast<const float4*>(&ws[jj][64 + tx * 4]);
      const float dr[4] = {dv.x, dv.y, dv.z, dv.w};
      const float wc[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(dr[i], wc[j], acc[i][j]);
    }
    __syncthreads();
  }
  const unsigned kf = stream_key(ta.seed, kStreamFeat);
  const unsigned kp = stream_key(ta.seed, kStreamPe);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= m_total) continue;
    const unsigned rkf = row_key(kf, (unsigned)m);
    const unsigned rkp = row_key(kp, (unsigned)m);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + ((j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (k >= kx) continue;
      float v = acc[i][j];
      if (k < op.din) {
        if (ta.feat_on)
          v *= keep_at(ta, rkf, (unsigned)k, ta.feat_thresh, ta.feat_scale);
        dx[(size_t)m * op.din + k] = v;
      } else {
        const int kpe = k - op.din;
        if (ta.feat_on)
          v *= keep_at(ta, rkp, (unsigned)kpe, ta.feat_thresh,
                       ta.feat_scale);
        pe_rows[(size_t)m * ta.pos + kpe] = v;
      }
    }
  }
}

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
// [row_split, rows), column blocks [0, c1), [c1, c2), [c2, cols).
__global__ void reduce_scatter_kernel(const float* __restrict__ part,
                                      int nsplit, long long rows, int cols,
                                      int row_split, int c1, int c2,
                                      float* o0, float* o1, float* o2,
                                      float* o3, float* o4, float* o5) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = rows * cols;
  if (i >= total) return;
  float sum = 0.f;
  for (int s = 0; s < nsplit; ++s) sum += part[(size_t)s * total + i];
  const long long r = i / cols;
  const int c = (int)(i % cols);
  const bool lower = r >= row_split;
  const long long rr = lower ? r - row_split : r;
  float* outs[6] = {o0, o1, o2, o3, o4, o5};
  int blk, cc, width;
  if (c < c1) {
    blk = 0, cc = c, width = c1;
  } else if (c < c2) {
    blk = 1, cc = c - c1, width = c2 - c1;
  } else {
    blk = 2, cc = c - c2, width = cols - c2;
  }
  float* o = outs[blk + (lower ? 3 : 0)];
  if (o != nullptr) o[rr * width + cc] = sum;
}

inline unsigned blocks_for(long long count) {
  return (unsigned)((count + kThreads - 1) / kThreads);
}

// The sum over egonets of src [nb, rw] into out [rw]: chunked partial sums
// into part [chunks, rw], then the fixed-order reduction.
inline cudaError_t sum_over_egonets(const float* src, long long nb,
                                    long long rw, int chunks, float* part,
                                    float* out, cudaStream_t st) {
  const long long chunk_b = (nb + chunks - 1) / chunks;
  colsum_partial_kernel<<<dim3(blocks_for(rw), chunks), kThreads, 0, st>>>(
      src, nb, rw, chunk_b, part);
  reduce_scatter_kernel<<<blocks_for(rw), kThreads, 0, st>>>(
      part, chunks, 1, (int)rw, 1, (int)rw, (int)rw, out, nullptr, nullptr,
      nullptr, nullptr, nullptr);
  return cudaGetLastError();
}

// The passes after a layer's own first one, from D [m, wd]:
//  - dW = X^T @ D, split-K into part_w [splits, din + pos, wd], reduced
//    into dw[i] (x rows) and dwp[i] (pe rows), column block i;
//  - dx (need_dx) and the pe rows' grads pe_rows [m, pos] = (D @ W^T) *
//    mask, then dpe [n, pos] = their sum over egonets via part_pe
//    [chunks, n * pos].
inline cudaError_t product_grads(const Operand& op, const TrainArgs& ta,
                                 const float* d, long long m, int splits,
                                 int chunks, float* part_w,
                                 float* const dw[3], float* const dwp[3],
                                 int need_dx, float* dx, float* pe_rows,
                                 float* part_pe, float* dpe,
                                 cudaStream_t st) {
  cudaError_t err;
  const int kx = op.din + ta.pos;
  const long long chunk = (m + splits - 1) / splits;
  const dim3 wgrid((op.wd + kTileCols - 1) / kTileCols,
                   (kx + kRowsPerChunk - 1) / kRowsPerChunk, splits);
  xt_d_splitk_kernel<<<wgrid, kThreads, 0, st>>>(op, ta, d, part_w, kx, m,
                                                 chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  reduce_scatter_kernel<<<blocks_for((long long)kx * op.wd), kThreads, 0,
                          st>>>(part_w, splits, kx, op.wd, op.din, op.c1,
                                op.c2, dw[0], dw[1], dw[2], dwp[0], dwp[1],
                                dwp[2]);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int kbeg = need_dx ? 0 : op.din;
  if (kx > kbeg) {
    const long long mtiles = (m + kRowsPerChunk - 1) / kRowsPerChunk;
    if (mtiles > 65535) return cudaErrorInvalidValue;
    const dim3 xgrid((kx - kbeg + kTileCols - 1) / kTileCols,
                     (unsigned)mtiles);
    d_wt_kernel<<<xgrid, kThreads, 0, st>>>(op, ta, d, dx, pe_rows, kbeg, kx,
                                            m);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (ta.pos > 0)
    return sum_over_egonets(pe_rows, m / op.n, (long long)op.n * ta.pos,
                            chunks, part_pe, dpe, st);
  return cudaSuccess;
}

}  // namespace gat
