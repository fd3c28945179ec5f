// Star-GAT layer backward kernels for Hopper (sm_90a), float32.
//
// Replace the backward Pallas kernels of taxoexpan_tpu/ops/pallas_gat.py:
//   gat_layer_bwd (K2)        <- fused_gat_layer's VJP (_fused_bwd,
//                                _bwd_kernel, _bwd_head_core, _bwd_epilogue)
//   gat_layer_pooled_bwd (K4) <- fused_gat_layer_pooled's VJP
//                                (_fused_pooled_bwd, _bwd_pool_kernel)
// Both recompute ft and the attention from the layer input (ft is never
// stored) and replay the forward's dropout masks: the bits are a pure
// function of (seed, stream, row, column), gat_common.cuh.
//
// Passes, one C entry point (gat_layer_bwd_f32) launching them in order:
//  1. head core, one block per (egonet, head): a1/a2 and the softmax once,
//     then per 128-column tile of the head the ft tile (the forward's
//     register-tiled product), the incoming grad tile (K2: g, chained
//     through leaky'(pre) of the recomputed pre-activation when the layer
//     fuses out_alpha; K4: the three pool rows broadcast over the VALID
//     slots and scaled by 1/heads), the dft tile (the aggregation
//     transposed) and the per-edge d(attention) partial sums over the
//     tile's columns. d(attention) reduces over the head's whole Dh, so
//     da1/da2 (softmax Jacobian, leaky' of the logits, the closed-form
//     scatter onto the star, pallas_gat.py:459-504) follow the tile loop.
//     Writes Dcat = [dft | da1 | da2], [B*N, H*Dh + 2H], to a workspace.
//  2. dW: [x*m | pe*m_pe]^T @ Dcat over all B*N rows as a split-K product
//     (the mask bits recomputed as x is staged), partial sums per split in
//     a workspace, then a second pass adds the splits in a fixed order and
//     scatters the [din+pos, H*Dh+2H] result into dfc, dwa1, dwa2 and the
//     pe tail grads dwp, dwpa1, dwpa2. Deterministic: no atomics.
//  3. slot-bias grads: Dcat summed over egonets (chunked partial sums, then
//     the same fixed-order reduction) into dbias_ft, dbias_a1, dbias_a2.
//  4. dx: (Dcat @ [fc | wa1 | wa2; wp | wpa1 | wpa2]^T) * mask, skipped for
//     the x columns when need_dx = 0; the pe columns always, masked and
//     summed over egonets into dpe (pallas_gat.py:662-677).
// Invalid slots are not skipped: every pass computes the TPU kernel's
// formula on all N rows, so their grads are whatever the formula gives
// (zero in K4, where the pool grads never reach them).
//
// What bounds it on an H100: the products. At the config.mag.json shapes
// the recompute is the forward's x @ fc, the dW product is as large again
// and dx (K4) once more, all float32 SIMT FMAs (TF32 off for parity);
// bytes (x, Dcat once, dx) are a few GB, well under the operation time.
// The products are register-tiled (4 x 8 per thread, 64 x 128 per block,
// K tiles of 16 in shared memory) like the forward's; tensor cores, TMA and
// wgmma are later work.

#include "gat_common.cuh"

// Mirrored field by field by gat_kernels._BwdArgs.
struct BwdArgs {
  const float* x;        // [b, n, din]
  const float* fc;       // [din, heads*dh]
  const float* wa1;      // [din, heads]
  const float* wa2;
  const float* bias_ft;  // [n, heads*dh]
  const float* bias_a1;  // [n, heads]
  const float* bias_a2;
  const int* ngp;        // [b]
  const int* nsib;
  const float* g;        // K2 [b, n, heads*dh]; K4 [b, 3, dh]
  float* dcat;           // workspace [b*n, wd], wd = heads*dh + 2*heads
  float* part_w;         // workspace [splits, din+pos, wd]
  float* part_b;         // workspace [chunks, n, wd] (need_dbias)
  float* pe_rows;        // workspace [b*n, pos] (pos > 0)
  float* part_pe;        // workspace [chunks, n, pos] (pos > 0)
  float* dx;             // [b, n, din] (need_dx)
  float* dfc;            // [din, heads*dh]
  float* dwa1;           // [din, heads]
  float* dwa2;
  float* dbias_ft;       // [n, heads*dh] (need_dbias)
  float* dbias_a1;       // [n, heads]
  float* dbias_a2;
  float* dpe;            // [n, pos] (pos > 0)
  float* dwp;            // [pos, heads*dh]
  float* dwpa1;          // [pos, heads]
  float* dwpa2;
  int b, n, din, heads, dh, p;
  int pooled, need_dx, need_dbias, has_out_alpha, splits, chunks;
  float alpha, out_alpha;
};

namespace {

using namespace gat;


__device__ __forceinline__ float dleaky(float pre, float g, float a) {
  return pre >= 0.f ? g : a * g;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------- 1. head core
template <bool kPooled>
__global__ void __launch_bounds__(kThreads, 2)  // two blocks an SM
gat_bwd_head_kernel(BwdArgs a, TrainArgs ta) {
  extern __shared__ float4 smem4[];
  const int n = a.n, p = a.p, heads = a.heads, dh = a.dh, din = a.din;
  const Smem s = carve(reinterpret_cast<float*>(smem4), n, kBwdLayout);
  const long long b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int hd = heads * dh, wd = hd + 2 * heads;
  const int ngp = min(max(a.ngp[b], 0), p);
  const int nsib = min(max(a.nsib[b], 0), n - p - 1);
  const int ntiles = (dh + kTileCols - 1) / kTileCols;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float inv_h = 1.f / heads;
  float* drow = a.dcat + (size_t)b * n * wd;

  for (int r = tid; r < n; r += kThreads)
    s.d_self[r] = s.d_anchor[r] = s.d_to_anchor[r] = 0.f;
  setup_row_keys(ta, b, n, s);

  for (int t = 0; t < ntiles; ++t) {
    const int c0 = t * kTileCols;
    const int ncols = min(kTileCols, dh - c0);
    const int col0 = h * dh + c0;
    head_tile<true>(a.x + b * n * din, a.fc, a.wa1, a.wa2, a.bias_ft,
                    a.bias_a1, a.bias_a2, n, din, hd, heads, h, col0, ncols,
                    s, ta);
    if (t == 0) attention_weights<true, true>(n, p, ngp, a.alpha, s, ta, b, h);
    const float* fa = s.ft + p * kTileCols;

    // incoming grad tile
    for (int e = tid; e < n * kTileCols; e += kThreads) {
      const int r = e / kTileCols, c = e % kTileCols;
      float gv = 0.f;
      if (c < ncols) {
        if (kPooled) {
          const bool valid = r < p ? r < ngp : (r == p || r - p - 1 < nsib);
          const int cls = r < p ? 0 : (r == p ? 1 : 2);
          if (valid) gv = a.g[((size_t)b * 3 + cls) * dh + c0 + c] * inv_h;
        } else {
          gv = a.g[((size_t)b * n + r) * hd + col0 + c];
          if (a.has_out_alpha) {  // leaky'(pre) of the fused activation
            float pre;
            if (r < p) {
              pre = s.w_self[r] * s.ft[r * kTileCols + c];
            } else if (r > p) {
              pre = s.w_anchor[r] * fa[c] +
                    s.w_self[r] * s.ft[r * kTileCols + c];
            } else {
              float acc = 0.f;
              for (int j = 0; j < ngp; ++j)
                acc += s.w_to_anchor[j] * s.ft[j * kTileCols + c];
              pre = acc + s.w_self[p] * fa[c];
            }
            if (!(pre >= 0.f)) gv *= a.out_alpha;
          }
        }
      }
      s.g[r * kTileCols + c] = gv;
    }
    __syncthreads();

    // dft = the aggregation transposed
    const float* ga = s.g + p * kTileCols;
    for (int e = tid; e < n * kTileCols; e += kThreads) {
      const int r = e / kTileCols, c = e % kTileCols;
      if (c >= ncols) continue;
      float v;
      if (r < p) {
        v = s.w_self[r] * s.g[r * kTileCols + c] + s.w_to_anchor[r] * ga[c];
      } else if (r == p) {
        v = s.w_self[p] * ga[c];
        for (int i = p + 1; i < n; ++i)
          v += s.w_anchor[i] * s.g[i * kTileCols + c];
      } else {
        v = s.w_self[r] * s.g[r * kTileCols + c];
      }
      drow[(size_t)r * wd + col0 + c] = v;
    }

    // d(attention weight) partial sums over this tile's columns
    for (int r = warp; r < n; r += kThreads / 32) {
      float acc0 = 0.f, acc1 = 0.f;
      const float* ftr = s.ft + r * kTileCols;
      const float* gr = s.g + r * kTileCols;
      for (int c = lane; c < kTileCols; c += 32) {
        if (r <= p) {
          acc0 += ga[c] * ftr[c];   // gp -> anchor (r < p), anchor self
        } else {
          acc0 += gr[c] * fa[c];    // anchor -> sib
          acc1 += gr[c] * ftr[c];   // sib self
        }
      }
      acc0 = warp_sum(acc0);
      acc1 = warp_sum(acc1);
      if (lane == 0) {
        if (r < p) {
          s.d_to_anchor[r] += acc0;
        } else if (r == p) {
          s.d_self[p] += acc0;
        } else {
          s.d_anchor[r] += acc0;
          s.d_self[r] += acc1;
        }
      }
    }
    __syncthreads();  // the next tile overwrites s.ft and s.g
  }

  // d(attention) -> d(logits): through the masks, the softmax Jacobian
  // and leaky'(alpha); the gp self-loop weight is a constant (no grads)
  const float alpha = a.alpha;
  for (int r = tid; r < n; r += kThreads) {
    if (r > p) {
      const float d0 = s.d_anchor[r] * s.m_anchor[r];
      const float d1 = s.d_self[r] * s.m_self[r];
      const float inner = s.sm_anchor[r] * d0 + s.sm_self[r] * d1;
      const float dz0 =
          dleaky(s.a1[p] + s.a2[r], s.sm_anchor[r] * (d0 - inner), alpha);
      const float dz1 =
          dleaky(s.a1[r] + s.a2[r], s.sm_self[r] * (d1 - inner), alpha);
      s.dz[r] = dz0;
      s.da1[r] = dz1;
      s.da2[r] = dz0 + dz1;
    } else if (r < p) {
      s.d_to_anchor[r] = r < ngp ? s.d_to_anchor[r] * s.m_to_anchor[r] : 0.f;
    } else {
      s.d_self[p] *= s.m_self[p];
    }
  }
  __syncthreads();
  if (tid == 0) {
    float inner = 0.f;
    for (int j = 0; j < ngp; ++j) inner += s.sm_to_anchor[j] * s.d_to_anchor[j];
    inner += s.sm_self[p] * s.d_self[p];
    const float a2p = s.a2[p];
    const float dz_self =
        dleaky(s.a1[p] + a2p, s.sm_self[p] * (s.d_self[p] - inner), alpha);
    float sum_gp = 0.f;
    for (int j = 0; j < p; ++j) {
      const float dz =
          j < ngp ? dleaky(s.a1[j] + a2p,
                           s.sm_to_anchor[j] * (s.d_to_anchor[j] - inner),
                           alpha)
                  : 0.f;
      s.da1[j] = dz;
      s.da2[j] = 0.f;
      sum_gp += dz;
    }
    float sum_s0 = 0.f;
    for (int r = p + 1; r < n; ++r) sum_s0 += s.dz[r];
    s.da1[p] = dz_self + sum_s0;
    s.da2[p] = sum_gp + dz_self;
  }
  __syncthreads();
  for (int r = tid; r < n; r += kThreads) {
    drow[(size_t)r * wd + hd + h] = s.da1[r];
    drow[(size_t)r * wd + hd + heads + h] = s.da2[r];
  }
}

// Element (m, k) of [x*m | pe*m_pe] (k < din + pos).
__device__ __forceinline__ float xcat(const BwdArgs& a, const TrainArgs& ta,
                                      long long m, int k, unsigned rkf,
                                      unsigned rkp) {
  if (k < a.din) {
    float v = a.x[(size_t)m * a.din + k];
    if (ta.feat_on)
      v *= keep(drop_bits(rkf, (unsigned)k), ta.feat_thresh, ta.feat_scale);
    return v;
  }
  const int kp = k - a.din;
  float v = ta.pe[(size_t)(m % a.n) * ta.pos + kp];
  if (ta.feat_on)
    v *= keep(drop_bits(rkp, (unsigned)kp), ta.feat_thresh, ta.feat_scale);
  return v;
}

// Element (k, j) of [fc | wa1 | wa2; wp | wpa1 | wpa2], [din+pos, wd].
__device__ __forceinline__ float wcat(const BwdArgs& a, const TrainArgs& ta,
                                      int k, int j) {
  const int hd = a.heads * a.dh, heads = a.heads;
  const float *w, *w1, *w2;
  int kk = k;
  if (k < a.din) {
    w = a.fc, w1 = a.wa1, w2 = a.wa2;
  } else {
    w = ta.wp, w1 = ta.wpa1, w2 = ta.wpa2;
    kk = k - a.din;
  }
  if (j < hd) return w[(size_t)kk * hd + j];
  if (j < hd + heads) return w1[(size_t)kk * heads + j - hd];
  return w2[(size_t)kk * heads + j - hd - heads];
}

// ------------------------------------------- 2. dW, split-K partial sums
// part_w[split][k][j] = sum over rows m of the split of xcat(m, k) Dcat[m][j]
__global__ void __launch_bounds__(kThreads)
xt_d_splitk_kernel(BwdArgs a, TrainArgs ta, int kx, int wd,
                   long long m_total, long long chunk) {
  __shared__ __align__(16) float xs[kTileK][kXsStride];
  __shared__ __align__(16) float ds[kTileK][kTileCols];
  __shared__ unsigned rkf[kTileK], rkp[kTileK];
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
      xs[mm][kk] = (m < m_end && k < kx) ? xcat(a, ta, m, k, rkf[mm], rkp[mm])
                                         : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kTileK * kTileCols / kThreads; ++q) {
      const int e = t + q * kThreads;
      const int mm = e / kTileCols, jj = e % kTileCols;
      const long long m = m0 + mm;
      const int j = j0 + jj;
      ds[mm][jj] = (m < m_end && j < wd) ? a.dcat[(size_t)m * wd + j] : 0.f;
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
  float* out = a.part_w + (size_t)blockIdx.z * kx * wd;
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

// ------------------------------------------------ 4. dx and the pe rows
// out(m, k) = sum_j Dcat[m][j] wcat(k, j) for k in [kbeg, din + pos):
// k < din -> dx (times the feature mask), else pe_rows (times the pe mask)
__global__ void __launch_bounds__(kThreads)
d_wt_kernel(BwdArgs a, TrainArgs ta, int kbeg, int kx, int wd,
            long long m_total) {
  __shared__ __align__(16) float ds[kTileK][kXsStride];
  __shared__ __align__(16) float ws[kTileK][kTileCols];
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
      ds[jj][mm] = (m < m_total && j < wd) ? a.dcat[(size_t)m * wd + j] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kTileK * kTileCols / kThreads; ++q) {
      const int e = t + q * kThreads;
      const int kk = e / kTileK, jj = e % kTileK;
      const int k = k0 + kk, j = j0 + jj;
      ws[jj][kk] = (k < kx && j < wd) ? wcat(a, ta, k, j) : 0.f;
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
      if (k < a.din) {
        if (ta.feat_on)
          v *= keep(drop_bits(rkf, (unsigned)k), ta.feat_thresh,
                    ta.feat_scale);
        a.dx[(size_t)m * a.din + k] = v;
      } else {
        const int kpe = k - a.din;
        if (ta.feat_on)
          v *= keep(drop_bits(rkp, (unsigned)kpe), ta.feat_thresh,
                    ta.feat_scale);
        a.pe_rows[(size_t)m * ta.pos + kpe] = v;
      }
    }
  }
}

// ------------------------------------- 3. sums over egonets, in chunks
// part[c][i] = sum over egonets of chunk c of src[b][i], i < rw
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

unsigned blocks_for(long long count) {
  return (unsigned)((count + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

const char* gat_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The backward of one star-GAT layer (K2, or K4 with a->pooled): all
// passes launched in order on `stream`. Outputs and workspaces are
// allocated by the caller (ops/gat_kernels.py). Returns the first CUDA
// error of a launch, or 0.
int gat_layer_bwd_f32(const BwdArgs* ap, const TrainArgs* tap, void* stream) {
  const BwdArgs a = *ap;
  const TrainArgs ta = *tap;
  cudaStream_t st = (cudaStream_t)stream;
  const long long m = (long long)a.b * a.n;
  if (m == 0) return cudaSuccess;
  const int hd = a.heads * a.dh, wd = hd + 2 * a.heads;
  const int kx = a.din + ta.pos;

  const size_t smem = smem_bytes(a.n, kBwdLayout);
  const void* head = a.pooled ? (const void*)gat_bwd_head_kernel<true>
                              : (const void*)gat_bwd_head_kernel<false>;
  cudaError_t err = prepare(head, smem);
  if (err != cudaSuccess) return err;
  const long long head_blocks = (long long)a.b * a.heads;
  if (head_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (a.pooled)
    gat_bwd_head_kernel<true><<<(unsigned)head_blocks, kThreads, smem, st>>>(
        a, ta);
  else
    gat_bwd_head_kernel<false><<<(unsigned)head_blocks, kThreads, smem, st>>>(
        a, ta);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long chunk = (m + a.splits - 1) / a.splits;
  const dim3 wgrid((wd + kTileCols - 1) / kTileCols,
                   (kx + kRowsPerChunk - 1) / kRowsPerChunk, a.splits);
  xt_d_splitk_kernel<<<wgrid, kThreads, 0, st>>>(a, ta, kx, wd, m, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  reduce_scatter_kernel<<<blocks_for((long long)kx * wd), kThreads, 0, st>>>(
      a.part_w, a.splits, kx, wd, a.din, hd, hd + a.heads, a.dfc, a.dwa1,
      a.dwa2, a.dwp, a.dwpa1, a.dwpa2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long chunk_b = (a.b + a.chunks - 1) / a.chunks;
  if (a.need_dbias) {
    const long long rw = (long long)a.n * wd;
    colsum_partial_kernel<<<dim3(blocks_for(rw), a.chunks), kThreads, 0,
                            st>>>(a.dcat, a.b, rw, chunk_b, a.part_b);
    reduce_scatter_kernel<<<blocks_for(rw), kThreads, 0, st>>>(
        a.part_b, a.chunks, a.n, wd, a.n, hd, hd + a.heads, a.dbias_ft,
        a.dbias_a1, a.dbias_a2, nullptr, nullptr, nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }

  const int kbeg = a.need_dx ? 0 : a.din;
  if (kx > kbeg) {
    const long long mtiles = (m + kRowsPerChunk - 1) / kRowsPerChunk;
    if (mtiles > 65535) return cudaErrorInvalidValue;
    const dim3 xgrid((kx - kbeg + kTileCols - 1) / kTileCols,
                     (unsigned)mtiles);
    d_wt_kernel<<<xgrid, kThreads, 0, st>>>(a, ta, kbeg, kx, wd, m);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (ta.pos > 0) {
    const long long rw = (long long)a.n * ta.pos;
    colsum_partial_kernel<<<dim3(blocks_for(rw), a.chunks), kThreads, 0,
                            st>>>(a.pe_rows, a.b, rw, chunk_b, a.part_pe);
    reduce_scatter_kernel<<<blocks_for(rw), kThreads, 0, st>>>(
        a.part_pe, a.chunks, a.n, ta.pos, a.n, ta.pos, ta.pos, a.dpe,
        nullptr, nullptr, nullptr, nullptr, nullptr);
  }
  return cudaGetLastError();
}

}  // extern "C"
