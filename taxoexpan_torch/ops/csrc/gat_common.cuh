// Building blocks shared by the star-GAT kernels (gat_fwd.cu, gat_bwd.cu):
// the dropout bit generator, the shared-memory layout, the register-tiled
// ft / a1 / a2 product of one head tile and the star softmax weights.
//
// Eval instantiations (kTrain = false) are the serving kernels' code; the
// train instantiations add, in the same loops:
//   - the input-feature mask on x as the x tile is staged in the K loop;
//   - the position-embedding path [x*m | pe*m_pe] @ [W_h; W_p] as `pos`
//     extra K columns of the same product (the source pointer switches at
//     din, W_p / wpa1 / wpa2 are the tail rows), which is the reference's
//     dropout over the concatenated layer input (pallas_gat.py:847-853);
//   - the five attention masks, multiplied into the softmax weights after
//     the softmax (pallas_gat.py:150-159).
// Every mask compares either the element's 32-bit word or, with
// TrainArgs::bits8 (TAXOEXPAN_DROPOUT_BITS=8), byte col % 4 of the word of
// column col / 4 with its threshold (drop_value; ops/dropout.py).
//
// Stored attention (TAXOEXPAN_STORED_ATTN=1, pallas_gat.py:191-263): the
// train forwards can write each (egonet, head)'s softmax weights before
// dropout to a row of attn_row(n, p) = 2n - p - 1 floats, [b, heads, row],
// and the backward reads them instead of recomputing the softmax
// (attention_weights' kLoad):
//   [j] gp j -> anchor (j < p; 0 for j >= ngp), [p] anchor self,
//   [r] anchor -> sib r, [r + n - p - 1] sib r self (p < r < n).
// The TPU kernel's 128-lane segment padding was a Mosaic constraint and has
// no counterpart here.
#pragma once

#include <cuda_runtime.h>

namespace gat {

constexpr int kThreads = 256;
constexpr int kRowsPerChunk = 64;            // 16 row groups x 4 rows
constexpr int kTileCols = 128;               // 16 col groups x (4 + 4)
constexpr int kTileK = 16;
constexpr int kXsStride = kRowsPerChunk + 4;  // padded: fewer bank conflicts
constexpr int kStaticFloats =
    kTileK * kXsStride + kTileK * kTileCols + 2 * kTileK;

// dropout streams (ops/dropout.py)
constexpr unsigned kStreamFeat = 0;
constexpr unsigned kStreamPe = 1;
constexpr unsigned kAttnKinds = 5;  // gp->anchor, anchor self, anchor->sib,
                                    // sib self, gp self

// Train-form arguments; mirrored field by field by gat_kernels._TrainArgs.
struct TrainArgs {
  const float* pe;    // [n, pos] slot position embeddings, or null
  const float* wp;    // [pos, heads*dh] tail rows of fc
  const float* wpa1;  // [pos, heads]
  const float* wpa2;  // [pos, heads]
  int pos;            // 0 without the pe path
  unsigned seed;
  unsigned feat_thresh;
  float feat_scale;
  int feat_on;
  unsigned attn_thresh;
  float attn_scale;
  int attn_on;
  int bits8;          // 8-bit thresholds (feat_thresh, attn_thresh are t8)
};

__host__ __device__ __forceinline__ unsigned fmix32(unsigned h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__host__ __device__ __forceinline__ unsigned stream_key(unsigned seed,
                                                        unsigned stream) {
  return fmix32(fmix32(seed) + (stream + 1u) * 0x9E3779B9u);
}

__host__ __device__ __forceinline__ unsigned row_key(unsigned skey,
                                                     unsigned row) {
  return fmix32(skey ^ (row * 0x27D4EB2Fu));
}

__host__ __device__ __forceinline__ unsigned drop_bits(unsigned rkey,
                                                       unsigned col) {
  return fmix32(rkey + (col + 1u) * 0x165667B1u);
}

// The value an element compares with its keep threshold: its 32-bit word,
// or with bits8 byte col % 4 of the word of column col / 4.
__host__ __device__ __forceinline__ unsigned drop_value(unsigned rkey,
                                                        unsigned col,
                                                        int bits8) {
  return bits8 ? (drop_bits(rkey, col >> 2) >> ((col & 3u) << 3)) & 0xFFu
               : drop_bits(rkey, col);
}

__device__ __forceinline__ float keep_at(const TrainArgs& ta, unsigned rkey,
                                         unsigned col, unsigned thresh,
                                         float scale) {
  return drop_value(rkey, col, ta.bits8) < thresh ? scale : 0.f;
}

__device__ __forceinline__ float attn_mask(const TrainArgs& ta, int h,
                                           unsigned kind, long long b,
                                           int j) {
  const unsigned sk = stream_key(ta.seed, 2u + kAttnKinds * h + kind);
  return keep_at(ta, row_key(sk, (unsigned)b), (unsigned)j, ta.attn_thresh,
                 ta.attn_scale);
}

__device__ __forceinline__ float leaky(float v, float a) {
  return v >= 0.f ? v : a * v;
}

enum Layout { kEvalLayout = 0, kTrainLayout = 1, kBwdLayout = 2 };

struct Smem {
  float* xs;           // [kTileK][kXsStride]  x tile, k-major
  float* ws;           // [kTileK][kTileCols]  fc tile
  float* was;          // [2][kTileK]          wa1 / wa2 tile of the head
  float* ft;           // [n][kTileCols]       ft tile incl. slot bias
  float* g;            // [n][kTileCols]       incoming grad tile (backward)
  float* a1;           // [n]
  float* a2;           // [n]
  float* w_self;       // [n] weight of a row's own ft (after dropout)
  float* w_anchor;     // [n] weight of the anchor's ft (sibling rows)
  float* w_to_anchor;  // [n] weight of gp row j in the anchor's output
  unsigned* rk_feat;   // [n] row keys of the feature / pe masks (train)
  unsigned* rk_pe;     // [n]
  // backward: softmax weights before dropout, the masks, d(weights)
  float* sm_self;
  float* sm_anchor;
  float* sm_to_anchor;
  float* m_self;
  float* m_anchor;
  float* m_to_anchor;
  float* d_self;
  float* d_anchor;
  float* d_to_anchor;
  float* dz;           // [n] dz of the anchor -> sib edge, per sib row
  float* da1;
  float* da2;
};

__host__ __device__ inline size_t smem_floats(int n, Layout layout) {
  size_t f = (size_t)kStaticFloats + (size_t)n * kTileCols + 5 * (size_t)n;
  if (layout >= kTrainLayout) f += 2 * (size_t)n;
  if (layout == kBwdLayout) f += (size_t)n * kTileCols + 12 * (size_t)n;
  return f;
}

inline size_t smem_bytes(int n, Layout layout) {
  return sizeof(float) * smem_floats(n, layout);
}

__device__ __forceinline__ Smem carve(float* base, int n, Layout layout) {
  Smem s = {};
  s.xs = base;
  s.ws = s.xs + kTileK * kXsStride;
  s.was = s.ws + kTileK * kTileCols;
  s.ft = s.was + 2 * kTileK;
  float* next = s.ft + (size_t)n * kTileCols;
  if (layout == kBwdLayout) {
    s.g = next;
    next += (size_t)n * kTileCols;
  }
  s.a1 = next;
  s.a2 = s.a1 + n;
  s.w_self = s.a2 + n;
  s.w_anchor = s.w_self + n;
  s.w_to_anchor = s.w_anchor + n;
  next = s.w_to_anchor + n;
  if (layout >= kTrainLayout) {
    s.rk_feat = reinterpret_cast<unsigned*>(next);
    s.rk_pe = s.rk_feat + n;
    next += 2 * n;
  }
  if (layout == kBwdLayout) {
    float** arrays[] = {&s.sm_self, &s.sm_anchor, &s.sm_to_anchor,
                        &s.m_self,  &s.m_anchor,  &s.m_to_anchor,
                        &s.d_self,  &s.d_anchor,  &s.d_to_anchor,
                        &s.dz,      &s.da1,       &s.da2};
    for (float** a : arrays) {
      *a = next;
      next += n;
    }
  }
  return s;
}

// Row keys of the feature and pe masks for the rows of egonet b.
__device__ __forceinline__ void setup_row_keys(const TrainArgs& ta,
                                               long long b, int n,
                                               const Smem& s) {
  const unsigned kf = stream_key(ta.seed, kStreamFeat);
  const unsigned kp = stream_key(ta.seed, kStreamPe);
  for (int r = threadIdx.x; r < n; r += kThreads) {
    const unsigned row = (unsigned)(b * n + r);
    s.rk_feat[r] = row_key(kf, row);
    s.rk_pe[r] = row_key(kp, row);
  }
  __syncthreads();
}

// ft tile and a1/a2 of head h for every row of egonet xb ([n, din]):
// s.ft[r][c] = x[r] . fc[:, col0 + c] + bias_ft[r, col0 + c] (0 for c >= ncols)
// s.a1[r]    = x[r] . wa1[:, h] + bias_a1[r, h]; s.a2 likewise.
// Train form: x masked as staged, and the pe rows as `pos` extra K columns.
// kAttn = false (the GCN layer): the ft tile alone; wa1, wa2, bias_a1,
// bias_a2, ta.wpa1 and ta.wpa2 are not read and s.a1 / s.a2 not written.
template <bool kTrain, bool kAttn = true>
__device__ void head_tile(const float* __restrict__ xb,
                          const float* __restrict__ fc,
                          const float* __restrict__ wa1,
                          const float* __restrict__ wa2,
                          const float* __restrict__ bias_ft,
                          const float* __restrict__ bias_a1,
                          const float* __restrict__ bias_a2, int n, int din,
                          int hd, int heads, int h, int col0, int ncols,
                          const Smem& s, const TrainArgs& ta) {
  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4;
  const int kdim = kTrain ? din + ta.pos : din;
  for (int row0 = 0; row0 < n; row0 += kRowsPerChunk) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    float a_acc = 0.f;  // threads t < 128: row t/2, a1 (even) or a2 (odd)
    for (int k0 = 0; k0 < kdim; k0 += kTileK) {
#pragma unroll
      for (int q = 0; q < kRowsPerChunk * kTileK / kThreads; ++q) {
        const int e = t + q * kThreads;
        const int r = e / kTileK, kk = e % kTileK;
        const int gr = row0 + r, gk = k0 + kk;
        if (!kTrain) {
          s.xs[kk * kXsStride + r] =
              (gr < n && gk < din) ? xb[(size_t)gr * din + gk] : 0.f;
        } else {
          float v = 0.f;
          if (gr < n && gk < din) {
            v = xb[(size_t)gr * din + gk];
            if (ta.feat_on)
              v *= keep_at(ta, s.rk_feat[gr], (unsigned)gk, ta.feat_thresh,
                           ta.feat_scale);
          } else if (gr < n && gk < kdim) {
            const int kp = gk - din;
            v = ta.pe[(size_t)gr * ta.pos + kp];
            if (ta.feat_on)
              v *= keep_at(ta, s.rk_pe[gr], (unsigned)kp, ta.feat_thresh,
                           ta.feat_scale);
          }
          s.xs[kk * kXsStride + r] = v;
        }
      }
#pragma unroll
      for (int q = 0; q < kTileK * kTileCols / kThreads; ++q) {
        const int e = t + q * kThreads;
        const int kk = e / kTileCols, c = e % kTileCols;
        const int gk = k0 + kk;
        float w = 0.f;
        if (c < ncols) {
          if (gk < din)
            w = fc[(size_t)gk * hd + col0 + c];
          else if (kTrain && gk < kdim)
            w = ta.wp[(size_t)(gk - din) * hd + col0 + c];
        }
        s.ws[kk * kTileCols + c] = w;
      }
      if (kAttn && t < 2 * kTileK) {
        const int gk = k0 + (t % kTileK);
        float w = 0.f;
        if (gk < din)
          w = ((t < kTileK) ? wa1 : wa2)[(size_t)gk * heads + h];
        else if (kTrain && gk < kdim)
          w = ((t < kTileK) ? ta.wpa1 : ta.wpa2)[(size_t)(gk - din) * heads +
                                                 h];
        s.was[t] = w;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTileK; ++kk) {
        const float4 xv =
            *reinterpret_cast<const float4*>(&s.xs[kk * kXsStride + ty * 4]);
        const float4 w0 =
            *reinterpret_cast<const float4*>(&s.ws[kk * kTileCols + tx * 4]);
        const float4 w1 = *reinterpret_cast<const float4*>(
            &s.ws[kk * kTileCols + 64 + tx * 4]);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
        const float wc[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xr[i], wc[j], acc[i][j]);
      }
      if (kAttn && t < 2 * kRowsPerChunk) {
        const int r = t >> 1;
        const float* wa = s.was + (t & 1) * kTileK;
#pragma unroll
        for (int kk = 0; kk < kTileK; ++kk)
          a_acc = fmaf(s.xs[kk * kXsStride + r], wa[kk], a_acc);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty * 4 + i;
      if (r >= n) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = (j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4);
        s.ft[r * kTileCols + c] =
            c < ncols ? acc[i][j] + bias_ft[(size_t)r * hd + col0 + c] : 0.f;
      }
    }
    if (kAttn && t < 2 * kRowsPerChunk) {
      const int r = row0 + (t >> 1);
      if (r < n) {
        if (t & 1)
          s.a2[r] = a_acc + bias_a2[(size_t)r * heads + h];
        else
          s.a1[r] = a_acc + bias_a1[(size_t)r * heads + h];
      }
    }
  }
  __syncthreads();
}

// Floats of one (egonet, head)'s stored softmax row.
__host__ __device__ __forceinline__ int attn_row(int n, int p) {
  return 2 * n - p - 1;
}

// Star softmax weights of head h from s.a1 / s.a2:
//   gp rows    <- self only (weight 1; train: times the gp-self mask)
//   anchor     <- valid grandparents (j < ngp) and self
//   sib rows   <- anchor and self
// Train form: each weight times its attention mask after the softmax.
// kBwd also keeps the softmax weights before dropout and the masks.
// `stored` is egonet b's row of head h (layout at the top of this file), or
// null: kLoad takes the weights from it and leaves s.a1 / s.a2 unread;
// otherwise they are computed and, when it is not null, also written there.
template <bool kTrain, bool kBwd, bool kLoad = false>
__device__ void attention_weights(int n, int p, int ngp, float alpha,
                                  const Smem& s, const TrainArgs& ta,
                                  long long b, int h,
                                  float* stored = nullptr) {
  const bool drop = kTrain && ta.attn_on;
  const int nsl = n - p - 1;  // sibling slots
  for (int r = threadIdx.x; r < n; r += kThreads) {
    if (r < p) {
      const float m = drop ? attn_mask(ta, h, 4, b, r) : 1.f;
      s.w_self[r] = m;
      s.w_anchor[r] = 0.f;
      if (kBwd) {
        s.sm_self[r] = 1.f;
        s.m_self[r] = m;
        s.sm_anchor[r] = s.m_anchor[r] = 0.f;
      }
    } else if (r > p) {
      float sa, ss;
      if (kLoad) {
        sa = stored[r];
        ss = stored[r + nsl];
      } else {
        const float l0 = leaky(s.a1[p] + s.a2[r], alpha);
        const float l1 = leaky(s.a1[r] + s.a2[r], alpha);
        const float m = fmaxf(l0, l1);
        const float e0 = expf(l0 - m), e1 = expf(l1 - m);
        const float den = e0 + e1;
        sa = e0 / den;
        ss = e1 / den;
        if (stored != nullptr) {
          stored[r] = sa;
          stored[r + nsl] = ss;
        }
      }
      if (drop) {
        const float ma = attn_mask(ta, h, 2, b, r - p - 1);
        const float ms = attn_mask(ta, h, 3, b, r - p - 1);
        s.w_anchor[r] = sa * ma;
        s.w_self[r] = ss * ms;
        if (kBwd) {
          s.m_anchor[r] = ma;
          s.m_self[r] = ms;
        }
      } else {
        s.w_anchor[r] = sa;
        s.w_self[r] = ss;
        if (kBwd) s.m_anchor[r] = s.m_self[r] = 1.f;
      }
      if (kBwd) {
        s.sm_anchor[r] = sa;
        s.sm_self[r] = ss;
      }
    } else {
      float m = 0.f, den = 1.f, sself;
      const float a2p = kLoad ? 0.f : s.a2[p];
      if (kLoad) {
        sself = stored[p];
      } else {
        const float lself = leaky(s.a1[p] + a2p, alpha);
        m = lself;
        for (int j = 0; j < ngp; ++j)
          m = fmaxf(m, leaky(s.a1[j] + a2p, alpha));
        den = 0.f;
        for (int j = 0; j < ngp; ++j)
          den += expf(leaky(s.a1[j] + a2p, alpha) - m);
        const float eself = expf(lself - m);
        den += eself;
        sself = eself / den;
      }
      for (int j = 0; j < p; ++j) {
        float sm;
        if (kLoad) {
          sm = stored[j];
        } else {
          sm = j < ngp ? expf(leaky(s.a1[j] + a2p, alpha) - m) / den : 0.f;
          if (stored != nullptr) stored[j] = sm;
        }
        const float mj = drop ? attn_mask(ta, h, 0, b, j) : 1.f;
        s.w_to_anchor[j] = drop ? sm * mj : sm;
        if (kBwd) {
          s.sm_to_anchor[j] = sm;
          s.m_to_anchor[j] = mj;
        }
      }
      if (stored != nullptr) stored[p] = sself;
      const float ms = drop ? attn_mask(ta, h, 1, b, 0) : 1.f;
      s.w_self[p] = drop ? sself * ms : sself;
      s.w_anchor[p] = 0.f;
      if (kBwd) {
        s.sm_self[p] = sself;
        s.m_self[p] = ms;
        s.sm_anchor[p] = s.m_anchor[p] = 0.f;
      }
    }
  }
  __syncthreads();
}

inline cudaError_t prepare(const void* kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

}  // namespace gat
