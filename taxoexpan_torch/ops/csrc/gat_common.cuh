// Building blocks shared by the star kernels (gat_fwd.cu, gat_bwd.cu,
// gcn.cu): the dropout bit generator, the train-form arguments, the star
// softmax weights, the shared-memory arrays of the GAT star passes and
// head core, and the element conversions of the bf16 forms. Every layer
// product is a tensor-core product on gemm_wgmma.cuh's ring: 3xTF32 for
// float32 layers, bf16 for bf16 layers (dispatched by gemm_tf32.cuh).
//
// The train forms' dropout: the feature and pe masks over the layer input
// X = [x*m | pe*m_pe], the reference's dropout over the concatenated input
// (pallas_gat.py:847-853), applied where X is staged
// (gemm_tf32.cuh:stage_input_kernel) and replayed in the dx product's
// epilogue; the five attention masks, multiplied into the softmax weights
// after the softmax (pallas_gat.py:150-159, attention_weights).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gat {

using bf16 = __nv_bfloat16;

// An element of a layer's compute dtype (float or bf16) to float and back
// (round to nearest even); the identity for float.
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

template <class E>
__device__ __forceinline__ E from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int kThreads = 256;
constexpr int kTileCols = 128;  // columns of the head core's tiles

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

// Shared-memory arrays of one (egonet, head) in the GAT star passes
// (gat_fwd.cu) and the head core (gat_bwd.cu:carve_head); each kernel sets
// the ones it uses.
struct Smem {
  float* ft;           // [n][kTileCols]       ft tile incl. slot bias
  float* g;            // [n][kTileCols]       incoming grad tile (backward,
                       //                      gat_bwd.cu:carve_head)
  float* a1;           // [n]
  float* a2;           // [n]
  float* w_self;       // [n] weight of a row's own ft (after dropout)
  float* w_anchor;     // [n] weight of the anchor's ft (sibling rows)
  float* w_to_anchor;  // [n] weight of gp row j in the anchor's output
  // backward (gat_bwd.cu:carve_head): softmax weights before dropout, the
  // masks, d(weights)
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

// Floats of one (egonet, head)'s stored softmax row.
__host__ __device__ __forceinline__ int attn_row(int n, int p) {
  return 2 * n - p - 1;
}

// Star softmax weights of head h from s.a1 / s.a2, the part of slot r:
//   gp rows    <- self only (weight 1; train: times the gp-self mask)
//   anchor     <- valid grandparents (j < ngp) and self
//   sib rows   <- anchor and self
// Train form: each weight times its attention mask after the softmax (with
// ta.attn_on; a zeroed TrainArgs gives the eval form's weights).
// kBwd also keeps the softmax weights before dropout and the masks.
// `stored` is egonet b's row of head h (layout at the top of this file), or
// null: kLoad takes the weights from it and leaves s.a1 / s.a2 unread;
// otherwise they are computed and, when it is not null, also written there.
// The anchor's slot r = p writes w_to_anchor[j] of every gp j.
template <bool kTrain, bool kBwd, bool kLoad = false>
__device__ __forceinline__ void star_weights_row(int r, int n, int p,
                                                 int ngp, float alpha,
                                                 const Smem& s,
                                                 const TrainArgs& ta,
                                                 long long b, int h,
                                                 float* stored) {
  const bool drop = kTrain && ta.attn_on;
  const int nsl = n - p - 1;  // sibling slots
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

// The star softmax weights of one (egonet, head) over the block's threads
// (star_weights_row for each slot), then a __syncthreads().
template <bool kTrain, bool kBwd, bool kLoad = false>
__device__ void attention_weights(int n, int p, int ngp, float alpha,
                                  const Smem& s, const TrainArgs& ta,
                                  long long b, int h,
                                  float* stored = nullptr) {
  for (int r = threadIdx.x; r < n; r += kThreads)
    star_weights_row<kTrain, kBwd, kLoad>(r, n, p, ngp, alpha, s, ta, b, h,
                                          stored);
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
