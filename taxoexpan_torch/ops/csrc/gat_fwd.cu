// Star-GAT layer forward kernels for Hopper (sm_90a), float32, eval form.
//
// Replace the forward Pallas kernels of taxoexpan_tpu/ops/pallas_gat.py:
//   gat_layer_fwd        <- fused_gat_layer        (_fused_fwd, _fwd_kernel)
//   gat_layer_pooled_fwd <- fused_gat_layer_pooled (_fused_pooled_fwd,
//                                                  _fwd_pool_kernel)
// with dropout off (serving). Per egonet b, head h:
//   ft  = x[b] @ fc[:, h*Dh:(h+1)*Dh] + bias_ft[:, h*Dh:(h+1)*Dh]   [N, Dh]
//   a1  = x[b] @ wa1[:, h] + bias_a1[:, h]; a2 likewise             [N]
//   star softmax of leaky(a1[src] + a2[dst], alpha) per destination:
//     gp rows    <- self only (weight 1)
//     anchor     <- valid grandparents (j < ngp) and self
//     sib rows   <- anchor and self
//   out = attention-weighted sum of source ft rows
//   gat_layer_fwd:        optional leaky(out, out_alpha); writes [B, N, H*Dh]
//   gat_layer_pooled_fwd: head mean, then per class (valid gp sum, anchor,
//                         valid sib sum); writes [B, 3, Dh] only.
//
// What bounds it on an H100: the x @ fc product. At the serving shapes
// (config.mag.json, N = 64) layer 0 does 2*B*64*250*2008 flop and writes
// B*64*2000 floats; the final layer does 2*B*64*2000*502 flop and writes
// only the pools. Both sit above the float32 ridge point, so the bound is
// the float32 FMA rate (the tensor cores' TF32 would break f32 parity).
//
// Design (simple first): one block of 256 threads per (egonet, head, 128-
// column tile of the head) for the per-slot kernel and per (egonet, column
// tile) for the pooled one, which loops over heads so that the head mean
// and class sums stay in registers. Each block runs a register-tiled SIMT
// product (4 rows x 8 columns per thread, K tiles of 16 staged in shared
// memory), folds a1/a2 of its head into the same K loop, keeps the ft tile
// [N, 128] in shared memory, computes the star softmax there and writes
// the aggregated tile (or the pools) directly: ft never reaches device
// memory. The blocks of one egonet are adjacent in the grid, so the
// repeated reads of x[b] are served from L2. N is taken as given (no slot
// padding); rows beyond N and columns beyond Dh are masked.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerChunk = 64;            // 16 row groups x 4 rows
constexpr int kTileCols = 128;               // 16 col groups x (4 + 4)
constexpr int kTileK = 16;
constexpr int kXsStride = kRowsPerChunk + 4;  // padded: fewer bank conflicts
constexpr int kStaticFloats =
    kTileK * kXsStride + kTileK * kTileCols + 2 * kTileK;

__device__ __forceinline__ float leaky(float v, float a) {
  return v >= 0.f ? v : a * v;
}

struct Smem {
  float* xs;           // [kTileK][kXsStride]  x tile, k-major
  float* ws;           // [kTileK][kTileCols]  fc tile
  float* was;          // [2][kTileK]          wa1 / wa2 tile of the head
  float* ft;           // [n][kTileCols]       ft tile incl. slot bias
  float* a1;           // [n]
  float* a2;           // [n]
  float* w_self;       // [n] weight of a row's own ft
  float* w_anchor;     // [n] weight of the anchor's ft (sibling rows)
  float* w_to_anchor;  // [n] weight of gp row j in the anchor's output
};

__device__ __forceinline__ Smem carve(float* base, int n) {
  Smem s;
  s.xs = base;
  s.ws = s.xs + kTileK * kXsStride;
  s.was = s.ws + kTileK * kTileCols;
  s.ft = s.was + 2 * kTileK;
  s.a1 = s.ft + (size_t)n * kTileCols;
  s.a2 = s.a1 + n;
  s.w_self = s.a2 + n;
  s.w_anchor = s.w_self + n;
  s.w_to_anchor = s.w_anchor + n;
  return s;
}

// ft tile and a1/a2 of head h for every row of egonet xb ([n, din]):
// s.ft[r][c] = x[r] . fc[:, col0 + c] + bias_ft[r, col0 + c] (0 for c >= ncols)
// s.a1[r]    = x[r] . wa1[:, h] + bias_a1[r, h]; s.a2 likewise.
__device__ void head_tile(const float* __restrict__ xb,
                          const float* __restrict__ fc,
                          const float* __restrict__ wa1,
                          const float* __restrict__ wa2,
                          const float* __restrict__ bias_ft,
                          const float* __restrict__ bias_a1,
                          const float* __restrict__ bias_a2, int n, int din,
                          int hd, int heads, int h, int col0, int ncols,
                          const Smem& s) {
  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4;
  for (int row0 = 0; row0 < n; row0 += kRowsPerChunk) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    float a_acc = 0.f;  // threads t < 128: row t/2, a1 (even) or a2 (odd)
    for (int k0 = 0; k0 < din; k0 += kTileK) {
#pragma unroll
      for (int q = 0; q < kRowsPerChunk * kTileK / kThreads; ++q) {
        const int e = t + q * kThreads;
        const int r = e / kTileK, kk = e % kTileK;
        const int gr = row0 + r, gk = k0 + kk;
        s.xs[kk * kXsStride + r] =
            (gr < n && gk < din) ? xb[(size_t)gr * din + gk] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kTileK * kTileCols / kThreads; ++q) {
        const int e = t + q * kThreads;
        const int kk = e / kTileCols, c = e % kTileCols;
        const int gk = k0 + kk;
        s.ws[kk * kTileCols + c] =
            (gk < din && c < ncols) ? fc[(size_t)gk * hd + col0 + c] : 0.f;
      }
      if (t < 2 * kTileK) {
        const int gk = k0 + (t % kTileK);
        const float* wa = (t < kTileK) ? wa1 : wa2;
        s.was[t] = gk < din ? wa[(size_t)gk * heads + h] : 0.f;
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
      if (t < 2 * kRowsPerChunk) {
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
    if (t < 2 * kRowsPerChunk) {
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

// Star softmax weights of one head from s.a1 / s.a2 (see file header).
__device__ void attention_weights(int n, int p, int ngp, float alpha,
                                  const Smem& s) {
  for (int r = threadIdx.x; r < n; r += kThreads) {
    if (r < p) {
      s.w_self[r] = 1.f;
      s.w_anchor[r] = 0.f;
    } else if (r > p) {
      const float l0 = leaky(s.a1[p] + s.a2[r], alpha);
      const float l1 = leaky(s.a1[r] + s.a2[r], alpha);
      const float m = fmaxf(l0, l1);
      const float e0 = expf(l0 - m), e1 = expf(l1 - m);
      const float den = e0 + e1;
      s.w_anchor[r] = e0 / den;
      s.w_self[r] = e1 / den;
    } else {
      const float a2p = s.a2[p];
      const float lself = leaky(s.a1[p] + a2p, alpha);
      float m = lself;
      for (int j = 0; j < ngp; ++j)
        m = fmaxf(m, leaky(s.a1[j] + a2p, alpha));
      float den = 0.f;
      for (int j = 0; j < ngp; ++j)
        den += expf(leaky(s.a1[j] + a2p, alpha) - m);
      const float eself = expf(lself - m);
      den += eself;
      for (int j = 0; j < p; ++j)
        s.w_to_anchor[j] =
            j < ngp ? expf(leaky(s.a1[j] + a2p, alpha) - m) / den : 0.f;
      s.w_self[p] = eself / den;
      s.w_anchor[p] = 0.f;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
gat_layer_fwd_kernel(const float* __restrict__ x, const float* __restrict__ fc,
                     const float* __restrict__ wa1,
                     const float* __restrict__ wa2,
                     const float* __restrict__ bias_ft,
                     const float* __restrict__ bias_a1,
                     const float* __restrict__ bias_a2,
                     const int* __restrict__ ngp_arr,
                     const int* __restrict__ nsib_arr, float* __restrict__ out,
                     int n, int din, int heads, int dh, int p, float alpha,
                     float out_alpha, int has_out_alpha, int ntiles) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), n);
  const int per_ego = heads * ntiles;
  const long long b = blockIdx.x / per_ego;
  const int rem = blockIdx.x % per_ego;
  const int h = rem / ntiles;
  const int c0 = (rem % ntiles) * kTileCols;
  const int ncols = min(kTileCols, dh - c0);
  const int hd = heads * dh;
  const int col0 = h * dh + c0;
  const int ngp = min(max(ngp_arr[b], 0), p);
  (void)nsib_arr;  // invalid sibling slots keep their formula value, as in
                   // the TPU kernel (callers mask them downstream)

  head_tile(x + b * n * din, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, n, din,
            hd, heads, h, col0, ncols, s);
  attention_weights(n, p, ngp, alpha, s);

  float* outb = out + b * n * hd;
  const float* fa = s.ft + p * kTileCols;
  for (int e = threadIdx.x; e < n * kTileCols; e += kThreads) {
    const int r = e / kTileCols, c = e % kTileCols;
    if (c >= ncols) continue;
    float v;
    if (r < p) {
      v = s.ft[r * kTileCols + c];
    } else if (r > p) {
      v = s.w_anchor[r] * fa[c] + s.w_self[r] * s.ft[r * kTileCols + c];
    } else {
      float acc = 0.f;
      for (int j = 0; j < ngp; ++j)
        acc += s.w_to_anchor[j] * s.ft[j * kTileCols + c];
      v = acc + s.w_self[p] * fa[c];
    }
    if (has_out_alpha) v = leaky(v, out_alpha);
    outb[(size_t)r * hd + col0 + c] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
gat_layer_pooled_fwd_kernel(const float* __restrict__ x,
                            const float* __restrict__ fc,
                            const float* __restrict__ wa1,
                            const float* __restrict__ wa2,
                            const float* __restrict__ bias_ft,
                            const float* __restrict__ bias_a1,
                            const float* __restrict__ bias_a2,
                            const int* __restrict__ ngp_arr,
                            const int* __restrict__ nsib_arr,
                            float* __restrict__ pools, int n, int din,
                            int heads, int dh, int p, float alpha,
                            int ntiles) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), n);
  const long long b = blockIdx.x / ntiles;
  const int c0 = (blockIdx.x % ntiles) * kTileCols;
  const int ncols = min(kTileCols, dh - c0);
  const int hd = heads * dh;
  const int ngp = min(max(ngp_arr[b], 0), p);
  const int nsib = min(max(nsib_arr[b], 0), n - p - 1);
  const int c = threadIdx.x;  // threads c < ncols own one pool column
  const float* fa = s.ft + p * kTileCols;
  float pool_gp = 0.f, pool_anchor = 0.f, pool_sib = 0.f;

  for (int h = 0; h < heads; ++h) {
    head_tile(x + b * n * din, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, n,
              din, hd, heads, h, h * dh + c0, ncols, s);
    attention_weights(n, p, ngp, alpha, s);
    if (c < ncols) {
      float sg = 0.f, anc = 0.f, ss = 0.f;
      for (int j = 0; j < ngp; ++j) {
        const float v = s.ft[j * kTileCols + c];
        sg += v;
        anc += s.w_to_anchor[j] * v;
      }
      anc += s.w_self[p] * fa[c];
      for (int i = 0; i < nsib; ++i) {
        const int r = p + 1 + i;
        ss += s.w_anchor[r] * fa[c] + s.w_self[r] * s.ft[r * kTileCols + c];
      }
      pool_gp += sg;
      pool_anchor += anc;
      pool_sib += ss;
    }
    __syncthreads();  // the next head overwrites s.ft and the weights
  }
  if (c < ncols) {
    const float inv_h = 1.f / heads;  // mean over heads
    float* pb = pools + b * 3 * dh + c0 + c;
    pb[0] = pool_gp * inv_h;
    pb[dh] = pool_anchor * inv_h;
    pb[2 * dh] = pool_sib * inv_h;
  }
}

size_t smem_bytes(int n) {
  return sizeof(float) * ((size_t)kStaticFloats + (size_t)n * kTileCols +
                          5 * (size_t)n);
}

cudaError_t prepare(const void* kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* gat_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// All pointers are device pointers to contiguous row-major arrays:
// x [b, n, din], fc [din, heads*dh], wa1/wa2 [din, heads],
// bias_ft [n, heads*dh], bias_a1/bias_a2 [n, heads], ngp/nsib [b] int32,
// out [b, n, heads*dh]. Returns cudaGetLastError() after the launch.
int gat_layer_fwd_f32(const float* x, const float* fc, const float* wa1,
                      const float* wa2, const float* bias_ft,
                      const float* bias_a1, const float* bias_a2,
                      const int* ngp, const int* nsib, float* out, int b,
                      int n, int din, int heads, int dh, int p, float alpha,
                      float out_alpha, int has_out_alpha, void* stream) {
  const size_t smem = smem_bytes(n);
  cudaError_t err = prepare((const void*)gat_layer_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  const int ntiles = (dh + kTileCols - 1) / kTileCols;
  const long long blocks = (long long)b * heads * ntiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (blocks > 0)
    gat_layer_fwd_kernel<<<(unsigned)blocks, kThreads, smem,
                           (cudaStream_t)stream>>>(
        x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, out, n, din,
        heads, dh, p, alpha, out_alpha, has_out_alpha, ntiles);
  return cudaGetLastError();
}

// As gat_layer_fwd_f32, but writes pools [b, 3, dh] (gp, anchor, sib).
int gat_layer_pooled_fwd_f32(const float* x, const float* fc,
                             const float* wa1, const float* wa2,
                             const float* bias_ft, const float* bias_a1,
                             const float* bias_a2, const int* ngp,
                             const int* nsib, float* pools, int b, int n,
                             int din, int heads, int dh, int p, float alpha,
                             void* stream) {
  const size_t smem = smem_bytes(n);
  cudaError_t err = prepare((const void*)gat_layer_pooled_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  const int ntiles = (dh + kTileCols - 1) / kTileCols;
  const long long blocks = (long long)b * ntiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (blocks > 0)
    gat_layer_pooled_fwd_kernel<<<(unsigned)blocks, kThreads, smem,
                                  (cudaStream_t)stream>>>(
        x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, pools, n,
        din, heads, dh, p, alpha, ntiles);
  return cudaGetLastError();
}

}  // extern "C"
