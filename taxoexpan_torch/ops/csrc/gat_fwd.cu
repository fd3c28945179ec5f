// Star-GAT layer forward kernels for Hopper (sm_90a), float32, in eval form
// (serving) and train form (dropout).
//
// Replace the forward Pallas kernels of taxoexpan_tpu/ops/pallas_gat.py:
//   gat_layer_fwd[_train]        <- fused_gat_layer        (_fused_fwd,
//                                                           _fwd_kernel)
//   gat_layer_pooled_fwd[_train] <- fused_gat_layer_pooled (_fused_pooled_fwd,
//                                                           _fwd_pool_kernel)
// Per egonet b, head h:
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
// The train forms (kTrain) mask x as it is staged, add the masked pe rows
// as extra K columns and multiply the attention weights by their masks
// (gat_common.cuh); the dropout bits are a pure function of the element's
// indices, so the backward kernels (gat_bwd.cu) replay them exactly.
//
// What bounds it on an H100: the x @ fc product. At the config.mag.json
// shapes (N = 64) layer 0 does 2*B*64*(250 [+50])*2008 flop and writes
// B*64*2000 floats; the final layer does 2*B*64*(2000 [+50])*502 flop and
// writes only the pools. Both sit above the float32 ridge point, so the
// bound is the float32 FMA rate (the tensor cores' TF32 would break f32
// parity). The train form adds one 32-bit hash per staged x element.
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

#include "gat_common.cuh"

namespace {

using namespace gat;

template <bool kTrain>
__device__ __forceinline__ void
fwd_body(const float* __restrict__ x, const float* __restrict__ fc,
                     const float* __restrict__ wa1,
                     const float* __restrict__ wa2,
                     const float* __restrict__ bias_ft,
                     const float* __restrict__ bias_a1,
                     const float* __restrict__ bias_a2,
                     const int* __restrict__ ngp_arr,
                     const int* __restrict__ nsib_arr, float* __restrict__ out,
                     int n, int din, int heads, int dh, int p, float alpha,
                     float out_alpha, int has_out_alpha, int ntiles,
                     TrainArgs ta) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), n,
                       kTrain ? kTrainLayout : kEvalLayout);
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

  if (kTrain) setup_row_keys(ta, b, n, s);
  head_tile<kTrain>(x + b * n * din, fc, wa1, wa2, bias_ft, bias_a1, bias_a2,
                    n, din, hd, heads, h, col0, ncols, s, ta);
  attention_weights<kTrain, false>(n, p, ngp, alpha, s, ta, b, h);

  float* outb = out + b * n * hd;
  const float* fa = s.ft + p * kTileCols;
  for (int e = threadIdx.x; e < n * kTileCols; e += kThreads) {
    const int r = e / kTileCols, c = e % kTileCols;
    if (c >= ncols) continue;
    float v;
    if (r < p) {
      v = s.ft[r * kTileCols + c];
      if (kTrain) v *= s.w_self[r];  // the dropped gp self-loop
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

template <bool kTrain>
__device__ __forceinline__ void
pooled_body(const float* __restrict__ x,
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
                            int ntiles, TrainArgs ta) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), n,
                       kTrain ? kTrainLayout : kEvalLayout);
  const long long b = blockIdx.x / ntiles;
  const int c0 = (blockIdx.x % ntiles) * kTileCols;
  const int ncols = min(kTileCols, dh - c0);
  const int hd = heads * dh;
  const int ngp = min(max(ngp_arr[b], 0), p);
  const int nsib = min(max(nsib_arr[b], 0), n - p - 1);
  const int c = threadIdx.x;  // threads c < ncols own one pool column
  const float* fa = s.ft + p * kTileCols;
  float pool_gp = 0.f, pool_anchor = 0.f, pool_sib = 0.f;

  if (kTrain) setup_row_keys(ta, b, n, s);
  for (int h = 0; h < heads; ++h) {
    head_tile<kTrain>(x + b * n * din, fc, wa1, wa2, bias_ft, bias_a1,
                      bias_a2, n, din, hd, heads, h, h * dh + c0, ncols, s,
                      ta);
    attention_weights<kTrain, false>(n, p, ngp, alpha, s, ta, b, h);
    if (c < ncols) {
      float sg = 0.f, anc = 0.f, ss = 0.f;
      for (int j = 0; j < ngp; ++j) {
        const float v = s.ft[j * kTileCols + c];
        sg += kTrain ? s.w_self[j] * v : v;
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

// The kernels. The train forms ask for two resident blocks an SM (at most
// 128 registers a thread: 157 without the bound left one block an SM);
// the eval forms keep the serving kernels' bounds.
#define GAT_FWD_PARAMS                                                     \
  const float *__restrict__ x, const float *__restrict__ fc,               \
      const float *__restrict__ wa1, const float *__restrict__ wa2,        \
      const float *__restrict__ bias_ft, const float *__restrict__ bias_a1, \
      const float *__restrict__ bias_a2, const int *__restrict__ ngp_arr,  \
      const int *__restrict__ nsib_arr
#define GAT_FWD_ARGS \
  x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp_arr, nsib_arr

__global__ void __launch_bounds__(kThreads)
gat_layer_fwd_kernel(GAT_FWD_PARAMS, float* __restrict__ out, int n, int din,
                     int heads, int dh, int p, float alpha, float out_alpha,
                     int has_out_alpha, int ntiles, TrainArgs ta) {
  fwd_body<false>(GAT_FWD_ARGS, out, n, din, heads, dh, p, alpha, out_alpha,
                  has_out_alpha, ntiles, ta);
}

__global__ void __launch_bounds__(kThreads, 2)
gat_layer_fwd_train_kernel(GAT_FWD_PARAMS, float* __restrict__ out, int n,
                           int din, int heads, int dh, int p, float alpha,
                           float out_alpha, int has_out_alpha, int ntiles,
                           TrainArgs ta) {
  fwd_body<true>(GAT_FWD_ARGS, out, n, din, heads, dh, p, alpha, out_alpha,
                 has_out_alpha, ntiles, ta);
}

__global__ void __launch_bounds__(kThreads)
gat_layer_pooled_fwd_kernel(GAT_FWD_PARAMS, float* __restrict__ pools, int n,
                            int din, int heads, int dh, int p, float alpha,
                            int ntiles, TrainArgs ta) {
  pooled_body<false>(GAT_FWD_ARGS, pools, n, din, heads, dh, p, alpha, ntiles,
                     ta);
}

__global__ void __launch_bounds__(kThreads, 2)
gat_layer_pooled_fwd_train_kernel(GAT_FWD_PARAMS, float* __restrict__ pools,
                                  int n, int din, int heads, int dh, int p,
                                  float alpha, int ntiles, TrainArgs ta) {
  pooled_body<true>(GAT_FWD_ARGS, pools, n, din, heads, dh, p, alpha, ntiles,
                    ta);
}

// The dropout generator alone, for checking it against ops/dropout.py.
__global__ void dropout_bits_kernel(unsigned seed, unsigned stream,
                                    const unsigned* __restrict__ rows,
                                    const unsigned* __restrict__ cols,
                                    unsigned* __restrict__ out,
                                    long long count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count)
    out[i] = drop_bits(row_key(stream_key(seed, stream), rows[i]), cols[i]);
}

template <bool kTrain>
cudaError_t launch_fwd(const float* x, const float* fc, const float* wa1,
                       const float* wa2, const float* bias_ft,
                       const float* bias_a1, const float* bias_a2,
                       const int* ngp, const int* nsib, float* out, int b,
                       int n, int din, int heads, int dh, int p, float alpha,
                       float out_alpha, int has_out_alpha,
                       const TrainArgs& ta, void* stream) {
  const size_t smem = smem_bytes(n, kTrain ? kTrainLayout : kEvalLayout);
  const void* kernel = kTrain ? (const void*)gat_layer_fwd_train_kernel
                              : (const void*)gat_layer_fwd_kernel;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const int ntiles = (dh + kTileCols - 1) / kTileCols;
  const long long blocks = (long long)b * heads * ntiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (blocks > 0)
    (kTrain ? gat_layer_fwd_train_kernel
            : gat_layer_fwd_kernel)<<<(unsigned)blocks, kThreads, smem,
                                      (cudaStream_t)stream>>>(
        x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, out, n, din,
        heads, dh, p, alpha, out_alpha, has_out_alpha, ntiles, ta);
  return cudaGetLastError();
}

template <bool kTrain>
cudaError_t launch_pooled(const float* x, const float* fc, const float* wa1,
                          const float* wa2, const float* bias_ft,
                          const float* bias_a1, const float* bias_a2,
                          const int* ngp, const int* nsib, float* pools,
                          int b, int n, int din, int heads, int dh, int p,
                          float alpha, const TrainArgs& ta, void* stream) {
  const size_t smem = smem_bytes(n, kTrain ? kTrainLayout : kEvalLayout);
  const void* kernel = kTrain
                           ? (const void*)gat_layer_pooled_fwd_train_kernel
                           : (const void*)gat_layer_pooled_fwd_kernel;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const int ntiles = (dh + kTileCols - 1) / kTileCols;
  const long long blocks = (long long)b * ntiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (blocks > 0)
    (kTrain ? gat_layer_pooled_fwd_train_kernel
            : gat_layer_pooled_fwd_kernel)<<<(unsigned)blocks, kThreads, smem,
                                             (cudaStream_t)stream>>>(
        x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, pools, n, din,
        heads, dh, p, alpha, ntiles, ta);
  return cudaGetLastError();
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
  const TrainArgs none = {};
  return launch_fwd<false>(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                           nsib, out, b, n, din, heads, dh, p, alpha,
                           out_alpha, has_out_alpha, none, stream);
}

// As gat_layer_fwd_f32, but writes pools [b, 3, dh] (gp, anchor, sib).
int gat_layer_pooled_fwd_f32(const float* x, const float* fc,
                             const float* wa1, const float* wa2,
                             const float* bias_ft, const float* bias_a1,
                             const float* bias_a2, const int* ngp,
                             const int* nsib, float* pools, int b, int n,
                             int din, int heads, int dh, int p, float alpha,
                             void* stream) {
  const TrainArgs none = {};
  return launch_pooled<false>(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2,
                              ngp, nsib, pools, b, n, din, heads, dh, p,
                              alpha, none, stream);
}

// Train forms: as above, with dropout and the pe path described by *ta.
int gat_layer_fwd_train_f32(const float* x, const float* fc,
                            const float* wa1, const float* wa2,
                            const float* bias_ft, const float* bias_a1,
                            const float* bias_a2, const int* ngp,
                            const int* nsib, float* out, int b, int n,
                            int din, int heads, int dh, int p, float alpha,
                            float out_alpha, int has_out_alpha,
                            const TrainArgs* ta, void* stream) {
  return launch_fwd<true>(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                          nsib, out, b, n, din, heads, dh, p, alpha,
                          out_alpha, has_out_alpha, *ta, stream);
}

int gat_layer_pooled_fwd_train_f32(const float* x, const float* fc,
                                   const float* wa1, const float* wa2,
                                   const float* bias_ft, const float* bias_a1,
                                   const float* bias_a2, const int* ngp,
                                   const int* nsib, float* pools, int b,
                                   int n, int din, int heads, int dh, int p,
                                   float alpha, const TrainArgs* ta,
                                   void* stream) {
  return launch_pooled<true>(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                             nsib, pools, b, n, din, heads, dh, p, alpha,
                             *ta, stream);
}

// out[i] = dropout bits of (rows[i], cols[i]) in `stream` (uint32 arrays).
int dropout_bits_u32(unsigned seed, unsigned stream_id, const unsigned* rows,
                     const unsigned* cols, unsigned* out, long long count,
                     void* stream) {
  if (count > 0)
    dropout_bits_kernel<<<(unsigned)((count + 255) / 256), 256, 0,
                          (cudaStream_t)stream>>>(seed, stream_id, rows, cols,
                                                  out, count);
  return cudaGetLastError();
}

}  // extern "C"
