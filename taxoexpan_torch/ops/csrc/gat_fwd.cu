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
// The train forms mask x, add the masked pe rows as extra K columns and
// multiply the attention weights by their masks (gat_common.cuh); the
// dropout bits are a pure function of the element's indices, so the
// backward kernels (gat_bwd.cu) replay them exactly. Given an attn pointer
// (the store form, TAXOEXPAN_STORED_ATTN=1) they also write the softmax
// weights before dropout, [B, H, 2N - P - 1] (layout in gat_common.cuh),
// for the stored-attention backward (pallas_gat.py:231).
//
// What bounds it on an H100: the x @ fc product. At the config.mag.json
// shapes (N = 64) layer 0 does 2*B*64*(250 [+50])*2008 flop and writes
// B*64*2000 floats; the final layer does 2*B*64*(2000 [+50])*502 flop and
// writes only the pools. Both sit far above the float32 ridge point.
//
// Per-slot layer (gat_layer_fwd[_train]): two launches (and two small
// preparations).
//  1. The projection P = X @ [fc | wa1 | wa2; wp | wpa1 | wpa2] + the slot
//     biases over all B*N rows, [B*N, wdp] (wdp = H*Dh + 2H rounded up to
//     4), on the tensor cores in 3xTF32 (gemm_tf32.cuh): one product a
//     layer, W's tiles reused across 128 rows (two egonets) a block. X is
//     x itself, or, where the layer has masks or a pe path or x's rows are
//     not 16-byte multiples, x staged once into a workspace with each mask
//     bit hashed once (gemm_tf32.cuh:stage_input_kernel). The backward
//     (gat_bwd.cu) runs the same product on the same inputs, so its a1/a2
//     and softmax are these bits.
//  2. The star pass, one block per (egonet, head): a1/a2 from P, the star
//     softmax once (with attention dropout, and the stored weights written
//     where attn is not null), then the aggregation, the optional
//     out_alpha leaky and the output, each thread a column of the head:
//     bound by bytes (P read and the output written once).
// The workspace P is 4 * B*N*wdp bytes: 2.1 GB for config.mag.json's layer
// 0 at B = 4096, 3.8 GB for the MTL configuration's layer 0.
//
// Pooled layer (gat_layer_pooled_fwd[_train], simple first): one block of
// 256 threads per (egonet, 128-column tile), looping over heads so that
// the head mean and class sums stay in registers; a register-tiled SIMT
// product (4 rows x 8 columns per thread, K tiles of 16 staged in shared
// memory) with a1/a2 folded into the same K loop, the ft tile [N, 128] in
// shared memory, the pools written directly: ft never reaches device
// memory. Moving it onto the projection is later work.

#include "bwd_common.cuh"

// Workspaces of the per-slot forward, allocated by the caller; mirrored
// field by field by gat_kernels._FwdWork.
struct FwdWork {
  float* proj;     // [b*n, wdp] the projection P
  float* xm;       // [b*n, kxp] X staged, or null (the product reads x)
  float* wcat;     // [kxp, wdp] W
  float* biascat;  // [n, wdp] the slot biases
  int kxp, wdp;
};

namespace {

using namespace gat;

PassMarks g_marks;

// 2. the star pass of the per-slot layer over the projection P [b*n, ldp]
template <bool kTrain>
__global__ void __launch_bounds__(kThreads)
gat_star_fwd_kernel(const float* __restrict__ proj, int ldp,
                    const int* __restrict__ ngp_arr, float* __restrict__ out,
                    int n, int heads, int dh, int p, float alpha,
                    float out_alpha, int has_out_alpha, TrainArgs ta,
                    float* __restrict__ attn) {
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  Smem s = {};
  s.a1 = base;
  s.a2 = base + n;
  s.w_self = base + 2 * n;
  s.w_anchor = base + 3 * n;
  s.w_to_anchor = base + 4 * n;
  const long long b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int hd = heads * dh;
  const int ngp = min(max(ngp_arr[b], 0), p);
  // invalid sibling slots keep their formula value, as in the TPU kernel
  // (callers mask them downstream)
  const float* pb = proj + (size_t)b * n * ldp;
  for (int r = threadIdx.x; r < n; r += kThreads) {
    s.a1[r] = pb[(size_t)r * ldp + hd + h];
    s.a2[r] = pb[(size_t)r * ldp + hd + heads + h];
  }
  __syncthreads();
  float* stored =
      attn != nullptr ? attn + ((size_t)b * heads + h) * attn_row(n, p)
                      : nullptr;
  attention_weights<kTrain, false>(n, p, ngp, alpha, s, ta, b, h, stored);

  const float* fb = pb + (size_t)h * dh;
  float* ob = out + (size_t)b * n * hd + (size_t)h * dh;
  // each thread a column; the row loops unrolled so that several rows'
  // loads are in flight at once
  for (int c = threadIdx.x; c < dh; c += kThreads) {
    const float fa = fb[(size_t)p * ldp + c];
    float acc = 0.f;
#pragma unroll 4
    for (int r = 0; r < p; ++r) {  // gp rows: their own ft
      const float f = fb[(size_t)r * ldp + c];
      if (r < ngp) acc += s.w_to_anchor[r] * f;
      float v = kTrain ? f * s.w_self[r] : f;  // the dropped gp self-loop
      if (has_out_alpha) v = leaky(v, out_alpha);
      ob[(size_t)r * hd + c] = v;
    }
    float va = acc + s.w_self[p] * fa;  // anchor: valid gps and self
    if (has_out_alpha) va = leaky(va, out_alpha);
    ob[(size_t)p * hd + c] = va;
#pragma unroll 4
    for (int r = p + 1; r < n; ++r) {  // sib rows: anchor and self
      float v = s.w_anchor[r] * fa + s.w_self[r] * fb[(size_t)r * ldp + c];
      if (has_out_alpha) v = leaky(v, out_alpha);
      ob[(size_t)r * hd + c] = v;
    }
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
                            int ntiles, TrainArgs ta,
                            float* __restrict__ attn) {
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
    float* stored = (attn != nullptr && c0 == 0)
                        ? attn + ((size_t)b * heads + h) * attn_row(n, p)
                        : nullptr;
    attention_weights<kTrain, false>(n, p, ngp, alpha, s, ta, b, h, stored);
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

// The pooled kernels. The train form asks for two resident blocks an SM
// (at most 128 registers a thread: 157 without the bound left one block an
// SM); the eval form keeps the serving kernel's bounds. attn, of the train
// form only, is null or receives the softmax weights (the store form).
#define GAT_FWD_PARAMS                                                     \
  const float *__restrict__ x, const float *__restrict__ fc,               \
      const float *__restrict__ wa1, const float *__restrict__ wa2,        \
      const float *__restrict__ bias_ft, const float *__restrict__ bias_a1, \
      const float *__restrict__ bias_a2, const int *__restrict__ ngp_arr,  \
      const int *__restrict__ nsib_arr
#define GAT_FWD_ARGS \
  x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp_arr, nsib_arr

__global__ void __launch_bounds__(kThreads)
gat_layer_pooled_fwd_kernel(GAT_FWD_PARAMS, float* __restrict__ pools, int n,
                            int din, int heads, int dh, int p, float alpha,
                            int ntiles, TrainArgs ta) {
  pooled_body<false>(GAT_FWD_ARGS, pools, n, din, heads, dh, p, alpha, ntiles,
                     ta, nullptr);
}

__global__ void __launch_bounds__(kThreads, 2)
gat_layer_pooled_fwd_train_kernel(GAT_FWD_PARAMS, float* __restrict__ pools,
                                  int n, int din, int heads, int dh, int p,
                                  float alpha, int ntiles, TrainArgs ta,
                                  float* __restrict__ attn) {
  pooled_body<true>(GAT_FWD_ARGS, pools, n, din, heads, dh, p, alpha, ntiles,
                    ta, attn);
}

// The dropout generator alone (words, or the 8-bit mode's bytes), for
// checking it against ops/dropout.py.
__global__ void dropout_bits_kernel(unsigned seed, unsigned stream,
                                    const unsigned* __restrict__ rows,
                                    const unsigned* __restrict__ cols,
                                    unsigned* __restrict__ out,
                                    long long count, int bits8) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count)
    out[i] = drop_value(row_key(stream_key(seed, stream), rows[i]), cols[i],
                        bits8);
}

// 1. the projection, with X staged and W packed first (pass marks before,
// between and after)
cudaError_t project(const Operand& op, const TrainArgs& ta, long long m,
                    const FwdWork& w, const float* bias_ft,
                    const float* bias_a1, const float* bias_a2,
                    cudaStream_t st) {
  const ProductWork work = {w.xm, nullptr, nullptr, w.kxp, w.wdp, 0, 1};
  mark(g_marks, st);
  cudaError_t err = stage_and_pack(op, ta, m, work, 0, w.wcat, st);
  if (err != cudaSuccess) return err;
  mark(g_marks, st);
  err = gat_projection(op, w.xm, w.kxp, w.wcat, w.wdp, bias_ft, bias_a1,
                       bias_a2, w.biascat, w.proj, m, st);
  mark(g_marks, st);
  return err;
}

template <bool kTrain>
cudaError_t launch_fwd(const float* x, const float* fc, const float* wa1,
                       const float* wa2, const float* bias_ft,
                       const float* bias_a1, const float* bias_a2,
                       const int* ngp, float* out, int b, int n, int din,
                       int heads, int dh, int p, float alpha, float out_alpha,
                       int has_out_alpha, const TrainArgs& ta, float* attn,
                       const FwdWork& w, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long m = (long long)b * n;
  if (m == 0) return cudaSuccess;
  const int hd = heads * dh, wd = hd + 2 * heads;
  const Operand op = {x, {fc, wa1, wa2}, {ta.wp, ta.wpa1, ta.wpa2}, n, din,
                      hd, hd + heads, wd};
  cudaError_t err = project(op, ta, m, w, bias_ft, bias_a1, bias_a2, st);
  if (err != cudaSuccess) return err;

  const size_t smem = 5 * sizeof(float) * (size_t)n;  // 2. the star pass
  const long long blocks = (long long)b * heads;
  if (blocks > 0x7fffffffLL || smem > 48 * 1024) return cudaErrorInvalidValue;
  gat_star_fwd_kernel<kTrain><<<(unsigned)blocks, kThreads, smem, st>>>(
      w.proj, w.wdp, ngp, out, n, heads, dh, p, alpha, out_alpha,
      has_out_alpha, ta, attn);
  err = cudaGetLastError();
  mark(g_marks, st);
  return err;
}

template <bool kTrain>
cudaError_t launch_pooled(const float* x, const float* fc, const float* wa1,
                          const float* wa2, const float* bias_ft,
                          const float* bias_a1, const float* bias_a2,
                          const int* ngp, const int* nsib, float* pools,
                          int b, int n, int din, int heads, int dh, int p,
                          float alpha, const TrainArgs& ta, float* attn,
                          void* stream) {
  const size_t smem = smem_bytes(n, kTrain ? kTrainLayout : kEvalLayout);
  cudaError_t err =
      prepare(kTrain ? (const void*)gat_layer_pooled_fwd_train_kernel
                     : (const void*)gat_layer_pooled_fwd_kernel,
              smem);
  if (err != cudaSuccess) return err;
  const int ntiles = (dh + kTileCols - 1) / kTileCols;
  const long long blocks = (long long)b * ntiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  const cudaStream_t st = (cudaStream_t)stream;
  if (blocks > 0 && kTrain)
    gat_layer_pooled_fwd_train_kernel<<<grid, kThreads, smem, st>>>(
        x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, pools, n, din,
        heads, dh, p, alpha, ntiles, ta, attn);
  else if (blocks > 0)
    gat_layer_pooled_fwd_kernel<<<grid, kThreads, smem, st>>>(
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
// out [b, n, heads*dh]; *w the workspaces. Returns the first CUDA error of
// a launch, or 0.
int gat_layer_fwd_f32(const float* x, const float* fc, const float* wa1,
                      const float* wa2, const float* bias_ft,
                      const float* bias_a1, const float* bias_a2,
                      const int* ngp, const int* nsib, float* out, int b,
                      int n, int din, int heads, int dh, int p, float alpha,
                      float out_alpha, int has_out_alpha, const FwdWork* w,
                      void* stream) {
  (void)nsib;  // invalid sibling slots keep their formula value
  const TrainArgs none = {};
  return launch_fwd<false>(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                           out, b, n, din, heads, dh, p, alpha, out_alpha,
                           has_out_alpha, none, nullptr, *w, stream);
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
                              alpha, none, nullptr, stream);
}

// Train forms: as above, with dropout and the pe path described by *ta;
// attn [b, heads, 2n - p - 1] receives the softmax weights before dropout
// when it is not null (the store form).
int gat_layer_fwd_train_f32(const float* x, const float* fc,
                            const float* wa1, const float* wa2,
                            const float* bias_ft, const float* bias_a1,
                            const float* bias_a2, const int* ngp,
                            const int* nsib, float* out, int b, int n,
                            int din, int heads, int dh, int p, float alpha,
                            float out_alpha, int has_out_alpha,
                            const TrainArgs* ta, float* attn,
                            const FwdWork* w, void* stream) {
  (void)nsib;
  return launch_fwd<true>(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                          out, b, n, din, heads, dh, p, alpha, out_alpha,
                          has_out_alpha, *ta, attn, *w, stream);
}

int gat_layer_pooled_fwd_train_f32(const float* x, const float* fc,
                                   const float* wa1, const float* wa2,
                                   const float* bias_ft, const float* bias_a1,
                                   const float* bias_a2, const int* ngp,
                                   const int* nsib, float* pools, int b,
                                   int n, int din, int heads, int dh, int p,
                                   float alpha, const TrainArgs* ta,
                                   float* attn, void* stream) {
  return launch_pooled<true>(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                             nsib, pools, b, n, din, heads, dh, p, alpha,
                             *ta, attn, stream);
}

// The projection alone, P = [x*m | pe*m_pe] @ [fc | wa1 | wa2; wp | wpa1 |
// wpa2] + the slot biases into w->proj [b*n, wdp] (the train form's masks
// and pe rows as *ta describes; eval form: a zeroed TrainArgs).
int gat_projection_f32(const float* x, const float* fc, const float* wa1,
                       const float* wa2, const float* bias_ft,
                       const float* bias_a1, const float* bias_a2, int b,
                       int n, int din, int heads, int dh, const TrainArgs* ta,
                       const FwdWork* w, void* stream) {
  const long long m = (long long)b * n;
  if (m == 0) return cudaSuccess;
  const int hd = heads * dh;
  const Operand op = {x,   {fc, wa1, wa2}, {ta->wp, ta->wpa1, ta->wpa2},
                      n,   din,            hd,
                      hd + heads, hd + 2 * heads};
  return project(op, *ta, m, *w, bias_ft, bias_a1, bias_a2,
                 (cudaStream_t)stream);
}

// Launch timing of the per-slot forward: with `on`, the next call records
// device events around its launches; gat_fwd_pass_ms then gives their
// milliseconds (stage and pack, projection, star pass) into out[3] and
// returns their count.
int gat_fwd_set_timing(int on) { return set_timing(g_marks, on); }

int gat_fwd_pass_ms(float* out) { return pass_ms(g_marks, out); }

// out[i] = dropout bits of (rows[i], cols[i]) in `stream` (uint32 arrays):
// the 32-bit words, or with bits8 the 8-bit mode's bytes.
int dropout_bits_u32(unsigned seed, unsigned stream_id, const unsigned* rows,
                     const unsigned* cols, unsigned* out, long long count,
                     int bits8, void* stream) {
  if (count > 0)
    dropout_bits_kernel<<<(unsigned)((count + 255) / 256), 256, 0,
                          (cudaStream_t)stream>>>(seed, stream_id, rows, cols,
                                                  out, count, bits8);
  return cudaGetLastError();
}

}  // extern "C"
