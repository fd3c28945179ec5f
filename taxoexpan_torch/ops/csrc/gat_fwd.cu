// Star-GAT layer forward kernels for Hopper (sm_90a), in eval form
// (serving) and train form (dropout), for float32 layers (*_f32) and bf16
// layers (*_bf16).
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
// Both layers run two launches (and two small preparations).
//  1. The projection P = X @ [fc | wa1 | wa2; wp | wpa1 | wpa2] + the slot
//     biases over all B*N rows, [B*N, wdp] (wdp = H*Dh + 2H rounded up to
//     4: 2008 for config.mag.json's layer 0, 504 for its final layer), on
//     the tensor cores in 3xTF32 (gemm_tf32.cuh): one product a layer, W's
//     tiles reused across 128 rows (two egonets) a block. X is x itself,
//     or, where the layer has masks or a pe path or x's rows are not
//     16-byte multiples, x staged once into a workspace with each mask bit
//     hashed once (gemm_tf32.cuh:stage_input_kernel). The backward
//     (gat_bwd.cu) runs the same product on the same inputs, so its a1/a2
//     and softmax are these bits.
//  2. Per-slot layer (gat_layer_fwd[_train]): the star pass, one block per
//     (egonet, head): a1/a2 from P, the star softmax once (with attention
//     dropout, and the stored weights written where attn is not null),
//     then the aggregation, the optional out_alpha leaky and the output,
//     each thread a column of the head: bound by bytes (P read and the
//     output written once).
//     Pooled layer (gat_layer_pooled_fwd[_train]): the pooled star pass,
//     one block per egonet looping over heads: the same softmax once per
//     (egonet, head), then per column the valid-gp sum, the anchor and the
//     valid-sib sum, averaged over heads in shared memory, the pools
//     written once. It reads the valid rows of P only; the projection
//     computes all B*N rows, as the TPU kernel does.
// The workspace P is 4 * B*N*wdp bytes: 2.1 GB for config.mag.json's layer
// 0 at B = 4096, 0.53 GB for its final layer, 3.8 GB for the MTL
// configuration's layer 0; X staged adds 4 * B*N*kxp bytes (2.15 GB for
// the final layer's train forms, kxp = 2052).
//
// The bf16 forms (compute_dtype "bfloat16"; the Pallas kernels with x in
// bf16): x, fc, wa1, wa2 in bf16, the slot biases and the pe path's rows
// float32; X staged and W packed in bf16 (gemm_tf32.cuh:stage_input_kernel,
// pack_weights_kernel, 8 elements a 16-byte chunk: kxp and wdp rounded up
// to 8), the projection on bf16 tensor-core MMAs with float32 accumulation
// (gemm_wgmma.cuh), so P, the softmax and the aggregation stay float32
// (pallas_gat.py:283-291); the per-slot output is rounded to bf16 after
// the fused leaky (:359-362), the pools stay float32 (:1148). X staged
// takes 2 bytes an element; the final layer's eval form reads x directly
// (4000-byte rows).

#include "bwd_common.cuh"

using gat::bf16;

// Workspaces of the forwards, allocated by the caller; mirrored
// field by field by gat_kernels._FwdWork. E: the layer's element type.
template <class E>
struct FwdWorkT {
  float* proj;     // [b*n, wdp] the projection P
  E* xm;           // [b*n, kxp] X staged, or null (the product reads x)
  E* wcat;         // [kxp, wdp] W
  float* biascat;  // [n, wdp] the slot biases
  int kxp, wdp;
};
using FwdWork = FwdWorkT<float>;

namespace {

using namespace gat;

PassMarks g_marks;

// 2. the star pass of the per-slot layer over the projection P [b*n, ldp],
// the output in OutT (the layer's element type)
template <bool kTrain, class OutT>
__global__ void __launch_bounds__(kThreads)
gat_star_fwd_kernel(const float* __restrict__ proj, int ldp,
                    const int* __restrict__ ngp_arr, OutT* __restrict__ out,
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
  OutT* ob = out + (size_t)b * n * hd + (size_t)h * dh;
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
      ob[(size_t)r * hd + c] = from_float<OutT>(v);
    }
    float va = acc + s.w_self[p] * fa;  // anchor: valid gps and self
    if (has_out_alpha) va = leaky(va, out_alpha);
    ob[(size_t)p * hd + c] = from_float<OutT>(va);
#pragma unroll 4
    for (int r = p + 1; r < n; ++r) {  // sib rows: anchor and self
      float v = s.w_anchor[r] * fa + s.w_self[r] * fb[(size_t)r * ldp + c];
      if (has_out_alpha) v = leaky(v, out_alpha);
      ob[(size_t)r * hd + c] = from_float<OutT>(v);
    }
  }
}

// 2. the pooled star pass over the projection P [b*n, ldp]: one block per
// egonet, looping over heads so that each (egonet, head)'s softmax is
// computed (and, where attn is not null, stored) once; each thread a column
// of the head, its three class sums kept in shared memory across the head
// loop (acc [3][dh], each column touched by its own thread only). Only the
// valid rows of P are read: the pools never see the others.
template <bool kTrain>
__global__ void __launch_bounds__(kThreads)
gat_pooled_star_kernel(const float* __restrict__ proj, int ldp,
                       const int* __restrict__ ngp_arr,
                       const int* __restrict__ nsib_arr,
                       float* __restrict__ pools, int n, int heads, int dh,
                       int p, float alpha, TrainArgs ta,
                       float* __restrict__ attn) {
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  Smem s = {};
  s.a1 = base;
  s.a2 = base + n;
  s.w_self = base + 2 * n;
  s.w_anchor = base + 3 * n;
  s.w_to_anchor = base + 4 * n;
  float* acc = base + 5 * n;
  const long long b = blockIdx.x;
  const int hd = heads * dh;
  const int ngp = min(max(ngp_arr[b], 0), p);
  const int nsib = min(max(nsib_arr[b], 0), n - p - 1);
  const float* pb = proj + (size_t)b * n * ldp;
  for (int c = threadIdx.x; c < 3 * dh; c += kThreads) acc[c] = 0.f;

  for (int h = 0; h < heads; ++h) {
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
    for (int c = threadIdx.x; c < dh; c += kThreads) {
      const float fa = fb[(size_t)p * ldp + c];
      float sg = 0.f, anc = 0.f, ss = 0.f;
#pragma unroll 4
      for (int j = 0; j < ngp; ++j) {  // valid gps: own ft, and -> anchor
        const float v = fb[(size_t)j * ldp + c];
        sg += kTrain ? s.w_self[j] * v : v;  // the dropped gp self-loop
        anc += s.w_to_anchor[j] * v;
      }
      anc += s.w_self[p] * fa;  // anchor: valid gps and self
#pragma unroll 4
      for (int r = p + 1; r <= p + nsib; ++r)  // valid sibs: anchor and self
        ss += s.w_anchor[r] * fa + s.w_self[r] * fb[(size_t)r * ldp + c];
      acc[c] += sg;
      acc[dh + c] += anc;
      acc[2 * dh + c] += ss;
    }
    __syncthreads();  // the next head overwrites a1 / a2 and the weights
  }
  const float inv_h = 1.f / heads;  // mean over heads
  float* out = pools + (size_t)b * 3 * dh;
  for (int c = threadIdx.x; c < 3 * dh; c += kThreads) out[c] = acc[c] * inv_h;
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

// The layer's product operands: x and [fc | wa1 | wa2], the pe path's rows
// from ta.
template <class E>
OperandT<E> layer_operand(const E* x, const E* fc, const E* wa1,
                          const E* wa2, int n, int din, int heads, int dh,
                          const TrainArgs& ta) {
  const int hd = heads * dh;
  return {x,   {fc, wa1, wa2}, {ta.wp, ta.wpa1, ta.wpa2},
          n,   din,            hd,
          hd + heads, hd + 2 * heads};
}

// 1. the projection, with X staged and W packed first (pass marks before,
// between and after)
template <class E>
cudaError_t project(const OperandT<E>& op, const TrainArgs& ta, long long m,
                    const FwdWorkT<E>& w, const float* bias_ft,
                    const float* bias_a1, const float* bias_a2,
                    cudaStream_t st) {
  const ProductWorkT<E> work = {w.xm, nullptr, nullptr, w.kxp, w.wdp, 0, 1};
  mark(g_marks, st);
  cudaError_t err = stage_and_pack(op, ta, m, work, 0, w.wcat, st);
  if (err != cudaSuccess) return err;
  mark(g_marks, st);
  err = gat_projection(op, w.xm, w.kxp, w.wcat, w.wdp, bias_ft, bias_a1,
                       bias_a2, w.biascat, w.proj, m, st);
  mark(g_marks, st);
  return err;
}

template <bool kTrain, class E>
cudaError_t launch_fwd(const E* x, const E* fc, const E* wa1, const E* wa2,
                       const float* bias_ft, const float* bias_a1,
                       const float* bias_a2, const int* ngp, E* out, int b,
                       int n, int din, int heads, int dh, int p, float alpha,
                       float out_alpha, int has_out_alpha,
                       const TrainArgs& ta, float* attn,
                       const FwdWorkT<E>& w, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long m = (long long)b * n;
  if (m == 0) return cudaSuccess;
  cudaError_t err =
      project(layer_operand(x, fc, wa1, wa2, n, din, heads, dh, ta), ta, m, w,
              bias_ft, bias_a1, bias_a2, st);
  if (err != cudaSuccess) return err;

  const size_t smem = 5 * sizeof(float) * (size_t)n;  // 2. the star pass
  const long long blocks = (long long)b * heads;
  if (blocks > 0x7fffffffLL || smem > 48 * 1024) return cudaErrorInvalidValue;
  gat_star_fwd_kernel<kTrain, E><<<(unsigned)blocks, kThreads, smem, st>>>(
      w.proj, w.wdp, ngp, out, n, heads, dh, p, alpha, out_alpha,
      has_out_alpha, ta, attn);
  err = cudaGetLastError();
  mark(g_marks, st);
  return err;
}

// 2. the pooled star pass over P [b*n, ldp] into pools [b, 3, dh]
template <bool kTrain>
cudaError_t pooled_star(const float* proj, int ldp, const int* ngp,
                        const int* nsib, float* pools, int b, int n,
                        int heads, int dh, int p, float alpha,
                        const TrainArgs& ta, float* attn, cudaStream_t st) {
  if (b == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * (5 * (size_t)n + 3 * (size_t)dh);
  cudaError_t err = prepare((const void*)gat_pooled_star_kernel<kTrain>, smem);
  if (err != cudaSuccess) return err;
  gat_pooled_star_kernel<kTrain><<<(unsigned)b, kThreads, smem, st>>>(
      proj, ldp, ngp, nsib, pools, n, heads, dh, p, alpha, ta, attn);
  return cudaGetLastError();
}

template <bool kTrain, class E>
cudaError_t launch_pooled(const E* x, const E* fc, const E* wa1,
                          const E* wa2, const float* bias_ft,
                          const float* bias_a1, const float* bias_a2,
                          const int* ngp, const int* nsib, float* pools,
                          int b, int n, int din, int heads, int dh, int p,
                          float alpha, const TrainArgs& ta, float* attn,
                          const FwdWorkT<E>& w, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long m = (long long)b * n;
  if (m == 0) return cudaSuccess;
  cudaError_t err =
      project(layer_operand(x, fc, wa1, wa2, n, din, heads, dh, ta), ta, m, w,
              bias_ft, bias_a1, bias_a2, st);
  if (err != cudaSuccess) return err;
  err = pooled_star<kTrain>(w.proj, w.wdp, ngp, nsib, pools, b, n, heads, dh,
                            p, alpha, ta, attn, st);
  mark(g_marks, st);
  return err;
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
                             const FwdWork* w, void* stream) {
  const TrainArgs none = {};
  return launch_pooled<false>(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2,
                              ngp, nsib, pools, b, n, din, heads, dh, p,
                              alpha, none, nullptr, *w, stream);
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
                                   float* attn, const FwdWork* w,
                                   void* stream) {
  return launch_pooled<true>(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                             nsib, pools, b, n, din, heads, dh, p, alpha,
                             *ta, attn, *w, stream);
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
  return project(layer_operand(x, fc, wa1, wa2, n, din, heads, dh, *ta), *ta,
                 m, *w, bias_ft, bias_a1, bias_a2, (cudaStream_t)stream);
}

// The pooled star pass alone: pools [b, 3, dh] from a projection proj
// [b*n, ldp] ([ft | a1 | a2] in its first heads*dh + 2*heads columns), with
// the attention masks of *ta (the train form when ta->attn_on or attn is
// not null) and the softmax weights written to attn when it is not null.
int gat_pooled_star_f32(const float* proj, int ldp, const int* ngp,
                        const int* nsib, float* pools, int b, int n,
                        int heads, int dh, int p, float alpha,
                        const TrainArgs* ta, float* attn, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (ta->attn_on || attn != nullptr)
    return pooled_star<true>(proj, ldp, ngp, nsib, pools, b, n, heads, dh, p,
                             alpha, *ta, attn, st);
  return pooled_star<false>(proj, ldp, ngp, nsib, pools, b, n, heads, dh, p,
                            alpha, *ta, nullptr, st);
}

// The bf16 forms of the four layer entry points and the projection alone:
// x, fc, wa1, wa2 and the per-slot out in bf16, every other pointer as in
// the float32 forms (the pools float32); *w with xm and wcat in bf16.
int gat_layer_fwd_bf16(const bf16* x, const bf16* fc, const bf16* wa1,
                       const bf16* wa2, const float* bias_ft,
                       const float* bias_a1, const float* bias_a2,
                       const int* ngp, const int* nsib, bf16* out, int b,
                       int n, int din, int heads, int dh, int p, float alpha,
                       float out_alpha, int has_out_alpha,
                       const FwdWorkT<bf16>* w, void* stream) {
  (void)nsib;
  const TrainArgs none = {};
  return launch_fwd<false>(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                           out, b, n, din, heads, dh, p, alpha, out_alpha,
                           has_out_alpha, none, nullptr, *w, stream);
}

int gat_layer_pooled_fwd_bf16(const bf16* x, const bf16* fc,
                              const bf16* wa1, const bf16* wa2,
                              const float* bias_ft, const float* bias_a1,
                              const float* bias_a2, const int* ngp,
                              const int* nsib, float* pools, int b, int n,
                              int din, int heads, int dh, int p, float alpha,
                              const FwdWorkT<bf16>* w, void* stream) {
  const TrainArgs none = {};
  return launch_pooled<false>(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2,
                              ngp, nsib, pools, b, n, din, heads, dh, p,
                              alpha, none, nullptr, *w, stream);
}

int gat_layer_fwd_train_bf16(const bf16* x, const bf16* fc, const bf16* wa1,
                             const bf16* wa2, const float* bias_ft,
                             const float* bias_a1, const float* bias_a2,
                             const int* ngp, const int* nsib, bf16* out,
                             int b, int n, int din, int heads, int dh, int p,
                             float alpha, float out_alpha, int has_out_alpha,
                             const TrainArgs* ta, float* attn,
                             const FwdWorkT<bf16>* w, void* stream) {
  (void)nsib;
  return launch_fwd<true>(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                          out, b, n, din, heads, dh, p, alpha, out_alpha,
                          has_out_alpha, *ta, attn, *w, stream);
}

int gat_layer_pooled_fwd_train_bf16(const bf16* x, const bf16* fc,
                                    const bf16* wa1, const bf16* wa2,
                                    const float* bias_ft,
                                    const float* bias_a1,
                                    const float* bias_a2, const int* ngp,
                                    const int* nsib, float* pools, int b,
                                    int n, int din, int heads, int dh, int p,
                                    float alpha, const TrainArgs* ta,
                                    float* attn, const FwdWorkT<bf16>* w,
                                    void* stream) {
  return launch_pooled<true>(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                             nsib, pools, b, n, din, heads, dh, p, alpha,
                             *ta, attn, *w, stream);
}

int gat_projection_bf16(const bf16* x, const bf16* fc, const bf16* wa1,
                        const bf16* wa2, const float* bias_ft,
                        const float* bias_a1, const float* bias_a2, int b,
                        int n, int din, int heads, int dh,
                        const TrainArgs* ta, const FwdWorkT<bf16>* w,
                        void* stream) {
  const long long m = (long long)b * n;
  if (m == 0) return cudaSuccess;
  return project(layer_operand(x, fc, wa1, wa2, n, din, heads, dh, *ta), *ta,
                 m, *w, bias_ft, bias_a1, bias_a2, (cudaStream_t)stream);
}

// Launch timing of the forwards: with `on`, the next call records device
// events around its launches; gat_fwd_pass_ms then gives their
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
