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
// Both element types take the same three forms, chosen by shape on the
// host (gat_kernels.fwd_form) and named to these entry points by the
// workspaces the caller passes (FwdWorkT: wa set for the fused form,
// row_off for the valid-rows form, else the two-pass form). The products
// run on the TMA-fed wgmma ring of gemm_wgmma.cuh: 3xTF32 for float32
// layers (float32-accurate on the tensor cores), bf16 wgmma with float32
// accumulation for bf16 layers (x, fc, wa1, wa2 in bf16, the slot biases
// and the pe path's rows float32; X staged and W packed in bf16, 8
// elements a 16-byte chunk, so kxp and wdp round up to 8; ft, a1, a2, the
// softmax and the aggregation float32, pallas_gat.py:283-291; the per-slot
// output rounded to bf16 after the fused leaky, :359-362; the pools
// float32, :1148). X is x itself, or, where the layer has masks or a pe
// path or x's rows are not 16-byte multiples, x staged once into a
// workspace with each mask bit hashed once
// (gemm_tf32.cuh:stage_input_kernel).
//  - Per-slot layer at n <= kFusedMaxSlots (64; every configuration: N =
//    64, 54, 52 or 30), the fused form, four launches and two
//    preparations; P never reaches device memory:
//     stage + pack  X staged where needed; W split into [fc; wp] (wcat,
//                   wdp = H*Dh rounded up to a chunk) and [wa1 | wa2; wpa1
//                   | wpa2] (wa), their slot biases packed alike (float32:
//                   W^T as TF32 hi / lo planes);
//     pass A        [a1 | a2] = X @ wa + their slot biases, float32 [B*N,
//                   lda] (lda = 2H rounded up to 4; 8.4 MB at layer 0), on
//                   the product's narrow tile: the same K order and 64-deep
//                   FADDs as the backward's projection, whose a1 / a2
//                   columns (and so its softmax) are these bits;
//     weights       the star softmax once per (egonet, head)
//                   (star_weights_kernel: attention masks, the stored
//                   weights), each row's weights into wts (16.8 MB);
//     pass B        X @ [fc; wp] with the star epilogue (gemm_wgmma.cuh:
//                   kEpiStar): each consumer warpgroup holds floor(64 / n)
//                   whole egonets of ft (+ its slot biases), the weights of
//                   the heads its columns touch copied in while the
//                   products run, aggregates them and writes the output,
//                   after the leaky, once. bf16: the whole 64 x 128 C tile
//                   in shared memory. float32: the 3xTF32 ring's four
//                   48 KB stages leave 34 KB of the block's 227 KB, so each
//                   consumer stages its ft a 32-column quarter at a time
//                   (8 KB) beside its 4 KB of weights (f32_star_stage,
//                   f32_star_quarter). The softmax stays out of the
//                   epilogue: the anchor's is a serial chain of
//                   exponentials that would stall the tensor cores once
//                   per column tile.
//    What bounds it: the product (X read from L2 once per 128-column
//    tile) with its epilogue, which the tensor cores wait for, and the
//    output (float32 2.1 GB at config.mag.json's layer 0, B = 4096; bf16
//    1.05 GB), where the two-pass form also wrote and read P (float32
//    2.1 GB there). At n < 64 a warpgroup computes 64 rows for floor(64 /
//    n) * n (52 of 64 at MAG-Full's N = 52). The float32 output has the
//    two-pass form's bits: ft is the projection's bits (same K order,
//    same tile columns) and the star pass's FMA chains are written alike
//    in both forms.
//  - Pooled layer, eval and train forms, the valid-rows form: the valid
//    rows alone are counted and scanned on the card
//    (bwd_common.cuh:valid_row_offsets_kernel), staged compacted with
//    their own masks and a row map (stage_valid_rows_kernel; R rows, about
//    half of B*N in the smoke's batch), multiplied (the projection over R
//    rows read on the card, GemmArgs::rows: no host sync) into P [R, wdp],
//    and the pooled star pass reads them through the egonets' row offsets.
//    Bound by the staging's bytes and the product on R rows. A row's
//    wgmma result does not depend on its place in the tile, so the pools
//    have the bits of the all-rows form, and K4 (which compacts the same
//    rows) recomputes this softmax.
//  - Otherwise, the two-pass form: the per-slot layer at n > 64 (a
//    warpgroup's 64 rows hold no whole egonet) and the pooled store form
//    (it stores the invalid siblings' formula weights too, which need those
//    rows' a1 / a2):
//     1. the projection P = X @ [fc | wa1 | wa2; wp | wpa1 | wpa2] + the
//        slot biases over all B*N rows, float32 [B*N, wdp] (wdp = H*Dh +
//        2H rounded up: 2008 at config.mag.json's layer 0, 504 at its
//        final layer), kEpiRowBias; the backward (gat_bwd.cu) runs the
//        same product on the same inputs, so its a1 / a2 and softmax are
//        these bits;
//     2. per-slot layer: the star pass (gat_star_fwd_kernel), one block
//        per (egonet, head): a1 / a2 from P, the star softmax once (with
//        attention dropout, the stored weights written where attn is not
//        null), then the aggregation, the optional out_alpha leaky and the
//        output, each thread a column of the head. Pooled layer: the
//        pooled star pass (gat_pooled_star_kernel), one block per egonet
//        looping over heads: the same softmax once per (egonet, head), then
//        per column the valid-gp sum, the anchor and the valid-sib sum,
//        averaged over heads in shared memory, the pools written once.
//    Bound by P's bytes, written and read once (4 * B*N*wdp: 2.1 GB at
//    config.mag.json's layer 0, 3.8 GB at the MTL configuration's), and
//    the product.

#include "bwd_common.cuh"

using gat::bf16;

// Workspaces of the forwards, allocated by the caller (each form its
// own; the others null); mirrored field by field by gat_kernels._FwdWork.
// E: the layer's element type.
template <class E>
struct FwdWorkT {
  float* proj;     // [b*n, wdp] the projection P (not the fused form; the
                   // valid-rows form's R rows first)
  E* xm;           // [b*n, kxp] X staged, or null (the products read x);
                   // the valid-rows form: [b*n + kRowPad, kxp], compacted
  E* wcat;         // [kxp, wdp] W (the fused form: [fc; wp] alone);
                   // float32: W^T as hi / lo planes [2, wdp, kxp]
  float* biascat;  // [n, wdp] the slot biases of wcat's columns
  E* wa;           // the fused form: [kxp, wap] [wa1 | wa2; wpa1 | wpa2]
                   // (float32: planes [2, wap, kxp]), or null
  float* biasa;    // the fused form: [n, lda] bias_a1 | bias_a2
  float* a12;      // the fused form: [b*n, lda] pass A's a1 | a2
  float* wts;      // the fused form: [b*n, heads, 4] the star weights
  int* row_off;    // the valid-rows form: [b + 1] (bwd_common.cuh), or null
  int* row_map;    // the valid-rows form: [b*n + kRowPad]
  int kxp, wdp, wap, lda;
};

// The largest n of the per-slot fused form: a consumer warpgroup's 64 rows
// hold whole egonets.
constexpr int kFusedMaxSlots = 64;
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
  // loads are in flight at once. Every row is w_self f + (w_anchor fa + the
  // valid gps' weighted ft at the anchor), w_anchor being 0 on the gp rows
  // and the anchor (and w_self 1 on the gp rows of the eval form): the FMA
  // chain of the float32 fused form's epilogue
  // (gemm_wgmma.cuh:f32_star_quarter), so that the two forms give equal bits
  for (int c = threadIdx.x; c < dh; c += kThreads) {
    const float fa = fb[(size_t)p * ldp + c];
    float acc = 0.f;
#pragma unroll 4
    for (int r = 0; r < p; ++r) {  // gp rows: their own ft
      const float f = fb[(size_t)r * ldp + c];
      if (r < ngp) acc = __fmaf_rn(s.w_to_anchor[r], f, acc);
      // times the gp self-loop's mask in the train form
      float v = __fmaf_rn(s.w_self[r], f, __fmaf_rn(s.w_anchor[r], fa, 0.f));
      if (has_out_alpha) v = leaky(v, out_alpha);
      ob[(size_t)r * hd + c] = from_float<OutT>(v);
    }
    // anchor: the valid gps, then itself
    float va = __fmaf_rn(s.w_self[p], fa, __fmaf_rn(s.w_anchor[p], fa, acc));
    if (has_out_alpha) va = leaky(va, out_alpha);
    ob[(size_t)p * hd + c] = from_float<OutT>(va);
#pragma unroll 4
    for (int r = p + 1; r < n; ++r) {  // sib rows: anchor and self
      float v = __fmaf_rn(s.w_self[r], fb[(size_t)r * ldp + c],
                          __fmaf_rn(s.w_anchor[r], fa, 0.f));
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
// valid rows of P are read: the pools never see the others. kCompact (the
// bf16 valid-rows form): P holds the valid rows alone, egonet b's from
// row_off[b] (grandparents, anchor, siblings), and an invalid slot's a1 /
// a2 are taken as 0 (its weights reach no pool).
template <bool kTrain, bool kCompact = false>
__global__ void __launch_bounds__(kThreads)
gat_pooled_star_kernel(const float* __restrict__ proj, int ldp,
                       const int* __restrict__ ngp_arr,
                       const int* __restrict__ nsib_arr,
                       float* __restrict__ pools, int n, int heads, int dh,
                       int p, float alpha, TrainArgs ta,
                       float* __restrict__ attn,
                       const int* __restrict__ row_off) {
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
  // the rows of the anchor and of sib slot r: r itself, or compacted
  const int pa = kCompact ? ngp : p, sib0 = kCompact ? ngp - p : 0;
  const float* pb =
      proj + (kCompact ? (size_t)row_off[b] : (size_t)b * n) * ldp;
  for (int c = threadIdx.x; c < 3 * dh; c += kThreads) acc[c] = 0.f;

  for (int h = 0; h < heads; ++h) {
    for (int r = threadIdx.x; r < n; r += kThreads) {
      if (kCompact) {
        const int q = valid_pos(r, ngp, nsib, p);
        s.a1[r] = q < 0 ? 0.f : pb[(size_t)q * ldp + hd + h];
        s.a2[r] = q < 0 ? 0.f : pb[(size_t)q * ldp + hd + heads + h];
      } else {
        s.a1[r] = pb[(size_t)r * ldp + hd + h];
        s.a2[r] = pb[(size_t)r * ldp + hd + heads + h];
      }
    }
    __syncthreads();
    float* stored =
        attn != nullptr ? attn + ((size_t)b * heads + h) * attn_row(n, p)
                        : nullptr;
    attention_weights<kTrain, false>(n, p, ngp, alpha, s, ta, b, h, stored);

    const float* fb = pb + (size_t)h * dh;
    for (int c = threadIdx.x; c < dh; c += kThreads) {
      const float fa = fb[(size_t)pa * ldp + c];
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
        ss += s.w_anchor[r] * fa +
              s.w_self[r] * fb[(size_t)(r + sib0) * ldp + c];
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

// The fused form's star weights: a block of 64 threads an (egonet, head),
// a thread a slot (n <= 64): a1 / a2 of the head from pass A's a12, the
// star softmax with the attention masks (star_weights_row; the stored
// weights written where attn is not null), then each row's (w_self,
// w_anchor, w_to_anchor, and at the anchor the egonet's valid gp count)
// into wts [b*n, heads] float4s for the product's star epilogue. The softmax is computed once per (egonet, head), as the
// two-pass form's star pass computes it.
__global__ void __launch_bounds__(64)
star_weights_kernel(const float* __restrict__ a12, int lda,
                    const int* __restrict__ ngp_arr, int n, int heads,
                    int p, float alpha, TrainArgs ta,
                    float* __restrict__ attn, float4* __restrict__ wts) {
  __shared__ float base[5 * 64];
  Smem s = {};
  s.a1 = base;
  s.a2 = base + 64;
  s.w_self = base + 128;
  s.w_anchor = base + 192;
  s.w_to_anchor = base + 256;
  const long long b = blockIdx.x / heads;
  const int h = blockIdx.x % heads, r = threadIdx.x;
  const size_t row = (size_t)b * n + r;
  if (r < n) {
    s.a1[r] = a12[row * lda + h];
    s.a2[r] = a12[row * lda + heads + h];
  }
  __syncthreads();
  if (r < n)
    star_weights_row<true, false>(
        r, n, p, min(max(ngp_arr[b], 0), p), alpha, s, ta, b, h,
        attn != nullptr ? attn + ((size_t)b * heads + h) * attn_row(n, p)
                        : nullptr);
  __syncthreads();  // the anchor's slot wrote w_to_anchor of every gp
  if (r < n)
    wts[row * heads + h] = make_float4(
        s.w_self[r], s.w_anchor[r], r < p ? s.w_to_anchor[r] : 0.f,
        r == p ? (float)min(max(ngp_arr[b], 0), p) : 0.f);
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

// The per-slot layer's fused form (n <= kFusedMaxSlots): stage and pack,
// pass A (a1 | a2), the star weights, pass B (the product with the star
// epilogue); pass marks before, between and after. The eval form takes a
// zeroed ta.
template <class E>
cudaError_t launch_fused(const E* x, const E* fc, const E* wa1, const E* wa2,
                         const float* bias_ft, const float* bias_a1,
                         const float* bias_a2, const int* ngp, E* out, int b,
                         int n, int din, int heads, int dh, int p,
                         float alpha, float out_alpha, int has_out_alpha,
                         const TrainArgs& ta, float* attn,
                         const FwdWorkT<E>& w, cudaStream_t st) {
  if (w.wa == nullptr || w.biasa == nullptr || w.a12 == nullptr ||
      w.wts == nullptr || n > kFusedMaxSlots ||
      (long long)b * heads > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const long long m = (long long)b * n;
  const int hd = heads * dh;
  // W's column blocks: ft's alone (c1 = c2 = wd = hd), and a1 | a2's
  const OperandT<E> opf = {
      x, {fc, fc, fc}, {ta.wp, ta.wp, ta.wp}, n, din, hd, hd, hd};
  const OperandT<E> opa = {x,     {wa1, wa1, wa2},
                           {ta.wpa1, ta.wpa1, ta.wpa2},
                           n,     din,
                           0,     heads,
                           2 * heads};
  // X staged with the first packing (xm set), W's two parts packed
  const ProductWorkT<E> work_f = {w.xm, nullptr, nullptr, w.kxp,
                                  w.wdp, 0, 1};
  const ProductWorkT<E> work_a = {nullptr, nullptr, nullptr, w.kxp,
                                  w.wap, 0, 1};
  mark(g_marks, st);
  cudaError_t err = stage_and_pack(opf, ta, m, work_f, 0, w.wcat, st);
  if (err != cudaSuccess) return err;
  err = stage_and_pack(opa, ta, m, work_a, 0, w.wa, st);
  if (err != cudaSuccess) return err;
  pack_bias_kernel<<<grid_for((long long)n * w.wdp), 256, 0, st>>>(
      bias_ft, bias_ft, bias_ft, n, hd, hd, hd, w.wdp, w.biascat);
  pack_bias_kernel<<<grid_for((long long)n * w.lda), 256, 0, st>>>(
      bias_a1, bias_a1, bias_a2, n, 0, heads, 2 * heads, w.lda, w.biasa);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mark(g_marks, st);

  // A. [a1 | a2] of every row (invalid sibling slots keep their formula
  // value, as in the TPU kernel); float32: W^T as hi / lo planes [2][wap]
  // [kxp] (gemm_tf32.cuh:pack_weights_kernel)
  constexpr bool kF32 = sizeof(E) == 4;
  GemmArgsT<E> g = {};
  g.a = w.xm != nullptr ? w.xm : x;
  g.lda = w.xm != nullptr ? w.kxp : din;
  g.b = w.wa;
  g.ldb = kF32 ? g.lda : w.wap;
  if (kF32) g.b_lo = w.wa + (long long)w.wap * g.lda;
  g.c = w.a12;
  g.ldc = w.lda;
  g.m = m;
  g.c_rows = m;
  g.n = 2 * heads;
  g.k = g.lda;
  g.k_chunk = g.lda;
  g.bias = w.biasa;
  g.bias_rows = n;
  err = product<true, kEpiRowBias, true>(g, TrainArgs{}, 1, st);
  if (err != cudaSuccess) return err;
  mark(g_marks, st);

  // the star softmax of every (egonet, head), with the attention masks;
  // the store form's weights written here, once
  float4* wts = reinterpret_cast<float4*>(w.wts);
  star_weights_kernel<<<(unsigned)((long long)b * heads), 64, 0, st>>>(
      w.a12, w.lda, ngp, n, heads, p, alpha, ta, attn, wts);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mark(g_marks, st);

  // B. ft and the star pass behind it
  g.b = w.wcat;
  g.ldb = kF32 ? g.lda : w.wdp;
  if (kF32) g.b_lo = w.wcat + (long long)w.wdp * g.lda;
  g.c = nullptr;
  g.ldc = w.wdp;  // the slot biases' row stride
  g.n = hd;
  g.bias = w.biascat;
  StarArgs sa = {wts, ngp, nullptr, b, n, p, heads, dh,
                 kFusedMaxSlots / n * n, out_alpha, has_out_alpha};
  if constexpr (kF32) {
    sa.out_f = out;
    err = product_wgmma_f32<true, kEpiStar, 128>(g, ta, 1, sa, st);
  } else {
    sa.out = out;
    err = product_wgmma<true, kEpiStar, 128>(g, ta, 1, sa, st);
  }
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
  if (w.wa != nullptr)  // the caller's workspaces name the form
    return launch_fused(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, out,
                        b, n, din, heads, dh, p, alpha, out_alpha,
                        has_out_alpha, ta, attn, w, st);
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

// 2. the pooled star pass over P [b*n, ldp] (kCompact: the valid rows, from
// row_off) into pools [b, 3, dh]
template <bool kTrain, bool kCompact = false>
cudaError_t pooled_star(const float* proj, int ldp, const int* ngp,
                        const int* nsib, float* pools, int b, int n,
                        int heads, int dh, int p, float alpha,
                        const TrainArgs& ta, float* attn, cudaStream_t st,
                        const int* row_off = nullptr) {
  if (b == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * (5 * (size_t)n + 3 * (size_t)dh);
  cudaError_t err = prepare(
      (const void*)gat_pooled_star_kernel<kTrain, kCompact>, smem);
  if (err != cudaSuccess) return err;
  gat_pooled_star_kernel<kTrain, kCompact><<<(unsigned)b, kThreads, smem,
                                             st>>>(
      proj, ldp, ngp, nsib, pools, n, heads, dh, p, alpha, ta, attn,
      row_off);
  return cudaGetLastError();
}

// The pooled layer's valid-rows form (eval and train forms): the valid
// rows counted and staged compacted, W packed; the projection over the R
// valid rows; the pooled star pass on them. Pass marks before, between and
// after.
template <bool kTrain, class E>
cudaError_t launch_pooled_rows(const OperandT<E>& op, const TrainArgs& ta,
                               const float* bias_ft, const float* bias_a1,
                               const float* bias_a2, const int* ngp,
                               const int* nsib, float* pools, int b, int n,
                               int heads, int dh, int p, float alpha,
                               float* attn, const FwdWorkT<E>& w,
                               cudaStream_t st) {
  const long long m = (long long)b * n;
  if (w.xm == nullptr || w.proj == nullptr || w.row_off == nullptr ||
      w.row_map == nullptr || attn != nullptr || m + kRowPad > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  mark(g_marks, st);
  valid_row_offsets_kernel<<<1, 1024, 0, st>>>(ngp, nsib, b, n, p,
                                               w.row_off);
  stage_valid_rows_kernel<E, E><<<grid_for((m + kRowPad) * 32), 256, 0, st>>>(
      op, ta, ngp, nsib, p, w.row_off, b, w.xm, w.kxp, w.row_map, nullptr,
      nullptr, nullptr, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const ProductWorkT<E> pack = {nullptr, nullptr, nullptr, w.kxp, w.wdp,
                                0,       1};  // X staged above
  err = stage_and_pack(op, ta, m, pack, 0, w.wcat, st);
  if (err != cudaSuccess) return err;
  mark(g_marks, st);
  err = gat_projection(op, w.xm, w.kxp, w.wcat, w.wdp, bias_ft, bias_a1,
                       bias_a2, w.biascat, w.proj, m, st, w.row_off + b,
                       w.row_map);
  if (err != cudaSuccess) return err;
  mark(g_marks, st);
  err = pooled_star<kTrain, true>(w.proj, w.wdp, ngp, nsib, pools, b, n,
                                  heads, dh, p, alpha, ta, nullptr, st,
                                  w.row_off);
  mark(g_marks, st);
  return err;
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
  const OperandT<E> op = layer_operand(x, fc, wa1, wa2, n, din, heads, dh, ta);
  if (w.row_off != nullptr)  // the caller's workspaces name the form
    return launch_pooled_rows<kTrain>(op, ta, bias_ft, bias_a1, bias_a2, ngp,
                                      nsib, pools, b, n, heads, dh, p, alpha,
                                      attn, w, st);
  cudaError_t err = project(op, ta, m, w, bias_ft, bias_a1, bias_a2, st);
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
// milliseconds into out[4] and returns their count: stage and pack, the
// projection, the star pass (two-pass form); stage and pack, pass A, the
// star weights, pass B with its star epilogue (the fused form); the valid
// rows counted,
// staged and W packed, the projection on them, the pooled star pass (the
// valid-rows form).
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
