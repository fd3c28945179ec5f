// Star-GAT layer backward kernels for Hopper (sm_90a), for float32 layers
// (gat_layer_bwd_f32) and bf16 layers (gat_layer_bwd_bf16).
//
// Replace the backward Pallas kernels of taxoexpan_tpu/ops/pallas_gat.py:
//   gat_layer_bwd (K2)        <- fused_gat_layer's VJP (_fused_bwd,
//                                _bwd_kernel, _bwd_head_core, _bwd_epilogue)
//   gat_layer_pooled_bwd (K4) <- fused_gat_layer_pooled's VJP
//                                (_fused_pooled_bwd, _bwd_pool_kernel)
// Both recompute ft and the attention from the layer input (ft is never
// stored) and replay the forward's dropout masks: the bits are a pure
// function of (seed, stream, row, column), gat_common.cuh. The stored form
// (a.attn not null, TAXOEXPAN_STORED_ATTN=1; pallas_gat.py:240, :567) reads
// the forward's softmax weights instead of recomputing the softmax; it still
// recomputes ft and a1/a2, which d(attention) and leaky' of the logits need
// (pallas_gat.py:482-490).
//
// Passes, one C entry point (gat_layer_bwd_f32) launching them in order
// (the products and sums of 0 and 2-4 are bwd_common.cuh's and
// gemm_tf32.cuh's, shared with gcn.cu):
//  0. the layer input X = [x*m | pe*m_pe] staged once (each mask bit hashed
//     once) where the layer has masks or a pe path, W packed for the
//     products; then the projection P = X @ [fc | wa1 | wa2; wp | wpa1 |
//     wpa2] + the slot biases over all B*N rows ([B*N, wdp], wdp = H*Dh +
//     2H rounded up to 4, zero in the padding columns) into the Dcat
//     workspace: the forward's own product (gat_fwd.cu), so a1/a2 and the
//     recomputed softmax are the forward's bits.
//  1. head core, one block per (egonet, head): a1/a2 from P and the softmax
//     once, then per 128-column tile of the head the ft tile (read from P),
//     the incoming grad tile (K2: g, chained through leaky'(pre) of the
//     recomputed pre-activation when the layer fuses out_alpha; K4: the
//     three pool rows broadcast over the VALID slots and scaled by
//     1/heads), the dft tile (the aggregation transposed) and the per-edge
//     d(attention) partial sums over the tile's columns. d(attention)
//     reduces over the head's whole Dh, so da1/da2 (softmax Jacobian, leaky'
//     of the logits, the closed-form scatter onto the star,
//     pallas_gat.py:459-504) follow the tile loop. Writes Dcat = [dft | da1
//     | da2] over P in place (each block reads its tile before it writes
//     the same columns; the padding columns stay P's zeros).
//  2. dW = X^T @ Dcat over all B*N rows, split-K on the tensor cores
//     (3xTF32), partial sums per split in a workspace, then a second pass
//     adds the splits in a fixed order and scatters the [din+pos, H*Dh+2H]
//     result into dfc, dwa1, dwa2 and the pe tail grads dwp, dwpa1, dwpa2.
//     Deterministic: no atomics.
//  3. slot-bias grads: Dcat summed over egonets (chunked partial sums, then
//     the same fixed-order reduction) into dbias_ft, dbias_a1, dbias_a2.
//  4. dx: (Dcat @ [fc | wa1 | wa2; wp | wpa1 | wpa2]^T) * mask on the
//     tensor cores, skipped for the x columns when need_dx = 0; the pe
//     columns always, masked and summed over egonets into dpe
//     (pallas_gat.py:662-677).
// Invalid slots are not skipped: every pass computes the TPU kernel's
// formula on all N rows, so their grads are whatever the formula gives
// (zero in K4, where the pool grads never reach them).
//
// What bounds it on an H100: the products. At the config.mag.json shapes
// the projection is the forward's x @ fc (2 * B*64 * 300 * 2008 flop for
// layer 0, 2 * B*64 * 2050 * 504 for the final layer), the dW product is as
// large again and dx (K4) once more; bytes (x, P and Dcat once each, dx)
// are a few GB. K2 and K4 run all three products on the tensor cores in
// 3xTF32 (gemm_tf32.cuh), one product a layer instead of one per (egonet,
// head, column tile); the head core reads P and writes Dcat, a pass bound
// by bytes, at three blocks an SM for both.
//
// The bf16 form (pallas_gat.py with x in bf16): x, fc, wa1, wa2, K2's
// incoming grad g and dx in bf16. Pass 0 stages X and packs W in bf16 and
// runs the forward's bf16 projection on them, so P, leaky' and the softmax
// have the forward's bits; the head core is unchanged (float32, g read as
// float); after the slot-bias sums (float32, over Dcat) Dcat is cast to
// bf16 once (pallas_gat.py:628-631) for the dW and dx products, bf16
// tensor-core MMAs with float32 accumulation (gemm_bf16.cuh); split-K dW
// partials float32 with the fixed-order reduce, then dfc, dwa1, dwa2
// rounded to bf16 (:1097, :1289), the pe rows' grads float32; dx times its
// float32 mask, rounded to bf16 (:647-651).

#include "bwd_common.cuh"

using gat::bf16;

// Mirrored field by field by gat_kernels._BwdArgs. E: the layer's element
// type.
template <class E>
struct BwdArgsT {
  const E* x;            // [b, n, din]
  const E* fc;           // [din, heads*dh]
  const E* wa1;          // [din, heads]
  const E* wa2;
  const float* bias_ft;  // [n, heads*dh]
  const float* bias_a1;  // [n, heads]
  const float* bias_a2;
  const int* ngp;        // [b]
  const int* nsib;
  const void* g;         // K2 [b, n, heads*dh] (E); K4 [b, 3, dh] (float)
  const float* attn;     // stored softmax [b, heads, 2n - p - 1], or null
  float* dcat;           // workspace [b*n, wdp], wdp = heads*dh + 2*heads
                         // rounded up to a 16-byte multiple of E: the
                         // projection P, then Dcat over it
  float* part_w;         // workspace [splits, din+pos, wd]
  float* part_b;         // workspace [chunks, n, wdp] (need_dbias)
  float* pe_rows;        // workspace [b*n, pos] (pos > 0)
  float* part_pe;        // workspace [chunks, n, pos] (pos > 0)
  E* dx;                 // [b, n, din] (need_dx)
  E* dfc;                // [din, heads*dh]
  E* dwa1;               // [din, heads]
  E* dwa2;
  float* dbias_ft;       // [n, heads*dh] (need_dbias)
  float* dbias_a1;       // [n, heads]
  float* dbias_a2;
  float* dpe;            // [n, pos] (pos > 0)
  float* dwp;            // [pos, heads*dh]
  float* dwpa1;          // [pos, heads]
  float* dwpa2;
  E* xm;                 // workspace [b*n, kxp]: X staged, or null (read x)
  E* wcat;               // workspace [kxp, wdp]: W for the projection
  E* wt;                 // workspace [wdp, ntp]: W^T for the dx product
  float* biascat;        // workspace [n, wdp]: the slot biases
  E* dcat16;             // workspace [b*n, wdp]: Dcat in bf16 (bf16 only)
  int b, n, din, heads, dh, p;
  int pooled, need_dx, need_dbias, has_out_alpha, splits, chunks;
  int kxp, wdp, ntp;     // widths of the workspaces (16-byte multiples)
  float alpha, out_alpha;
};

namespace {

using namespace gat;

PassMarks g_marks;


__device__ __forceinline__ float dleaky(float pre, float g, float a) {
  return pre >= 0.f ? g : a * g;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------- 1. head core
// The head core's shared memory: the ft and grad tiles, a1 / a2, the
// softmax weights, masks and d(weights) of the star, no product staging,
// so that three blocks fit an SM.
__host__ __device__ inline size_t head_floats(int n) {
  return 2 * (size_t)n * kTileCols + 17 * (size_t)n;
}

__device__ __forceinline__ Smem carve_head(float* base, int n) {
  Smem s = {};
  s.ft = base;
  s.g = s.ft + (size_t)n * kTileCols;
  float* next = s.g + (size_t)n * kTileCols;
  float** arrays[] = {&s.a1,      &s.a2,           &s.w_self,
                      &s.w_anchor, &s.w_to_anchor, &s.sm_self,
                      &s.sm_anchor, &s.sm_to_anchor, &s.m_self,
                      &s.m_anchor, &s.m_to_anchor, &s.d_self,
                      &s.d_anchor, &s.d_to_anchor, &s.dz,
                      &s.da1,      &s.da2};
  for (float** q : arrays) {
    *q = next;
    next += n;
  }
  return s;
}

// K2 (kPooled = false) and K4 differ only in the incoming grad tile (K2's
// in the layer's element type E, K4's pool grads float).
template <bool kPooled, class E>
__global__ void __launch_bounds__(kThreads, 3)
gat_bwd_head_kernel(BwdArgsT<E> a, TrainArgs ta) {
  extern __shared__ float4 smem4[];
  const int n = a.n, p = a.p, heads = a.heads, dh = a.dh;
  const Smem s = carve_head(reinterpret_cast<float*>(smem4), n);
  const long long b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int hd = heads * dh, ldd = a.wdp;
  const int ngp = min(max(a.ngp[b], 0), p);
  const int nsib = min(max(a.nsib[b], 0), n - p - 1);
  const int ntiles = (dh + kTileCols - 1) / kTileCols;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float inv_h = 1.f / heads;
  float* drow = a.dcat + (size_t)b * n * ldd;
  const float* gpool = static_cast<const float*>(a.g);
  const E* gslot = static_cast<const E*>(a.g);

  for (int r = tid; r < n; r += kThreads) {  // a1 / a2 of the head from P
    s.d_self[r] = s.d_anchor[r] = s.d_to_anchor[r] = 0.f;
    s.a1[r] = drow[(size_t)r * ldd + hd + h];
    s.a2[r] = drow[(size_t)r * ldd + hd + heads + h];
  }

  for (int t = 0; t < ntiles; ++t) {
    const int c0 = t * kTileCols;
    const int ncols = min(kTileCols, dh - c0);
    const int col0 = h * dh + c0;
    // the ft tile from P (bias included) and the incoming grad tile: K2's
    // g; K4's three pool rows over the valid slots, times 1/heads
#pragma unroll 4
    for (int e = tid; e < n * kTileCols; e += kThreads) {
      const int r = e / kTileCols, c = e % kTileCols;
      const bool in = c < ncols;
      s.ft[e] = in ? drow[(size_t)r * ldd + col0 + c] : 0.f;
      float gv = 0.f;
      if (kPooled) {
        const bool valid = r < p ? r < ngp : (r == p || r - p - 1 < nsib);
        const int cls = r < p ? 0 : (r == p ? 1 : 2);
        if (in && valid)
          gv = gpool[((size_t)b * 3 + cls) * dh + c0 + c] * inv_h;
      } else if (in) {
        gv = to_float(gslot[((size_t)b * n + r) * hd + col0 + c]);
      }
      s.g[e] = gv;
    }
    __syncthreads();
    if (t == 0) {
      if (a.attn != nullptr)
        attention_weights<true, true, true>(
            n, p, ngp, a.alpha, s, ta, b, h,
            const_cast<float*>(a.attn) +
                ((size_t)b * heads + h) * attn_row(n, p));
      else
        attention_weights<true, true>(n, p, ngp, a.alpha, s, ta, b, h);
    }
    const float* fa = s.ft + p * kTileCols;

    // K2: the grad through leaky'(pre) of the fused activation
    for (int e = tid; e < n * kTileCols; e += kThreads) {
      const int r = e / kTileCols, c = e % kTileCols;
      if (!kPooled && a.has_out_alpha && c < ncols) {
        float pre;
        if (r < p) {
          pre = s.w_self[r] * s.ft[r * kTileCols + c];
        } else if (r > p) {
          pre = s.w_anchor[r] * fa[c] + s.w_self[r] * s.ft[r * kTileCols + c];
        } else {
          float acc = 0.f;
          for (int j = 0; j < ngp; ++j)
            acc += s.w_to_anchor[j] * s.ft[j * kTileCols + c];
          pre = acc + s.w_self[p] * fa[c];
        }
        if (!(pre >= 0.f)) s.g[e] *= a.out_alpha;
      }
    }
    __syncthreads();

    // dft = the aggregation transposed
    const float* ga = s.g + p * kTileCols;
#pragma unroll 4
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
      drow[(size_t)r * ldd + col0 + c] = v;
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
    drow[(size_t)r * ldd + hd + h] = s.da1[r];
    drow[(size_t)r * ldd + hd + heads + h] = s.da2[r];
  }
}

// All passes of the backward (K2, or K4 with a.pooled) in order on st.
template <class E>
cudaError_t launch_bwd(const BwdArgsT<E>& a, const TrainArgs& ta,
                       cudaStream_t st) {
  const long long m = (long long)a.b * a.n;
  if (m == 0) return cudaSuccess;
  const int hd = a.heads * a.dh, wd = hd + 2 * a.heads;
  const OperandT<E> op = {a.x,   {a.fc, a.wa1, a.wa2},
                          {ta.wp, ta.wpa1, ta.wpa2},
                          a.n,   a.din,
                          hd,    hd + a.heads,
                          wd};
  const ProductWorkT<E> work = {a.xm,  a.wt,  a.part_w, a.kxp,
                                a.wdp, a.ntp, a.splits};
  cudaError_t err;

  mark(g_marks, st);
  err = stage_and_pack(op, ta, m, work, a.need_dx ? 0 : a.din, a.wcat, st);
  if (err != cudaSuccess) return err;
  mark(g_marks, st);
  // 0. the projection into the Dcat workspace
  err = gat_projection(op, a.xm, a.kxp, a.wcat, a.wdp, a.bias_ft, a.bias_a1,
                       a.bias_a2, a.biascat, a.dcat, m, st);
  if (err != cudaSuccess) return err;
  mark(g_marks, st);

  const size_t smem = sizeof(float) * head_floats(a.n);
  const void* head = a.pooled ? (const void*)gat_bwd_head_kernel<true, E>
                              : (const void*)gat_bwd_head_kernel<false, E>;
  err = prepare(head, smem);
  if (err != cudaSuccess) return err;
  const long long head_blocks = (long long)a.b * a.heads;
  if (head_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (a.pooled)
    gat_bwd_head_kernel<true, E>
        <<<(unsigned)head_blocks, kThreads, smem, st>>>(a, ta);
  else
    gat_bwd_head_kernel<false, E>
        <<<(unsigned)head_blocks, kThreads, smem, st>>>(a, ta);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mark(g_marks, st);

  if (a.need_dbias) {
    const long long rw = (long long)a.n * a.wdp;
    const long long chunk_b = (a.b + a.chunks - 1) / a.chunks;
    colsum_partial_kernel<<<dim3(blocks_for(rw), a.chunks), kThreads, 0,
                            st>>>(a.dcat, a.b, rw, chunk_b, a.part_b);
    reduce_scatter_kernel<float><<<blocks_for(rw), kThreads, 0, st>>>(
        a.part_b, a.chunks, a.n, a.wdp, a.n, hd, hd + a.heads, wd,
        a.dbias_ft, a.dbias_a1, a.dbias_a2, nullptr, nullptr, nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // the products' D: Dcat itself, or in a bf16 layer Dcat cast to bf16
  const E* d;
  if constexpr (sizeof(E) == 2) {
    cast_bf16_kernel<<<grid_for(m * a.wdp / 4), 256, 0, st>>>(
        a.dcat, a.dcat16, m * a.wdp);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    d = a.dcat16;
  } else {
    d = a.dcat;
  }
  mark(g_marks, st);

  E* const dw[3] = {a.dfc, a.dwa1, a.dwa2};
  float* const dwp[3] = {a.dwp, a.dwpa1, a.dwpa2};
  return product_grads(op, ta, d, a.wdp, m, work, a.chunks, dw, dwp,
                       a.need_dx, a.dx, a.pe_rows, a.part_pe, a.dpe, g_marks,
                       st);
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
int gat_layer_bwd_f32(const BwdArgsT<float>* ap, const TrainArgs* tap,
                      void* stream) {
  return launch_bwd(*ap, *tap, (cudaStream_t)stream);
}

// The bf16 form: *ap with the bf16 fields of BwdArgsT<bf16> (x, fc, wa1,
// wa2, K2's g, dx, dfc, dwa1, dwa2, the workspaces xm, wcat, wt and
// dcat16), every other field as in the float32 form.
int gat_layer_bwd_bf16(const BwdArgsT<bf16>* ap, const TrainArgs* tap,
                       void* stream) {
  return launch_bwd(*ap, *tap, (cudaStream_t)stream);
}

// Pass timing: with `on`, the next gat_layer_bwd_f32 records device events
// between its passes; gat_bwd_pass_ms then gives their milliseconds (stage
// and pack, projection, head core, slot-bias sums (with the cast of Dcat
// to bf16 in the bf16 form), dW, dx) into out[6] and returns their count.
int gat_bwd_set_timing(int on) { return set_timing(g_marks, on); }

int gat_bwd_pass_ms(float* out) { return pass_ms(g_marks, out); }

}  // extern "C"
