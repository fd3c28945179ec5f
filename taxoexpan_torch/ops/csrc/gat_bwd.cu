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
// (the products and sums of 0 and 2-4 are bwd_common.cuh's, on
// gemm_wgmma.cuh's 3xTF32 ring, shared with gcn.cu):
//  0. the layer input X = [x*m | pe*m_pe] staged once (each mask bit hashed
//     once) where the layer has masks or a pe path, W packed for the
//     products (W^T and W's rows as TF32 hi / lo planes); then the
//     projection P = X @ [fc | wa1 | wa2; wp | wpa1 | wpa2] + the slot
//     biases ([rows, wdp], wdp = H*Dh + 2H rounded up to 4, zero in the
//     padding columns) into the Dcat workspace: the forward's own product
//     (gat_fwd.cu), so a1/a2 and the recomputed softmax are the forward's
//     bits. K2 runs it over all B*N rows; K4 over the valid rows alone, as
//     K4 bf16 (below): valid_row_offsets_kernel counts and scans them on
//     the card, stage_valid_rows_kernel stages them compacted with a row
//     map (R of B*N, about half in the smoke's batch), zeroes dx and the
//     pe-row grads of the invalid rows (the pool grads never reach them)
//     and Dcat's kRowPad rows after the valid ones; no host sync.
//  1. head core, one block per (egonet, head): a1/a2 from P and the softmax
//     once, then per 128-column tile of the head the ft tile (read from P),
//     the incoming grad tile (K2: g, chained through leaky'(pre) of the
//     recomputed pre-activation when the layer fuses out_alpha; K4: the
//     three pool rows broadcast over the VALID slots and scaled by
//     1/heads), the dft tile (the aggregation transposed) and the per-edge
//     d(attention) partial sums over the tile's columns, 4 columns a
//     thread where the head's width allows. d(attention) reduces over the
//     head's whole Dh, so da1/da2 (softmax Jacobian, leaky' of the
//     logits, the closed-form scatter onto the star, pallas_gat.py:
//     459-504) follow the tile loop. Writes Dcat = [dft | da1 | da2] over P
//     in place (each block reads its tile before it writes the same
//     columns; the padding columns stay P's zeros). K4 walks a chunk of
//     egonets a block and adds D into per-chunk slot-bias partial sums
//     (Dcat holds compacted rows, which no sum over egonets can read).
//  2. dW = X^T @ Dcat over the rows, split-K by rows on the tensor cores:
//     the narrower of X and Dcat transposed into TF32 hi / lo planes
//     (bwd_common.cuh:transpose_split_kernel), the other read M-major;
//     partial sums per split in a workspace, then a second pass adds the
//     splits in a fixed order and scatters the [din+pos, H*Dh+2H] result
//     into dfc, dwa1, dwa2 and the pe tail grads dwp, dwpa1, dwpa2.
//     Deterministic: no atomics.
//  3. slot-bias grads: K2 sums Dcat over egonets (chunked partial sums,
//     then the same fixed-order reduction), K4 reduces its head core's
//     partials, into dbias_ft, dbias_a1, dbias_a2.
//  4. dx: (Dcat @ [fc | wa1 | wa2; wp | wpa1 | wpa2]^T) * mask on the
//     tensor cores, skipped for the x columns when need_dx = 0; the pe
//     columns always, masked and summed over egonets into dpe
//     (pallas_gat.py:662-677); K4's rows scattered through the row map.
// K2 computes every row: its invalid slots' grads are whatever the TPU
// kernel's formula gives there, and the plain version gives the same.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3 at 700 W, config.mag.
// json at B = 4096, N = 64, chip_smoke.py's `passes_ms` and `products`):
// the products, at 97-132 TFLOP/s float32-equivalent (gemm_wgmma.cuh says
// what bounds them): K2 (250 + 50 -> 4 x 500, 315.8 GFLOP a product) 3.25
// ms projection, 3.14 dW, 0.84 dx (the pe columns), and its head core,
// 3.06 ms for 6.3 GB (P and g read, Dcat written: 61 % of 3.35 TB/s);
// K4 (2000 + 50 -> 1 x 500 on R = 132,501 rows, 273 GFLOP a product)
// 2.09 projection, 2.54 dW, 3.18 dx, its staging of the valid rows 1.37
// (x read, X written, the invalid rows' dx zeroed: 3.2 GB).
//
// The bf16 form (pallas_gat.py with x in bf16; _bwd_kernel :507 and
// _bwd_pool_kernel :680, their _bwd_head_core :442 and _bwd_epilogue
// :607): x, fc, wa1, wa2, K2's incoming grad g and dx in bf16. Its passes
// and what bounds each on an H100:
//  0. X staged and W packed in bf16, then the forward's bf16 projection
//     (gemm_wgmma.cuh: TMA-fed, warp-specialised wgmma), so P, leaky' and
//     the softmax have the forward's bits. K4 (pooled) works on the valid
//     rows alone: valid_row_offsets_kernel counts each egonet's valid
//     slots (0..ngp, the anchor, p+1..p+nsib) and scans them on the card,
//     stage_valid_rows_kernel stages those rows compacted (R of B*N, about
//     half in the smoke's batch) with a row map, zeroes dx and the pe-row
//     grads of the invalid rows (the pool grads never reach them,
//     gat_kernels._star_plain), and the products read R from the card: no
//     host sync. Bound by bytes (x read, X written) and, for the
//     projection, by P's float32 bytes (2.1 GB at config.mag.json's layer
//     0) more than by its operations.
//  1. the head core as above, in float32 from P; it writes D once, in
//     bf16, for the products (the reference casts once, pallas_gat.py:
//     626-631), and with need_dbias adds D's float32 values into per-chunk
//     slot-bias partial sums (a block walks a chunk of egonets for its
//     head), as the reference sums its float32 buffers (:658-660): float32
//     D never reaches device memory. Bound by bytes: P read (the head's
//     columns), g read, D written in bf16.
//  2. the slot-bias sums: the fixed-order reduction of those partials.
//  3. dW = X^T @ D (bf16 wgmma, float32 split-K partials, the fixed-order
//     reduce; dfc, dwa1, dwa2 rounded to bf16, :1097, :1289; the pe rows'
//     grads float32) and 4. dx = (D @ W^T) * mask (the float32 mask, then
//     bf16, :647-651; the pe columns float32, summed over egonets into
//     dpe): bound by the tensor cores.

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
  float* dcat;           // workspace [b*n (K4: + kRowPad), wdp], wdp =
                         // heads*dh + 2*heads rounded up to a 16-byte
                         // multiple of E: the projection P, then
                         // (float32) Dcat over it
  float* part_w;         // workspace [splits, din+pos, wd]
  float* part_b;         // workspace [chunks, n, wdp] (need_dbias): the
                         // slot-bias partial sums
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
  E* xm;                 // workspace [b*n (+ kRowPad), kxp]: X staged (K4:
                         // the valid rows, compacted), or null
  E* wcat;               // workspace: W for the projection, [kxp, wdp]
                         // (float32: W^T planes [2, wdp, kxp])
  E* wt;                 // workspace: W^T for the dx product, [wdp, ntp]
                         // (float32: W's rows, planes [2, ntp, wdp])
  float* biascat;        // workspace [n, wdp]: the slot biases
  bf16* d16;             // bf16 only: workspace [b*n (+ kRowPad), wdp],
                         // D = [dft | da1 | da2] in bf16 for the products
  int* row_off;          // K4 only, else null: workspace [b + 1], the
                         // egonets' first valid rows; [b] = R
  int* row_map;          // K4 only: workspace [b*n + kRowPad], the
                         // original row of each valid row
  float* bt;             // float32 only: workspace, the dW product's B
                         // planes (bwd_common.cuh:dw_operands)
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
// The head core's shared memory: the rows of the slots, the ft and grad
// tiles, a1 / a2, the softmax weights, masks and d(weights) of the star,
// no product staging, so that three blocks fit an SM.
__host__ __device__ inline size_t head_floats(int n) {
  return 2 * (size_t)n * kTileCols + 17 * (size_t)n;
}

// K4 bf16's row of each slot before them: n long longs, a 16-byte
// multiple so that the tiles stay 16-byte aligned.
__host__ __device__ inline size_t row_floats(int n) {
  return 2 * (size_t)((n + 1) / 2 * 2);
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

// One (egonet b, head h) of the head core. K2 (kPooled = false) and K4
// differ only in the incoming grad tile (K2's in the layer's element type
// E, K4's pool grads float). The float32 form writes D over P in place;
// the bf16 form (kD16) writes D once, in bf16, to a.d16 and, with
// need_dbias (kPart), adds its float32 values into the block's slot-bias
// partial sums `part` [n, wdp] (= on the block's first egonet). With
// kCompact (K4 bf16) P and D hold the valid rows alone, compacted: `rows`
// (shared memory) gives each slot's row or -1, and ft, a1, a2 are taken
// as 0 at an invalid slot, where the pool grads are 0 (the reference's
// gp_mask / sib_mask, gat_kernels._star_plain): D is then exactly 0
// there, as uncompacted.
template <bool kPooled, class E, bool kPart, bool kCompact>
__device__ __forceinline__ void head_egonet(const BwdArgsT<E>& a,
                                            const TrainArgs& ta,
                                            const Smem& s, long long* rows,
                                            long long b, int h,
                                            [[maybe_unused]] bool first,
                                            [[maybe_unused]] float* part) {
  constexpr bool kD16 = sizeof(E) == 2;
  const int n = a.n, p = a.p, heads = a.heads, dh = a.dh;
  const int hd = heads * dh, ldd = a.wdp, wd = hd + 2 * heads;
  const int ntiles = (dh + kTileCols - 1) / kTileCols;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float inv_h = 1.f / heads;
  const float* gpool = static_cast<const float*>(a.g);
  const E* gslot = static_cast<const E*>(a.g);
  const int ngp = min(max(a.ngp[b], 0), p);
  const int nsib = min(max(a.nsib[b], 0), n - p - 1);
  if constexpr (kCompact) {
    const long long ob = a.row_off[b];
    for (int r = tid; r < n; r += kThreads) {
      const int q = valid_pos(r, ngp, nsib, p);
      rows[r] = q < 0 ? -1 : ob + q;
    }
    __syncthreads();
  }
  const float* drow = a.dcat + (size_t)b * n * ldd;

  for (int r = tid; r < n; r += kThreads) {  // a1 / a2 of the head from P
    s.d_self[r] = s.d_anchor[r] = s.d_to_anchor[r] = 0.f;
    if constexpr (kCompact) {
      const long long pr = rows[r];
      s.a1[r] = pr >= 0 ? a.dcat[(size_t)pr * ldd + hd + h] : 0.f;
      s.a2[r] = pr >= 0 ? a.dcat[(size_t)pr * ldd + hd + heads + h] : 0.f;
    } else {
      s.a1[r] = drow[(size_t)r * ldd + hd + h];
      s.a2[r] = drow[(size_t)r * ldd + hd + heads + h];
    }
  }
  for (int t = 0; t < ntiles; ++t) {
    const int c0 = t * kTileCols;
    const int ncols = min(kTileCols, dh - c0);
    const int col0 = h * dh + c0;
    // the ft tile from P (bias included) and the incoming grad tile: K2's
    // g; K4's three pool rows over the valid slots, times 1/heads (4
    // columns a thread where the head's width allows)
    if (dh % 4 == 0) {
#pragma unroll 2
      for (int e = tid; e < n * (kTileCols / 4); e += kThreads) {
        const int r = e / (kTileCols / 4), c = 4 * (e % (kTileCols / 4));
        float4 f = make_float4(0.f, 0.f, 0.f, 0.f), gv = f;
        if (c < ncols) {
          const long long pr = kCompact ? rows[r] : b * n + r;
          if (pr >= 0)
            f = *reinterpret_cast<const float4*>(
                a.dcat + (size_t)pr * ldd + col0 + c);
          if (kPooled) {
            const bool valid =
                r < p ? r < ngp : (r == p || r - p - 1 < nsib);
            const int cls = r < p ? 0 : (r == p ? 1 : 2);
            if (valid) {
              gv = *reinterpret_cast<const float4*>(
                  gpool + ((size_t)b * 3 + cls) * dh + c0 + c);
              gv.x *= inv_h, gv.y *= inv_h, gv.z *= inv_h, gv.w *= inv_h;
            }
          } else if constexpr (kD16) {
            const uint2 u = *reinterpret_cast<const uint2*>(
                gslot + ((size_t)b * n + r) * hd + col0 + c);
            const float2 lo = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&u.x));
            const float2 hi = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&u.y));
            gv = make_float4(lo.x, lo.y, hi.x, hi.y);
          } else {
            gv = *reinterpret_cast<const float4*>(
                gslot + ((size_t)b * n + r) * hd + col0 + c);
          }
        }
        *reinterpret_cast<float4*>(s.ft + r * kTileCols + c) = f;
        *reinterpret_cast<float4*>(s.g + r * kTileCols + c) = gv;
      }
    } else {
#pragma unroll 4
    for (int e = tid; e < n * kTileCols; e += kThreads) {
      const int r = e / kTileCols, c = e % kTileCols;
      const bool in = c < ncols;
      if constexpr (kCompact) {
        const long long pr = rows[r];
        s.ft[e] = in && pr >= 0 ? a.dcat[(size_t)pr * ldd + col0 + c] : 0.f;
      } else {
        s.ft[e] = in ? drow[(size_t)r * ldd + col0 + c] : 0.f;
      }
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

    // K2: the grad through leaky'(pre) of the fused activation (4 columns
    // a thread where the head's width allows)
    const bool quad = dh % 4 == 0;
    if (!kPooled && a.has_out_alpha && quad) {
      for (int e = tid; e < n * (kTileCols / 4); e += kThreads) {
        const int r = e / (kTileCols / 4), c = 4 * (e % (kTileCols / 4));
        if (c >= ncols) continue;
        const float4 f = *reinterpret_cast<const float4*>(
            s.ft + r * kTileCols + c);
        const float4 fa4 = *reinterpret_cast<const float4*>(fa + c);
        float pre[4];
        if (r < p) {
          const float w = s.w_self[r];
          pre[0] = w * f.x, pre[1] = w * f.y, pre[2] = w * f.z,
          pre[3] = w * f.w;
        } else if (r > p) {
          const float wa = s.w_anchor[r], w = s.w_self[r];
          pre[0] = wa * fa4.x + w * f.x, pre[1] = wa * fa4.y + w * f.y;
          pre[2] = wa * fa4.z + w * f.z, pre[3] = wa * fa4.w + w * f.w;
        } else {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          for (int j = 0; j < ngp; ++j) {
            const float wj = s.w_to_anchor[j];
            const float4 fj = *reinterpret_cast<const float4*>(
                s.ft + j * kTileCols + c);
            acc[0] += wj * fj.x, acc[1] += wj * fj.y;
            acc[2] += wj * fj.z, acc[3] += wj * fj.w;
          }
          const float w = s.w_self[p];
          pre[0] = acc[0] + w * fa4.x, pre[1] = acc[1] + w * fa4.y;
          pre[2] = acc[2] + w * fa4.z, pre[3] = acc[3] + w * fa4.w;
        }
        float4* gp = reinterpret_cast<float4*>(s.g + r * kTileCols + c);
        float4 gv = *gp;
        if (!(pre[0] >= 0.f)) gv.x *= a.out_alpha;
        if (!(pre[1] >= 0.f)) gv.y *= a.out_alpha;
        if (!(pre[2] >= 0.f)) gv.z *= a.out_alpha;
        if (!(pre[3] >= 0.f)) gv.w *= a.out_alpha;
        *gp = gv;
      }
    }
    for (int e = tid; e < n * kTileCols; e += kThreads) {
      const int r = e / kTileCols, c = e % kTileCols;
      if (!kPooled && a.has_out_alpha && !quad && c < ncols) {
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
    if (quad) {
      // four columns a thread, D written 8 bytes (bf16) or 16 bytes
      // (float32, over P in place) at a time
      for (int e = tid; e < n * (kTileCols / 4); e += kThreads) {
        const int r = e / (kTileCols / 4), c = 4 * (e % (kTileCols / 4));
        if (c >= ncols) continue;
        const float4 gr = *reinterpret_cast<const float4*>(
            s.g + r * kTileCols + c);
        const float4 ga4 = *reinterpret_cast<const float4*>(ga + c);
        float v[4];
        if (r < p) {
          const float w = s.w_self[r], wt = s.w_to_anchor[r];
          v[0] = w * gr.x + wt * ga4.x, v[1] = w * gr.y + wt * ga4.y;
          v[2] = w * gr.z + wt * ga4.z, v[3] = w * gr.w + wt * ga4.w;
        } else if (r == p) {
          const float w = s.w_self[p];
          v[0] = w * ga4.x, v[1] = w * ga4.y, v[2] = w * ga4.z,
          v[3] = w * ga4.w;
          for (int i = p + 1; i < n; ++i) {
            const float wi = s.w_anchor[i];
            const float4 gi = *reinterpret_cast<const float4*>(
                s.g + i * kTileCols + c);
            v[0] += wi * gi.x, v[1] += wi * gi.y;
            v[2] += wi * gi.z, v[3] += wi * gi.w;
          }
        } else {
          const float w = s.w_self[r];
          v[0] = w * gr.x, v[1] = w * gr.y, v[2] = w * gr.z,
          v[3] = w * gr.w;
        }
        const long long pr = kCompact ? rows[r] : b * n + r;
        if (pr >= 0) {
          if constexpr (kD16) {
            __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
            __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
            uint2 pack;
            pack.x = *reinterpret_cast<unsigned*>(&lo);
            pack.y = *reinterpret_cast<unsigned*>(&hi);
            *reinterpret_cast<uint2*>(a.d16 + (size_t)pr * ldd + col0 + c) =
                pack;
          } else {
            *reinterpret_cast<float4*>(a.dcat + (size_t)pr * ldd + col0 +
                                       c) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
          }
        }
        if constexpr (kPart) {
          float* q = part + (size_t)r * ldd + col0 + c;
#pragma unroll
          for (int u = 0; u < 4; ++u) q[u] = first ? v[u] : q[u] + v[u];
        }
      }
    } else if constexpr (kD16) {
      // two columns a thread: D written as bf16 pairs where aligned
#pragma unroll 2
      for (int e = tid; e < n * (kTileCols / 2); e += kThreads) {
        const int r = e / (kTileCols / 2), c = 2 * (e % (kTileCols / 2));
        if (c >= ncols) continue;
        const float2 gr = *reinterpret_cast<const float2*>(
            s.g + r * kTileCols + c);
        float v0, v1;
        if (r < p) {
          v0 = s.w_self[r] * gr.x + s.w_to_anchor[r] * ga[c];
          v1 = s.w_self[r] * gr.y + s.w_to_anchor[r] * ga[c + 1];
        } else if (r == p) {
          v0 = s.w_self[p] * ga[c];
          v1 = s.w_self[p] * ga[c + 1];
          for (int i = p + 1; i < n; ++i) {
            const float2 gi = *reinterpret_cast<const float2*>(
                s.g + i * kTileCols + c);
            v0 += s.w_anchor[i] * gi.x;
            v1 += s.w_anchor[i] * gi.y;
          }
        } else {
          v0 = s.w_self[r] * gr.x;
          v1 = s.w_self[r] * gr.y;
        }
        const bool two = c + 1 < ncols;
        const long long pr = kCompact ? rows[r] : b * n + r;
        if (pr >= 0) {
          const size_t at = (size_t)pr * ldd + col0 + c;
          if (two && at % 2 == 0) {
            *reinterpret_cast<__nv_bfloat162*>(a.d16 + at) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            a.d16[at] = from_float<bf16>(v0);
            if (two) a.d16[at + 1] = from_float<bf16>(v1);
          }
        }
        if constexpr (kPart) {
          float* q = part + (size_t)r * ldd + col0 + c;
          q[0] = first ? v0 : q[0] + v0;
          if (two) q[1] = first ? v1 : q[1] + v1;
        }
      }
    } else {
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
        const long long pr = kCompact ? rows[r] : b * n + r;
        if (pr >= 0) a.dcat[(size_t)pr * ldd + col0 + c] = v;
        if constexpr (kPart) {
          float* q = part + (size_t)r * ldd + col0 + c;
          *q = first ? v : *q + v;
        }
      }
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
    if constexpr (kD16) {
      const long long pr = kCompact ? rows[r] : b * n + r;
      if (pr >= 0) {
        bf16* drow16 = a.d16 + (size_t)pr * ldd;
        drow16[hd + h] = from_float<bf16>(s.da1[r]);
        drow16[hd + heads + h] = from_float<bf16>(s.da2[r]);
        if (h == 0)  // D's padding columns, zero for the dx product
          for (int col = wd; col < ldd; ++col)
            drow16[col] = from_float<bf16>(0.f);
      }
      if constexpr (kPart) {
        float* q = part + (size_t)r * ldd;
        q[hd + h] = first ? s.da1[r] : q[hd + h] + s.da1[r];
        q[hd + heads + h] =
            first ? s.da2[r] : q[hd + heads + h] + s.da2[r];
      }
    } else {
      const long long pr = kCompact ? rows[r] : b * n + r;
      if (pr >= 0) {
        a.dcat[(size_t)pr * ldd + hd + h] = s.da1[r];
        a.dcat[(size_t)pr * ldd + hd + heads + h] = s.da2[r];
      }
      if constexpr (kPart) {
        float* q = part + (size_t)r * ldd;
        q[hd + h] = first ? s.da1[r] : q[hd + h] + s.da1[r];
        q[hd + heads + h] =
            first ? s.da2[r] : q[hd + heads + h] + s.da2[r];
      }
    }
  }
}

// The head core: a block an (egonet, head), or with the slot-bias partial
// sums (kPart) a (chunk of egonets, head) walking its chunk in order, its
// partials part_b[chunk] [n, wdp] owned by it alone (a fixed order, no
// atomics).
template <bool kPooled, class E, bool kPart = false, bool kCompact = false>
__global__ void __launch_bounds__(kThreads, 3)
gat_bwd_head_kernel(BwdArgsT<E> a, TrainArgs ta) {
  extern __shared__ float4 smem4[];
  const int n = a.n, heads = a.heads, dh = a.dh;
  // kCompact: P's (and D's) row of each slot, or -1 (an invalid slot)
  long long* rows = reinterpret_cast<long long*>(smem4);
  const Smem s = carve_head(
      reinterpret_cast<float*>(smem4) + (kCompact ? row_floats(n) : 0), n);
  const long long grp = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  if constexpr (!kPart) {
    head_egonet<kPooled, E, false, kCompact>(a, ta, s, rows, grp, h, true,
                                              nullptr);
  } else {
    const int hd = heads * dh, ldd = a.wdp;
    const long long chunk_b = (a.b + a.chunks - 1) / a.chunks;
    const long long b_beg = grp * chunk_b;
    const long long b_end = min((long long)a.b, b_beg + chunk_b);
    float* part = a.part_b + (size_t)grp * n * ldd;
    if (b_beg >= b_end) {  // an empty chunk: zero partials
      for (int e = threadIdx.x; e < n * (dh + 2); e += kThreads) {
        const int r = e / (dh + 2), c = e % (dh + 2);
        const int col = c < dh ? h * dh + c : hd + (c - dh) * heads + h;
        part[(size_t)r * ldd + col] = 0.f;
      }
      return;
    }
    for (long long b = b_beg; b < b_end; ++b) {
      head_egonet<kPooled, E, true, kCompact>(a, ta, s, rows, b, h,
                                               b == b_beg, part);
      __syncthreads();  // the next egonet reuses shared memory
    }
  }
}

// All passes of the backward (K2, or K4 with a.pooled) in order on st.
template <class E>
cudaError_t launch_bwd(const BwdArgsT<E>& a, const TrainArgs& ta,
                       cudaStream_t st) {
  constexpr bool kD16 = sizeof(E) == 2;
  const long long m = (long long)a.b * a.n;
  if (m == 0) return cudaSuccess;
  const int hd = a.heads * a.dh, wd = hd + 2 * a.heads;
  const OperandT<E> op = {a.x,   {a.fc, a.wa1, a.wa2},
                          {ta.wp, ta.wpa1, ta.wpa2},
                          a.n,   a.din,
                          hd,    hd + a.heads,
                          wd};
  const ProductWorkT<E> work = {a.xm,  a.wt,  a.part_w, a.kxp,
                                a.wdp, a.ntp, a.splits, a.bt};
  // K4 runs its products on the valid rows alone (row_off set)
  const bool compact = a.pooled && a.row_off != nullptr;
  const int* rows = compact ? a.row_off + a.b : nullptr;
  const int* row_map = compact ? a.row_map : nullptr;
  const int kbeg = a.need_dx ? 0 : a.din;
  cudaError_t err;

  // 0. X staged (K4: the valid rows, compacted, with their row map; the
  // products' D zero on the kRowPad rows after them) and W packed
  mark(g_marks, st);
  if (compact) {
    if (a.xm == nullptr || m + kRowPad > 0x7fffffffLL)
      return cudaErrorInvalidValue;
    valid_row_offsets_kernel<<<1, 1024, 0, st>>>(a.ngp, a.nsib, a.b, a.n,
                                                 a.p, a.row_off);
    using D = typename std::conditional<kD16, bf16, float>::type;
    D* dpad;
    if constexpr (kD16)
      dpad = a.d16;
    else
      dpad = a.dcat;
    stage_valid_rows_kernel<E, D><<<grid_for((m + kRowPad) * 32), 256, 0,
                                    st>>>(op, ta, a.ngp, a.nsib, a.p,
                                          a.row_off, a.b, a.xm, a.kxp,
                                          a.row_map,
                                          a.need_dx ? a.dx : nullptr,
                                          a.pe_rows, dpad, a.wdp);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ProductWorkT<E> pack = work;
    pack.xm = nullptr;  // staged above
    err = stage_and_pack(op, ta, m, pack, kbeg, a.wcat, st);
  } else {
    err = stage_and_pack(op, ta, m, work, kbeg, a.wcat, st);
  }
  if (err != cudaSuccess) return err;
  mark(g_marks, st);
  // the projection into the Dcat workspace (K4: the valid rows)
  err = gat_projection(op, a.xm, a.kxp, a.wcat, a.wdp, a.bias_ft, a.bias_a1,
                       a.bias_a2, a.biascat, a.dcat, m, st, rows, row_map);
  if (err != cudaSuccess) return err;
  mark(g_marks, st);

  // 1. the head core: a block an (egonet, head), or with the slot-bias
  // partial sums (the bf16 form, and K4's valid rows) a (chunk of egonets,
  // head) (K4: the slots' rows too)
  const size_t smem =
      sizeof(float) * (head_floats(a.n) + (compact ? row_floats(a.n) : 0));
  const bool part = (kD16 || compact) && a.need_dbias;
  const long long head_blocks = (part ? a.chunks : a.b) * (long long)a.heads;
  if (head_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const void* head;
  if (compact)
    head = part ? (const void*)gat_bwd_head_kernel<true, E, true, true>
                : (const void*)gat_bwd_head_kernel<true, E, false, true>;
  else if (a.pooled)
    head = part ? (const void*)gat_bwd_head_kernel<true, E, true>
                : (const void*)gat_bwd_head_kernel<true, E>;
  else
    head = part ? (const void*)gat_bwd_head_kernel<false, E, true>
                : (const void*)gat_bwd_head_kernel<false, E>;
  err = prepare(head, smem);
  if (err != cudaSuccess) return err;
  void* params[] = {const_cast<BwdArgsT<E>*>(&a),
                    const_cast<TrainArgs*>(&ta)};
  err = cudaLaunchKernel(head, dim3((unsigned)head_blocks), dim3(kThreads),
                         params, smem, st);
  if (err != cudaSuccess) return err;
  mark(g_marks, st);

  // the slot-bias grads: K2 float32 sums Dcat over egonets; the bf16
  // forms' and K4's head core has summed D's float32 values by chunk; then
  // the fixed-order reduction over the chunks
  if (a.need_dbias) {
    const long long rw = (long long)a.n * a.wdp;
    if (!part) {
      const long long chunk_b = (a.b + a.chunks - 1) / a.chunks;
      colsum_partial_kernel<<<dim3(blocks_for(rw), a.chunks), kThreads, 0,
                              st>>>(a.dcat, a.b, rw, chunk_b, a.part_b);
    }
    reduce_scatter_kernel<float><<<blocks_for(rw), kThreads, 0, st>>>(
        a.part_b, a.chunks, a.n, a.wdp, a.n, hd, hd + a.heads, wd,
        a.dbias_ft, a.dbias_a1, a.dbias_a2, nullptr, nullptr, nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  mark(g_marks, st);

  // 2-4. dW, dx, dpe from D: Dcat itself, or the head core's bf16 D
  const E* d;
  if constexpr (kD16)
    d = a.d16;
  else
    d = a.dcat;
  E* const dw[3] = {a.dfc, a.dwa1, a.dwa2};
  float* const dwp[3] = {a.dwp, a.dwpa1, a.dwpa2};
  return product_grads(op, ta, d, a.wdp, m, work, a.chunks, dw, dwp,
                       a.need_dx, a.dx, a.pe_rows, a.part_pe, a.dpe, g_marks,
                       st, rows, row_map);
}

}  // namespace

extern "C" {

const char* gat_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The backward of one star-GAT layer (K2, or K4 with a->pooled, which
// also takes the row workspaces row_off and row_map): all passes launched
// in order on `stream`. Outputs and workspaces are allocated by the caller
// (ops/gat_kernels.py). Returns the first CUDA error of a launch, or 0.
int gat_layer_bwd_f32(const BwdArgsT<float>* ap, const TrainArgs* tap,
                      void* stream) {
  return launch_bwd(*ap, *tap, (cudaStream_t)stream);
}

// The bf16 form: *ap with the bf16 fields of BwdArgsT<bf16> (x, fc, wa1,
// wa2, K2's g, dx, dfc, dwa1, dwa2, the workspaces xm, wcat, wt and d16),
// every other field as in the float32 form but bt (unused).
int gat_layer_bwd_bf16(const BwdArgsT<bf16>* ap, const TrainArgs* tap,
                       void* stream) {
  return launch_bwd(*ap, *tap, (cudaStream_t)stream);
}

// Pass timing: with `on`, the next gat_layer_bwd_* call records device
// events between its passes; gat_bwd_pass_ms then gives their
// milliseconds (stage and pack (K4: with the valid rows' offsets and
// compaction), projection, head core, slot-bias sums (the bf16 forms and
// K4: the reduction of the head core's partials alone), dW (float32: with
// its operand's transposition into planes), dx) into out[6] and returns
// their count.
int gat_bwd_set_timing(int on) { return set_timing(g_marks, on); }

// The bf16 product alone (gemm_wgmma.cuh), for tests and measurements:
// c [splits][m][n] = the split-K partials of A @ B, A [m][k] row-major
// (a_kmajor) or A^T [k][m] row-major, B [k][n] row-major, all bf16 rows
// 16-byte multiples; the store epilogue.
int gat_product_bf16(const bf16* a, long long lda, int a_kmajor,
                     const bf16* b, long long ldb, float* c, long long m,
                     int n, long long k, int splits, void* stream) {
  using namespace gat;
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0 || splits < 1) return (int)cudaErrorInvalidValue;
  GemmArgsT<bf16> g = {};
  g.a = a;
  g.lda = lda;
  g.b = b;
  g.ldb = ldb;
  g.c = c;
  g.ldc = n;
  g.c_split = m * n;
  g.m = m;
  g.n = n;
  g.k = k;
  g.k_chunk = ((k + splits - 1) / splits + 63) / 64 * 64;
  const TrainArgs ta = {};
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (a_kmajor)
    err = n <= kNarrowBN ? product<true, kEpiStore, true>(g, ta, splits, st)
                         : product<true, kEpiStore>(g, ta, splits, st);
  else
    err = n <= kNarrowBN ? product<false, kEpiStore, true>(g, ta, splits, st)
                         : product<false, kEpiStore>(g, ta, splits, st);
  return (int)err;
}

// The float32 product alone (3xTF32 on gemm_wgmma.cuh's ring), for tests
// and measurements: c [splits][m][n] = the split-K partials of A @ B, A
// [m][k] row-major (a_kmajor) or A^T [k][m] row-major, B [k][n] row-major,
// rows 16-byte multiples; bt a workspace [2][n rounded up to 4][k rounded
// up to 4] for B's hi / lo planes (transpose_split_kernel, as the dW
// product's B); the store epilogue.
int gat_product_f32(const float* a, long long lda, int a_kmajor,
                    const float* b, long long ldb, float* bt, float* c,
                    long long m, int n, long long k, int splits,
                    void* stream) {
  using namespace gat;
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0 || splits < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int np = (n + 3) / 4 * 4;
  const long long ldr = (k + 3) / 4 * 4;
  transpose_split_kernel<<<dim3((unsigned)((k + 31) / 32),
                                (unsigned)((np + 31) / 32)),
                           dim3(32, 8), 0, st>>>(b, ldb, n, np, k, nullptr,
                                                 ldr, bt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  GemmArgsT<float> g = {};
  g.a = a;
  g.lda = lda;
  g.b = bt;
  g.b_lo = bt + (long long)np * ldr;
  g.ldb = ldr;
  g.c = c;
  g.ldc = n;
  g.c_split = m * n;
  g.m = m;
  g.n = n;
  g.k = k;
  g.k_chunk = ((k + splits - 1) / splits + 63) / 64 * 64;
  const TrainArgs ta = {};
  if (a_kmajor)
    err = n <= kNarrowBN ? product<true, kEpiStore, true>(g, ta, splits, st)
                         : product<true, kEpiStore>(g, ta, splits, st);
  else
    err = n <= kNarrowBN ? product<false, kEpiStore, true>(g, ta, splits, st)
                         : product<false, kEpiStore>(g, ta, splits, st);
  return (int)err;
}

int gat_bwd_pass_ms(float* out) { return pass_ms(g_marks, out); }

}  // extern "C"
