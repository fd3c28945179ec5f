// Star-GCN layer kernels for Hopper (sm_90a), float32: the forward in eval
// form (serving) and train form (dropout), and the backward.
//
// Replace the Pallas kernels of taxoexpan_tpu/ops/pallas_gcn.py:
//   gcn_layer_fwd[_train] (K5f) <- fused_gcn_layer forward (_fused_fwd,
//                                  _fwd_kernel, _prologue, _aggregate, _norms)
//   gcn_layer_bwd (K5b)         <- its VJP (_fused_bwd, _bwd_kernel)
// Per egonet b (slots [0, p) grandparents | p anchor | (p, n) siblings):
//   z    = [x*m | pe*m_pe] @ [W_h; W_p] + z_bias                 [n, dout]
//   norm = rsqrt(in-degree): gp 1 (valid) / 0, anchor rsqrt(1 + ngp),
//          sib rsqrt(2) (valid) / 0
//   pre  = norm * copy_src_sum(norm * z): gp <- self, anchor <- self + the
//          valid gps, sib <- self + anchor
//   out  = leaky(pre + b, alpha), or pre + b on the final layer.
// Invalid slots have norm 0, so their output is leaky(b) (or b), the TPU
// kernel's value, not 0. The eval form takes pe's term as the constant
// z_bias = pe @ W_p; the train form masks x and the pe rows (`pos` extra K
// columns, gat_common.cuh:head_tile) with the counter-based bits of
// ops/dropout.py, rows b*n + slot, streams STREAM_FEAT / STREAM_PE.
//
// Backward, one C entry point launching in order:
//  1. dz, one block per (egonet, 128-column tile): the incoming grad tile,
//     times leaky'(pre + b) where the layer has an activation (z recomputed
//     by the forward's product: only then is the product needed, so the
//     final layer's backward skips it), the mirrored aggregation
//     dz = norm * copy_src_sum^T(norm * g2) into a workspace [b*n, dout],
//     and the per-egonet column sums of g2 for db.
//  2. db and d z_bias: sums over egonets, chunked partial sums then a
//     fixed-order reduction (bwd_common.cuh).
//  3. dW = [x*m | pe*m_pe]^T @ dz split-K, dx = (dz @ W_h^T) * m (need_dx)
//     and dpe = sum over egonets of (dz @ W_p^T) * m_pe: the tensor-core
//     products of bwd_common.cuh (3xTF32), the layer input staged once.
// Deterministic: no atomics.
//
// What bounds it on an H100: the products. At config.mag.json's PGCN
// shapes (N = 64, 4096 egonets) layer 0's forward does 2*B*64*300*500 =
// 78.6 GFLOP against 0.79 GB of x and out (1.17 ms at 67 TFLOP/s float32
// outside the tensor cores, 0.23 ms at 3.35 TB/s); the backwards add the
// dW and dx products of the same size. The forward's product is float32
// SIMT FMAs; the backward's dW and dx products run on the tensor cores in
// 3xTF32, which keeps float32 accuracy (bwd_common.cuh).
//
// Design (simple first): the forward's block computes the egonet's whole
// z tile [n, 128] in shared memory with the register-tiled product of
// gat_common.cuh (4 rows x 8 columns a thread, K tiles of 16), then the
// star sum, the dst norm, the bias and the activation, and writes only
// out: z never reaches device memory. N is taken as given (no slot
// padding); rows beyond n and columns beyond dout are masked.

#include "bwd_common.cuh"

// Mirrored field by field by gcn_kernels._GcnArgs.
struct GcnArgs {
  const float* x;       // [b, n, din]
  const float* w;       // [din, dout] (W_h)
  const float* bias;    // [dout]
  const float* z_bias;  // [n, dout]
  const int* ngp;       // [b]
  const int* nsib;      // [b]
  const float* g;       // backward: incoming grad [b, n, dout]
  float* out;           // forward: [b, n, dout]
  float* dz;            // backward workspaces: [b*n, ldd]
  float* g2sum;         // [b, dout]
  float* part_w;        // [splits, din+pos, dout]
  float* part_b;        // [chunks, n*dout]
  float* pe_rows;       // [b*n, pos] (pos > 0)
  float* part_pe;       // [chunks, n*pos] (pos > 0)
  float* dx;            // [b, n, din] (need_dx)
  float* dw;            // [din, dout]
  float* db;            // [dout]
  float* dzb;           // [n, dout] (need_dzb)
  float* dpe;           // [n, pos] (pos > 0)
  float* dwp;           // [pos, dout] (pos > 0)
  float* xm;            // [b*n, kxp] the layer input staged, or null
  float* wt;            // [ldd, ntp] W^T over the dx product's columns
  int b, n, din, dout, p, has_alpha, need_dx, need_dzb, splits, chunks;
  int kxp, ldd, ntp;    // ldd: dz's row stride, dout rounded up to 4
  float alpha;
};

namespace {

using namespace gat;

PassMarks g_marks;

// rsqrt(in-degree) of every slot of one egonet, 0 on invalid slots.
__device__ __forceinline__ void star_norms(int n, int p, int ngp, int nsib,
                                           float* norm) {
  for (int r = threadIdx.x; r < n; r += kThreads) {
    if (r < p)
      norm[r] = r < ngp ? 1.f : 0.f;
    else if (r == p)
      norm[r] = rsqrtf(1.f + (float)ngp);
    else
      norm[r] = r - p - 1 < nsib ? rsqrtf(2.f) : 0.f;
  }
}

// pre-activation (before the bias) of row r, column c of a z tile
__device__ __forceinline__ float aggregate(const float* z, const float* norm,
                                           int r, int c, int p, int ngp) {
  const float nr = norm[r];
  if (r < p) return z[r * kTileCols + c] * nr * nr;
  const float za = z[p * kTileCols + c] * norm[p];
  if (r > p) return (z[r * kTileCols + c] * nr + za) * nr;
  float acc = za;
  for (int j = 0; j < ngp; ++j) acc += z[j * kTileCols + c] * norm[j];
  return acc * nr;
}

// The z tile of egonet b, columns [c0, c0 + ncols), with z_bias, into s.ft.
template <bool kTrain>
__device__ __forceinline__ void z_tile(const GcnArgs& a, const TrainArgs& ta,
                                       long long b, int c0, int ncols,
                                       const Smem& s) {
  if (kTrain) setup_row_keys(ta, b, a.n, s);
  head_tile<kTrain, false>(a.x + b * a.n * a.din, a.w, nullptr, nullptr,
                           a.z_bias, nullptr, nullptr, a.n, a.din, a.dout, 1,
                           0, c0, ncols, s, ta);
}

template <bool kTrain>
__device__ __forceinline__ void fwd_body(const GcnArgs& a,
                                         const TrainArgs& ta) {
  extern __shared__ float4 smem4[];
  const int n = a.n, p = a.p, dout = a.dout;
  const Smem s = carve(reinterpret_cast<float*>(smem4), n,
                       kTrain ? kTrainLayout : kEvalLayout);
  const int ntiles = (dout + kTileCols - 1) / kTileCols;
  const long long b = blockIdx.x / ntiles;
  const int c0 = (blockIdx.x % ntiles) * kTileCols;
  const int ncols = min(kTileCols, dout - c0);
  const int ngp = min(max(a.ngp[b], 0), p);
  const int nsib = min(max(a.nsib[b], 0), n - p - 1);
  float* norm = s.a1;  // head_tile<., false> leaves s.a1 free

  star_norms(n, p, ngp, nsib, norm);
  z_tile<kTrain>(a, ta, b, c0, ncols, s);  // ends with __syncthreads

  float* outb = a.out + b * n * dout;
  for (int e = threadIdx.x; e < n * kTileCols; e += kThreads) {
    const int r = e / kTileCols, c = e % kTileCols;
    if (c >= ncols) continue;
    float v = aggregate(s.ft, norm, r, c, p, ngp) + a.bias[c0 + c];
    if (a.has_alpha) v = leaky(v, a.alpha);
    outb[(size_t)r * dout + c0 + c] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
gcn_fwd_kernel(GcnArgs a, TrainArgs ta) {
  fwd_body<false>(a, ta);
}

__global__ void __launch_bounds__(kThreads, 2)
gcn_fwd_train_kernel(GcnArgs a, TrainArgs ta) {
  fwd_body<true>(a, ta);
}

// Shared memory of the backward's first pass: with an activation the
// forward's (train) layout for the z recompute, then the grad tile
// [n][kTileCols]; without, the norms and the grad tile only.
size_t bwd_smem_floats(int n, bool act) {
  return (act ? smem_floats(n, kTrainLayout) : (size_t)n) +
         (size_t)n * kTileCols;
}

// 1. dz and the per-egonet column sums of g2
template <bool kAct>
__global__ void __launch_bounds__(kThreads, 2)
gcn_bwd_dz_kernel(GcnArgs a, TrainArgs ta) {
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  const int n = a.n, p = a.p, dout = a.dout;
  const int ntiles = (dout + kTileCols - 1) / kTileCols;
  const long long b = blockIdx.x / ntiles;
  const int c0 = (blockIdx.x % ntiles) * kTileCols;
  const int ncols = min(kTileCols, dout - c0);
  const int ngp = min(max(a.ngp[b], 0), p);
  const int nsib = min(max(a.nsib[b], 0), n - p - 1);
  Smem s = {};
  float *norm, *gt;
  if (kAct) {
    s = carve(base, n, kTrainLayout);
    norm = s.a1;
    gt = base + smem_floats(n, kTrainLayout);
  } else {
    norm = base;
    gt = base + n;
  }
  star_norms(n, p, ngp, nsib, norm);
  if (kAct) z_tile<true>(a, ta, b, c0, ncols, s);
  else __syncthreads();

  // the incoming grad tile, through leaky'(pre + b) of the recomputed
  // pre-activation
  const float* gb = a.g + b * n * dout;
  for (int e = threadIdx.x; e < n * kTileCols; e += kThreads) {
    const int r = e / kTileCols, c = e % kTileCols;
    float gv = 0.f;
    if (c < ncols) {
      gv = gb[(size_t)r * dout + c0 + c];
      if (kAct) {
        const float pre = aggregate(s.ft, norm, r, c, p, ngp) + a.bias[c0 + c];
        if (!(pre >= 0.f)) gv *= a.alpha;
      }
    }
    gt[e] = gv;
  }
  __syncthreads();

  // db: the bias reaches every slot, invalid ones included
  for (int c = threadIdx.x; c < ncols; c += kThreads) {
    float sum = 0.f;
    for (int r = 0; r < n; ++r) sum += gt[r * kTileCols + c];
    a.g2sum[b * dout + c0 + c] = sum;
  }
  // dz = norm * copy_src_sum^T(norm * g2), zero in the padding columns
  float* dzb = a.dz + b * n * a.ldd;
  if (c0 == 0)
    for (int e = threadIdx.x; e < n * (a.ldd - dout); e += kThreads)
      dzb[(size_t)(e / (a.ldd - dout)) * a.ldd + dout +
          e % (a.ldd - dout)] = 0.f;
  for (int e = threadIdx.x; e < n * kTileCols; e += kThreads) {
    const int r = e / kTileCols, c = e % kTileCols;
    if (c >= ncols) continue;
    const float ga = gt[p * kTileCols + c] * norm[p];
    float v;
    if (r < p) {
      v = (gt[e] * norm[r] + ga) * norm[r];
    } else if (r == p) {
      v = ga;
      for (int i = p + 1; i < n; ++i) v += gt[i * kTileCols + c] * norm[i];
      v *= norm[p];
    } else {
      v = gt[e] * norm[r] * norm[r];
    }
    dzb[(size_t)r * a.ldd + c0 + c] = v;
  }
}

}  // namespace

extern "C" {

const char* gcn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The forward of one star-GCN layer: eval form (train = 0, *ta unused) or
// train form (feature and pe dropout, the pe path, as *ta describes). All
// pointers are device pointers to contiguous row-major arrays allocated by
// the caller (ops/gcn_kernels.py). Returns cudaGetLastError() after the
// launch.
int gcn_layer_fwd_f32(const GcnArgs* ap, const TrainArgs* tap, int train,
                      void* stream) {
  const GcnArgs a = *ap;
  const size_t smem =
      sizeof(float) * smem_floats(a.n, train ? kTrainLayout : kEvalLayout);
  const void* kernel =
      train ? (const void*)gcn_fwd_train_kernel : (const void*)gcn_fwd_kernel;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)a.b * ((a.dout + kTileCols - 1) / kTileCols);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (blocks > 0) {
    if (train)
      gcn_fwd_train_kernel<<<(unsigned)blocks, kThreads, smem,
                             (cudaStream_t)stream>>>(a, *tap);
    else
      gcn_fwd_kernel<<<(unsigned)blocks, kThreads, smem,
                       (cudaStream_t)stream>>>(a, *tap);
  }
  return cudaGetLastError();
}

// The backward of one star-GCN layer for the incoming grad a->g: every pass
// launched in order on `stream`, workspaces and outputs allocated by the
// caller. Returns the first CUDA error of a launch, or 0.
int gcn_layer_bwd_f32(const GcnArgs* ap, const TrainArgs* tap, void* stream) {
  const GcnArgs a = *ap;
  const TrainArgs ta = *tap;
  cudaStream_t st = (cudaStream_t)stream;
  const long long m = (long long)a.b * a.n;
  if (m == 0) return cudaSuccess;
  const bool act = a.has_alpha != 0;
  const size_t smem = sizeof(float) * bwd_smem_floats(a.n, act);
  const void* kernel = act ? (const void*)gcn_bwd_dz_kernel<true>
                           : (const void*)gcn_bwd_dz_kernel<false>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)a.b * ((a.dout + kTileCols - 1) / kTileCols);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (act)
    gcn_bwd_dz_kernel<true><<<(unsigned)blocks, kThreads, smem, st>>>(a, ta);
  else
    gcn_bwd_dz_kernel<false><<<(unsigned)blocks, kThreads, smem, st>>>(a, ta);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  err = sum_over_egonets(a.g2sum, a.b, 1, a.dout, a.dout, a.chunks,
                         a.part_b, a.db, st);
  if (err != cudaSuccess) return err;
  if (a.need_dzb) {
    err = sum_over_egonets(a.dz, a.b, a.n, a.ldd, a.dout, a.chunks,
                           a.part_b, a.dzb, st);
    if (err != cudaSuccess) return err;
  }
  const Operand op = {a.x, {a.w, nullptr, nullptr}, {ta.wp, nullptr, nullptr},
                      a.n, a.din, a.dout, a.dout, a.dout};
  const ProductWork work = {a.xm, a.wt, a.part_w, a.kxp, a.ldd, a.ntp,
                            a.splits};
  err = stage_and_pack(op, ta, m, work, a.need_dx ? 0 : a.din, nullptr, st);
  if (err != cudaSuccess) return err;
  float* const dw[3] = {a.dw, nullptr, nullptr};
  float* const dwp[3] = {a.dwp, nullptr, nullptr};
  return product_grads(op, ta, a.dz, a.ldd, m, work, a.chunks, dw, dwp,
                       a.need_dx, a.dx, a.pe_rows, a.part_pe, a.dpe, g_marks,
                       st);
}

// Pass timing of the backward, as gat_bwd.cu's: the dW and dx passes
// (marks after each) into out[2].
int gcn_bwd_set_timing(int on) { return set_timing(g_marks, on); }

int gcn_bwd_pass_ms(float* out) { return pass_ms(g_marks, out); }

}  // extern "C"
