// Star-GCN layer kernels for Hopper (sm_90a), float32 and bf16: the forward
// in eval form (serving) and train form (dropout), and the backward.
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
// z_bias = pe @ W_p; the train form masks x and the pe rows (`pos` extra
// columns of the layer input X) with the counter-based bits of
// ops/dropout.py, rows b*n + slot, streams STREAM_FEAT / STREAM_PE.
//
// Forward, two launches and a small preparation (as gat_fwd.cu runs K1):
//  1. X staged once into a workspace, each mask bit hashed once, where the
//     layer has masks or a pe path or x's rows are not 16-byte multiples
//     (else the product reads x), and W = [W_h; W_p] packed; then the
//     projection z = X @ W + z_bias over all B*N rows into a workspace
//     [B*N, ldd] (ldd = dout rounded up to 4, zero in the padding
//     columns), on the tensor cores in 3xTF32 (gemm_tf32.cuh, shared with
//     K1-K4: bwd_common.cuh:gat_projection with W alone and z_bias as the
//     slot bias).
//  2. The star pass, one block per (egonet, 128-column tile), each thread
//     a column: the star sum with the closed-form norms, the bias and the
//     activation, out written once for all N rows; only the valid rows of
//     z are read (an invalid row's output is act(b)).
//
// Backward, one C entry point launching in order:
//  1. X staged and W packed once: W^T for the dx product and, where the
//     layer has an activation, W for the projection;
//  2. with an activation, z recomputed by the forward's own projection on
//     the same X, so leaky' is taken at the forward's pre-activation, bit
//     for bit (the final layer's backward needs no z and skips it);
//  3. the dz star pass, blocks as the forward's star pass: g2 = g
//     times leaky'(pre + b), dz = norm * copy_src_sum^T(norm * g2) written
//     over the z workspace in place (each thread reads and writes its own
//     column only; zero in the padding columns and on invalid rows), and
//     the per-egonet column sums of g2 for db;
//  4. db and d z_bias: sums over egonets, chunked partial sums then a
//     fixed-order reduction (bwd_common.cuh);
//  5. dW = X^T @ dz split-K, dx = (dz @ W_h^T) * m (need_dx) and dpe = sum
//     over egonets of (dz @ W_p^T) * m_pe: the tensor-core products of
//     bwd_common.cuh (3xTF32).
// Deterministic: no atomics.
//
// The bf16 form (fused_gcn_layer with x in bf16; `*_bf16` entry points):
// x, W_h, the output, the incoming grad g, dx and dW in bf16, on the same
// passes at element type bf16 (pallas_gcn.py:69-78, :124-126, :163,
// :209-223). X is staged as x times its mask rounded to bf16, the pe rows
// times their float32 mask rounded to bf16, W_p packed in bf16; the
// projection runs bf16 wgmma with float32 accumulation (gemm_wgmma.cuh) into
// the float32 z, and the backward's recompute reruns it on the same staged
// X, so leaky' is taken at the forward's bits. The star passes keep their
// float32 arithmetic: the forward's rounds the output to bf16, the dz pass
// upcasts g. After the db / d z_bias sums (float32, from dz) dz is cast to
// bf16 once (as K2's cast of D) for dW = X^T @ dz (the x rows rounded to
// bf16, the pe rows' dW_p float32) and dX = dz @ W^T (dx times its float32
// mask, rounded to bf16; the pe columns' grads float32). Rows of z, W and
// dz hold 8 bf16 a 16-byte chunk: ldd, kxp and ntp round to 8.
//
// What bounds it on an H100: the products. At config.mag.json's PGCN
// shapes (N = 64, 4096 egonets) layer 0's train forward projects
// 2 * 262,144 * 300 * 500 = 78.6 GFLOP (the final layer's 144 GFLOP),
// against 0.8-1.1 GB of x, z and out; the 3xTF32 product runs these
// shallow products (K 250-550) at 42-48 TFLOP/s of float32 work on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md). The star passes are bound by
// bytes: the valid rows of z read and out written, or g read and dz
// written over z, 0.8-1.3 GB each, at 2.1-2.4 TB/s there. The projection
// runs over all B*N rows, as the TPU kernel does, while only the valid ones
// (about half in the smoke's batch) reach out.

#include "bwd_common.cuh"

using gat::bf16;

namespace gat {

// dst [count] = src rounded to bf16 (count a multiple of 4): dz cast once
// for the bf16 dW and dx products (pallas_gcn.py:209-223).
__global__ void cast_bf16_kernel(const float* __restrict__ src,
                                 bf16* __restrict__ dst, long long count) {
  for (long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
       e < count; e += (long long)gridDim.x * blockDim.x * 4) {
    const float4 v = *reinterpret_cast<const float4*>(src + e);
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<__nv_bfloat162*>(dst + e) = lo;
    *reinterpret_cast<__nv_bfloat162*>(dst + e + 2) = hi;
  }
}

}  // namespace gat

// Mirrored field by field by gcn_kernels._GcnArgs. E: the layer's element
// type (float, or bf16: x, w, g, out, dx, dw and the workspaces xm, wcat,
// wt, dz16).
template <class E>
struct GcnArgsT {
  const E* x;           // [b, n, din]
  const E* w;           // [din, dout] (W_h)
  const float* bias;    // [dout]
  const float* z_bias;  // [n, dout]
  const int* ngp;       // [b]
  const int* nsib;      // [b]
  const E* g;           // backward: incoming grad [b, n, dout]
  E* out;               // forward: [b, n, dout]
  float* z;             // workspace [b*n, ldd]: the projection z; the
                        // backward writes dz over it
  float* g2sum;         // [b, dout]
  float* part_w;        // [splits, din+pos, dout]
  float* part_b;        // [chunks, n*ldd]
  float* pe_rows;       // [b*n, pos] (pos > 0)
  float* part_pe;       // [chunks, n*pos] (pos > 0)
  E* dx;                // [b, n, din] (need_dx)
  E* dw;                // [din, dout]
  float* db;            // [dout]
  float* dzb;           // [n, dout] (need_dzb)
  float* dpe;           // [n, pos] (pos > 0)
  float* dwp;           // [pos, dout] (pos > 0)
  E* xm;                // [b*n, kxp] the layer input staged, or null
  E* wcat;              // [kxp, ldd] W for the projection, or null (the
                        // backward of a layer without activation)
  float* biascat;       // [n, ldd] z_bias in the projection's layout
  E* wt;                // [ldd, ntp] W^T over the dx product's columns
  E* dz16;              // [b*n, ldd] dz cast to bf16 (the bf16 backward)
  int b, n, din, dout, p, has_alpha, need_dx, need_dzb, splits, chunks;
  int kxp, ldd, ntp;    // ldd: z's row stride, dout rounded up to a
                        // 16-byte multiple of E
  float alpha;
};

namespace {

using namespace gat;

PassMarks g_fwd_marks, g_bwd_marks;

template <bool kAct>
__device__ __forceinline__ float act(float v, float alpha) {
  return kAct ? leaky(v, alpha) : v;
}

// g times leaky'(pre) (kAct), else g
template <bool kAct>
__device__ __forceinline__ float through_act(float pre, float g,
                                             float alpha) {
  return kAct && !(pre >= 0.f) ? g * alpha : g;
}

// The star passes' blocks: one egonet's 128-column tile, a thread a column.
constexpr int kStarCols = 128;

// The star passes' grid over b egonets of `width` columns, or 0 if too large.
unsigned star_blocks(long long b, int width) {
  const long long blocks = b * ((width + kStarCols - 1) / kStarCols);
  return blocks > 0x7fffffffLL ? 0u : (unsigned)blocks;
}

// Rows [lo, hi) of a thread's column, kRowBatch at a time: the loads of a
// batch's rows (load(r)) are all issued before any of them is used
// (use(r, value)), so that each thread keeps several loads in flight, also
// where use() writes the buffer load() reads (the dz pass, in place).
constexpr int kRowBatch = 8;

template <class T, class Load, class Use>
__device__ __forceinline__ void row_batches(int lo, int hi, Load load,
                                            Use use) {
  for (int r0 = lo; r0 < hi; r0 += kRowBatch) {
    T v[kRowBatch];
#pragma unroll
    for (int i = 0; i < kRowBatch; ++i)
      if (r0 + i < hi) v[i] = load(r0 + i);
#pragma unroll
    for (int i = 0; i < kRowBatch; ++i)
      if (r0 + i < hi) use(r0 + i, v[i]);
  }
}

// 2. the forward's star pass over z [b*n, ldz] into out [b, n, dout] of
// element type O (float32 arithmetic, the output rounded to O)
template <bool kAct, class O>
__global__ void __launch_bounds__(kStarCols)
gcn_star_fwd_kernel(const float* __restrict__ z, int ldz,
                    const float* __restrict__ bias,
                    const int* __restrict__ ngp_arr,
                    const int* __restrict__ nsib_arr, O* __restrict__ out,
                    int n, int dout, int p, float alpha) {
  const int ntiles = (dout + kStarCols - 1) / kStarCols;
  const long long b = blockIdx.x / ntiles;
  const int c = (blockIdx.x % ntiles) * kStarCols + threadIdx.x;
  if (c >= dout) return;
  const int ngp = min(max(ngp_arr[b], 0), p);
  const int nsib = min(max(nsib_arr[b], 0), n - p - 1);
  const float na = rsqrtf(1.f + (float)ngp), ns = rsqrtf(2.f);
  const float* zc = z + (size_t)b * n * ldz + c;
  O* oc = out + (size_t)b * n * dout + c;
  const auto zrow = [&](int r) { return zc[(size_t)r * ldz]; };
  const auto put = [&](int r, float v) {
    oc[(size_t)r * dout] = from_float<O>(act<kAct>(v, alpha));
  };
  const float bc = bias[c];
  const float za = zrow(p) * na;
  float acc = za;
  row_batches<float>(0, ngp, zrow, [&](int r, float v) {
    acc += v;  // valid gps: self (norm 1), and -> anchor
    put(r, v + bc);
  });
  for (int r = ngp; r < p; ++r) put(r, bc);  // invalid slots: norm 0
  put(p, acc * na + bc);
  row_batches<float>(p + 1, p + 1 + nsib, zrow, [&](int r, float v) {
    put(r, (v * ns + za) * ns + bc);
  });  // valid sibs: self and anchor
  for (int r = p + 1 + nsib; r < n; ++r) put(r, bc);
}

// 3. the backward's dz star pass: dz over z [b*n, ldd] in place and the
// column sums of g2 into g2sum [b, dout], g of element type G upcast to
// float32. Invalid rows: pre = b (norm 0), so their g2 = g * leaky'(b)
// enters db, and their dz is 0.
template <bool kAct, class G>
__global__ void __launch_bounds__(kStarCols)
gcn_star_bwd_kernel(float* __restrict__ zd, int ldd,
                    const G* __restrict__ g,
                    const float* __restrict__ bias,
                    const int* __restrict__ ngp_arr,
                    const int* __restrict__ nsib_arr,
                    float* __restrict__ g2sum, int n, int dout, int p,
                    float alpha) {
  const int ntiles = (ldd + kStarCols - 1) / kStarCols;
  const long long b = blockIdx.x / ntiles;
  const int c = (blockIdx.x % ntiles) * kStarCols + threadIdx.x;
  if (c >= ldd) return;
  float* zc = zd + (size_t)b * n * ldd + c;
  if (c >= dout) {  // the padding columns the products read
    for (int r = 0; r < n; ++r) zc[(size_t)r * ldd] = 0.f;
    return;
  }
  const int ngp = min(max(ngp_arr[b], 0), p);
  const int nsib = min(max(nsib_arr[b], 0), n - p - 1);
  const float na = rsqrtf(1.f + (float)ngp), ns = rsqrtf(2.f);
  const G* gc = g + (size_t)b * n * dout + c;
  const auto grow = [&](int r) { return to_float(gc[(size_t)r * dout]); };
  const auto gzrow = [&](int r) {  // g and (kAct) z of a valid row
    return make_float2(grow(r), kAct ? zc[(size_t)r * ldd] : 0.f);
  };
  const float bc = bias[c];
  float za = 0.f, pre_a = 0.f;
  if (kAct) {  // the anchor's pre-activation, from the forward's z
    za = zc[(size_t)p * ldd] * na;
    float acc = za;
    row_batches<float>(0, ngp, [&](int r) { return zc[(size_t)r * ldd]; },
                       [&](int, float v) { acc += v; });
    pre_a = acc * na + bc;
  }
  const float ga = through_act<kAct>(pre_a, grow(p), alpha);
  const float ga_n = ga * na;
  float sum = 0.f;  // db's column sum over all rows, in row order
  row_batches<float2>(0, ngp, gzrow, [&](int r, float2 v) {
    const float gr = through_act<kAct>(v.y + bc, v.x, alpha);
    sum += gr;
    zc[(size_t)r * ldd] = gr + ga_n;
  });
  row_batches<float>(ngp, p, grow, [&](int r, float v) {
    sum += through_act<kAct>(bc, v, alpha);
    zc[(size_t)r * ldd] = 0.f;
  });
  sum += ga;
  float anc = ga_n;  // the anchor's dz: self and the valid sibs
  row_batches<float2>(p + 1, p + 1 + nsib, gzrow, [&](int r, float2 v) {
    const float gr = through_act<kAct>((v.y * ns + za) * ns + bc, v.x, alpha);
    sum += gr;
    anc += gr * ns;
    zc[(size_t)r * ldd] = gr * ns * ns;
  });
  row_batches<float>(p + 1 + nsib, n, grow, [&](int r, float v) {
    sum += through_act<kAct>(bc, v, alpha);
    zc[(size_t)r * ldd] = 0.f;
  });
  zc[(size_t)p * ldd] = anc * na;
  g2sum[b * dout + c] = sum;
}

// The layer's product operands: x and W_h, the pe rows from ta.
template <class E>
OperandT<E> layer_operand(const GcnArgsT<E>& a, const TrainArgs& ta) {
  return {a.x, {a.w, nullptr, nullptr}, {ta.wp, nullptr, nullptr},
          a.n, a.din, a.dout, a.dout, a.dout};
}

// 1. X staged, W packed and the projection into a.z (marks before, between
// and after)
template <class E>
cudaError_t project(const GcnArgsT<E>& a, const TrainArgs& ta, long long m,
                    cudaStream_t st) {
  const OperandT<E> op = layer_operand(a, ta);
  const ProductWorkT<E> work = {a.xm, nullptr, nullptr, a.kxp, a.ldd, 0, 1};
  mark(g_fwd_marks, st);
  cudaError_t err = stage_and_pack(op, ta, m, work, 0, a.wcat, st);
  if (err != cudaSuccess) return err;
  mark(g_fwd_marks, st);
  err = gat_projection(op, a.xm, a.kxp, a.wcat, a.ldd, a.z_bias, nullptr,
                       nullptr, a.biascat, a.z, m, st);
  mark(g_fwd_marks, st);
  return err;
}

template <class O>
cudaError_t star_fwd(const float* z, int ldz, const float* bias,
                     const int* ngp, const int* nsib, O* out, int b, int n,
                     int dout, int p, int has_alpha, float alpha,
                     cudaStream_t st) {
  if (b == 0 || dout == 0) return cudaSuccess;
  const unsigned blocks = star_blocks(b, dout);
  if (blocks == 0) return cudaErrorInvalidValue;
  if (has_alpha)
    gcn_star_fwd_kernel<true, O><<<blocks, kStarCols, 0, st>>>(
        z, ldz, bias, ngp, nsib, out, n, dout, p, alpha);
  else
    gcn_star_fwd_kernel<false, O><<<blocks, kStarCols, 0, st>>>(
        z, ldz, bias, ngp, nsib, out, n, dout, p, alpha);
  return cudaGetLastError();
}

// The forward: the projection, then the star pass.
template <class E>
cudaError_t layer_fwd(const GcnArgsT<E>& a, const TrainArgs& ta,
                      cudaStream_t st) {
  const long long m = (long long)a.b * a.n;
  if (m == 0) return cudaSuccess;
  cudaError_t err = project(a, ta, m, st);
  if (err != cudaSuccess) return err;
  err = star_fwd(a.z, a.ldd, a.bias, a.ngp, a.nsib, a.out, a.b, a.n, a.dout,
                 a.p, a.has_alpha, a.alpha, st);
  mark(g_fwd_marks, st);
  return err;
}

// The projection alone.
template <class E>
cudaError_t projection(const GcnArgsT<E>& a, const TrainArgs& ta,
                       cudaStream_t st) {
  const long long m = (long long)a.b * a.n;
  if (m == 0) return cudaSuccess;
  return project(a, ta, m, st);
}

// The backward: every pass in order on st.
template <class E>
cudaError_t layer_bwd(const GcnArgsT<E>& a, const TrainArgs& ta,
                      cudaStream_t st) {
  const long long m = (long long)a.b * a.n;
  if (m == 0) return cudaSuccess;
  const bool act = a.has_alpha != 0;
  const OperandT<E> op = layer_operand(a, ta);
  const ProductWorkT<E> work = {a.xm, a.wt, a.part_w, a.kxp, a.ldd, a.ntp,
                                a.splits};
  cudaError_t err;

  mark(g_bwd_marks, st);
  err = stage_and_pack(op, ta, m, work, a.need_dx ? 0 : a.din,
                       act ? a.wcat : nullptr, st);
  if (err != cudaSuccess) return err;
  mark(g_bwd_marks, st);
  if (act) {  // z recomputed for leaky'
    err = gat_projection(op, a.xm, a.kxp, a.wcat, a.ldd, a.z_bias, nullptr,
                         nullptr, a.biascat, a.z, m, st);
    if (err != cudaSuccess) return err;
  }
  mark(g_bwd_marks, st);

  const unsigned blocks = star_blocks(a.b, a.ldd);
  if (blocks == 0) return cudaErrorInvalidValue;
  if (act)
    gcn_star_bwd_kernel<true, E><<<blocks, kStarCols, 0, st>>>(
        a.z, a.ldd, a.g, a.bias, a.ngp, a.nsib, a.g2sum, a.n, a.dout, a.p,
        a.alpha);
  else
    gcn_star_bwd_kernel<false, E><<<blocks, kStarCols, 0, st>>>(
        a.z, a.ldd, a.g, a.bias, a.ngp, a.nsib, a.g2sum, a.n, a.dout, a.p,
        a.alpha);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mark(g_bwd_marks, st);

  err = sum_over_egonets(a.g2sum, a.b, 1, a.dout, a.dout, a.chunks,
                         a.part_b, a.db, st);
  if (err != cudaSuccess) return err;
  if (a.need_dzb) {
    err = sum_over_egonets(a.z, a.b, a.n, a.ldd, a.dout, a.chunks, a.part_b,
                           a.dzb, st);
    if (err != cudaSuccess) return err;
  }
  // the products' dz: z itself, or in a bf16 layer dz cast to bf16
  const E* d;
  if constexpr (sizeof(E) == 2) {
    cast_bf16_kernel<<<grid_for(m * a.ldd / 4), 256, 0, st>>>(a.z, a.dz16,
                                                             m * a.ldd);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    d = a.dz16;
  } else {
    d = a.z;
  }
  mark(g_bwd_marks, st);
  E* const dw[3] = {a.dw, nullptr, nullptr};
  float* const dwp[3] = {a.dwp, nullptr, nullptr};
  return product_grads(op, ta, d, a.ldd, m, work, a.chunks, dw, dwp,
                       a.need_dx, a.dx, a.pe_rows, a.part_pe, a.dpe,
                       g_bwd_marks, st);
}

}  // namespace

extern "C" {

const char* gcn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The forward of one star-GCN layer: eval form (*ta zeroed) or train form
// (feature and pe dropout, the pe path, as *ta describes). All pointers are
// device pointers to contiguous row-major arrays allocated by the caller
// (ops/gcn_kernels.py), the workspaces z, xm (or null), wcat and biascat
// included. Returns the first CUDA error of a launch, or 0.
int gcn_layer_fwd_f32(const GcnArgsT<float>* ap, const TrainArgs* tap,
                      void* stream) {
  return layer_fwd(*ap, *tap, (cudaStream_t)stream);
}

// The bf16 form: *ap with the bf16 fields of GcnArgsT<bf16> (x, w, out and
// the workspaces xm, wcat), every other field as in the float32 form.
int gcn_layer_fwd_bf16(const GcnArgsT<bf16>* ap, const TrainArgs* tap,
                       void* stream) {
  return layer_fwd(*ap, *tap, (cudaStream_t)stream);
}

// The projection alone: z = [x*m | pe*m_pe] @ [W_h; W_p] + z_bias into
// a->z [b*n, ldd] (float32 in either form).
int gcn_projection_f32(const GcnArgsT<float>* ap, const TrainArgs* tap,
                       void* stream) {
  return projection(*ap, *tap, (cudaStream_t)stream);
}

int gcn_projection_bf16(const GcnArgsT<bf16>* ap, const TrainArgs* tap,
                        void* stream) {
  return projection(*ap, *tap, (cudaStream_t)stream);
}

// The forward's star pass alone: out [b, n, dout] from z [b*n, ldz].
int gcn_star_f32(const float* z, int ldz, const float* bias, const int* ngp,
                 const int* nsib, float* out, int b, int n, int dout, int p,
                 int has_alpha, float alpha, void* stream) {
  return star_fwd(z, ldz, bias, ngp, nsib, out, b, n, dout, p, has_alpha,
                  alpha, (cudaStream_t)stream);
}

// The backward of one star-GCN layer for the incoming grad a->g: every pass
// launched in order on `stream`, workspaces and outputs allocated by the
// caller. Returns the first CUDA error of a launch, or 0.
int gcn_layer_bwd_f32(const GcnArgsT<float>* ap, const TrainArgs* tap,
                      void* stream) {
  return layer_bwd(*ap, *tap, (cudaStream_t)stream);
}

// The bf16 form: *ap with the bf16 fields of GcnArgsT<bf16> (x, w, g, dx,
// dw and the workspaces xm, wcat, wt, dz16), every other field as in the
// float32 form.
int gcn_layer_bwd_bf16(const GcnArgsT<bf16>* ap, const TrainArgs* tap,
                       void* stream) {
  return layer_bwd(*ap, *tap, (cudaStream_t)stream);
}

// Pass timing, as gat_fwd.cu's and gat_bwd.cu's: with `on`, the next call
// records device events between its launches; *_pass_ms then gives their
// milliseconds into out and returns their count. Forward (and the
// projection alone): stage and pack, projection, star pass. Backward: stage
// and pack, projection (empty without an activation), the dz pass, the
// db / d z_bias sums (with the cast of dz to bf16 in the bf16 form), dW,
// dx (with dpe).
int gcn_fwd_set_timing(int on) { return set_timing(g_fwd_marks, on); }

int gcn_fwd_pass_ms(float* out) { return pass_ms(g_fwd_marks, out); }

int gcn_bwd_set_timing(int on) { return set_timing(g_bwd_marks, on); }

int gcn_bwd_pass_ms(float* out) { return pass_ms(g_bwd_marks, out); }

}  // extern "C"
