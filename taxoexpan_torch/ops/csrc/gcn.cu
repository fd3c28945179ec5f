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
// Each call takes a form by shape (gcn_kernels.form), in either element
// type:
//  - The valid-rows form (n <= 64; every configuration: N = 64).
//  - The two-pass form (n > 64): the projection over all rows into z in
//    device memory, then a star pass.
//
// What bounds K5 on an H100, at config.mag.json's PGCN shapes (4096
// egonets of N = 64, 250 + 50 -> 500 with the leaky, 500 + 50 -> 500
// without; pos_mode "concat": 300 and 550 input columns): the layer's
// products and its bytes are of one size. Of the B*N = 262,144 rows only
// the valid ones reach the output (R = 132,501 in the smoke's batch,
// PERF.md), so layer 0's float32 train forward needs 2 R 300 500 = 39.8
// GFLOP, 0.24 ms at the 3xTF32 rate, against 0.23 ms for x read and out
// written (0.79 GB at 3.35 TB/s). The two-pass form spends more than twice
// that: the projection over all B*N rows, z [B*N, 500] written and read
// back in float32 (1.05 GB, 0.31 ms), and in the backward the dz pass, dW
// and dx over all rows too. The valid-rows form does only the needed work:
//
// Forward, two passes:
//  rows + stage  the valid rows of whole egonets packed into 64-row tiles
//                in egonet order (packed_row_offsets_kernel: next fit, so
//                no egonet straddles a tile; about 0.69 of B*N in the
//                smoke's batch), staged with their own masks, each packed
//                row's original row and (slot, ngp, the egonet's first row
//                in the tile) recorded (stage_packed_rows_kernel), the
//                invalid rows' output act(b) written; W and z_bias packed;
//  product       X @ W on the packed rows (counted on the card: no host
//                sync) with the star pass in its epilogue
//                (gemm_wgmma.cuh:kEpiGcn): each consumer warpgroup's tile
//                holds whole egonets' products; the epilogue adds z_bias
//                by slot, takes the closed-form norms, the anchor's gp sum
//                and the siblings' anchor term, the bias and the leaky, and
//                writes the output once, at the original rows. z never
//                reaches device memory. bf16 runs it on its C tile; the
//                float32 ring (3xTF32) has room beside its four stages for
//                a 64-column half of the z tile only, so its consumers
//                stage z a half at a time through 16 KB of shared memory
//                (gemm_wgmma.cuh says why not fewer stages). The output
//                has the two-pass form's bits.
// Backward: the valid rows counted and compacted on the card (K4's
// valid_row_offsets_kernel and stage_valid_rows_kernel: dx and the pe
// rows' grads zeroed on the invalid rows, zero rows after the R valid
// ones), W packed; z recomputed on the R rows where leaky' needs it; the
// dz pass (gcn_star_bwd_rows_kernel, a thread a column) writing dz once,
// in E, compacted, with the per-egonet g2 sums for db; db and d z_bias
// from fixed-order chunked partials (bf16: the float32 dz the pass also
// writes in the original layout; float32: the compacted dz itself, summed
// by slot in the two-pass form's chunks and order,
// colsum_valid_rows_kernel); dW and dx on the R rows (dx scattered through
// the row map). dx, db and d z_bias have the two-pass form's bits; dW sums
// its rows in other split-K groups.
//
// The two-pass form, two launches and a small preparation (as gat_fwd.cu
// runs K1):
//  1. X staged once into a workspace, each mask bit hashed once, where the
//     layer has masks or a pe path or x's rows are not 16-byte multiples
//     (else the product reads x), and W = [W_h; W_p] packed; then the
//     projection z = X @ W + z_bias over all B*N rows into a workspace
//     [B*N, ldd] (ldd = dout rounded up to a 16-byte multiple, zero in the
//     padding columns), on the tensor cores (gemm_wgmma.cuh, shared with
//     K1-K4: bwd_common.cuh:gat_projection with W alone and z_bias as the
//     slot bias).
//  2. The star pass, one block per (egonet, 128-column tile), each thread
//     a column: the star sum with the closed-form norms, the bias and the
//     activation, out written once for all N rows; only the valid rows of
//     z are read (an invalid row's output is act(b)).
// Its backward, one C entry point launching in order: X staged and W
// packed (W^T for the dx product and, with an activation, W for the
// projection); with an activation z recomputed by the forward's own
// projection on the same X, so leaky' is taken at the forward's
// pre-activation, bit for bit; the dz star pass (g2 = g times leaky'(pre +
// b), dz = norm * copy_src_sum^T(norm * g2) written over the z workspace
// in place, zero in the padding columns and on invalid rows, and the
// per-egonet column sums of g2 for db); db and d z_bias (bwd_common.cuh's
// chunked sums); dW = X^T @ dz split-K, dx = (dz @ W_h^T) * m (need_dx)
// and dpe = sum over egonets of (dz @ W_p^T) * m_pe (bwd_common.cuh).
// Deterministic in every form: no atomics.
//
// The bf16 form (fused_gcn_layer with x in bf16; `*_bf16` entry points):
// x, W_h, the output, the incoming grad g, dx and dW in bf16, with the
// reference's roundings (pallas_gcn.py:69-78, :124-126, :163, :209-223): X
// staged as x times its mask rounded to bf16, the pe rows times their
// float32 mask rounded to bf16, W_p packed in bf16; the products on bf16
// wgmma with float32 accumulation, so z is float32 (the backward's
// recompute reruns the product on the same staged X, so leaky' is taken at
// the forward's bits); the star passes in float32, the output rounded to
// bf16; g upcast; dz rounded to bf16 after the float32 db / d z_bias sums,
// for dW = X^T @ dz (the x rows rounded to bf16, the pe rows' dW_p
// float32) and dX = dz @ W^T (dx times its float32 mask, rounded to bf16;
// the pe columns' grads float32); the two-pass form casts its float32 dz
// to bf16 once (as K2's cast of D). Rows of z, W and dz hold 8 bf16 a
// 16-byte chunk: ldd, kxp and ntp round to 8. The float32 form's products
// run in 3xTF32 on the same ring (gemm_tf32.cuh).

#include "bwd_common.cuh"

using gat::bf16;

namespace gat {

// dst [count] = src rounded to bf16 (count a multiple of 4): the two-pass
// form's dz cast once for the bf16 dW and dx products (pallas_gcn.py:
// 209-223).
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
// wt, dzp).
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
  E* wcat;              // [kxp, ldd] W for the projection (float32: W^T
                        // planes [2, ldd, kxp]), or null (the backward of
                        // a layer without activation)
  float* biascat;       // [n, ldd] z_bias in the projection's layout
  E* wt;                // [ldd, ntp] W^T over the dx product's columns
                        // (float32: W's rows, planes [2, ntp, ldd])
  E* dzp;               // the products' dz: the valid-rows form's
                        // [b*n + kRowPad, ldd], dz of the valid rows,
                        // compacted; the bf16 two-pass form's [b*n, ldd],
                        // dz cast to bf16; else null (the products read z)
  // the valid-rows form (null: the two-pass form):
  int* row_off;         // [b + 1] each egonet's first valid row, the rows'
                        // count last
  int* row_map;         // [rows + kRowPad] the original row of each
  int* row_info;        // forward: [rows + kRowPad] StarArgs::row_info
  float* dzf;           // bf16 backward with need_dzb: [b*n, ldd] float32
                        // dz
  float* bt;            // float32 backward: the dW product's B planes
                        // (bwd_common.cuh:dw_operands)
  int b, n, din, dout, p, has_alpha, need_dx, need_dzb, splits, chunks;
  int kxp, ldd, ntp;    // ldd: z's row stride, dout rounded up to a
                        // 16-byte multiple of E
  int rows;             // the valid-rows forward: packed rows allocated
                        // (before the kRowPad after them)
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

// ------------------------------------------------- the valid-rows form
// (bf16, n <= 64). Forward: the valid rows of whole egonets packed into
// 64-row tiles, the product with the star pass in its epilogue. Backward:
// the valid rows compacted (K4 bf16's), the dz pass writing dz once in
// bf16.

constexpr int kPackTile = 64;     // rows of a warpgroup's tile
constexpr int kPackChunks = 128;  // runs of egonets of the packing's scan

// off[b] = egonet b's first packed row, off[nb] = the packed rows' count T:
// the egonets in order, each one's valid rows (grandparents, anchor,
// siblings) contiguous, an egonet that does not fit the rest of its
// 64-row tile starting the next (next fit), so that no egonet straddles a
// tile. One block: each of kPackChunks runs of egonets is walked from
// every start place in a tile (0..64) at once, the runs' starts then
// chained by one thread, and each run walked again from its start.
__global__ void __launch_bounds__(1024)
packed_row_offsets_kernel(const int* __restrict__ ngp,
                          const int* __restrict__ nsib, int nb, int n, int p,
                          int* __restrict__ off) {
  __shared__ unsigned char end_pos[kPackChunks][kPackTile + 1];
  __shared__ int adv[kPackChunks][kPackTile + 1];
  __shared__ int start_pos[kPackChunks], start_tile[kPackChunks];
  const int per = (nb + kPackChunks - 1) / kPackChunks;
  auto count = [&](int b) {
    return min(max(ngp[b], 0), p) + 1 + min(max(nsib[b], 0), n - p - 1);
  };
  // (pos, tiles) after the run's egonets [b0, b1) from place pos
  auto walk = [&](int b0, int b1, int& pos, int& tiles, int* out) {
    for (int b = b0; b < b1; ++b) {
      const int c = count(b);
      if (pos + c > kPackTile) ++tiles, pos = 0;
      if (out != nullptr) out[b] = tiles * kPackTile + pos;
      pos += c;
    }
  };
  for (int e = threadIdx.x; e < kPackChunks * (kPackTile + 1);
       e += blockDim.x) {
    const int k = e / (kPackTile + 1), s = e % (kPackTile + 1);
    int pos = s, tiles = 0;
    walk(min(nb, k * per), min(nb, (k + 1) * per), pos, tiles, nullptr);
    end_pos[k][s] = (unsigned char)pos;
    adv[k][s] = tiles;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int pos = 0, tiles = 0;
    for (int k = 0; k < kPackChunks; ++k) {
      start_pos[k] = pos, start_tile[k] = tiles;
      tiles += adv[k][pos];
      pos = end_pos[k][pos];
    }
    off[nb] = tiles * kPackTile + pos;
  }
  __syncthreads();
  if (threadIdx.x < kPackChunks) {
    const int k = threadIdx.x;
    int pos = start_pos[k], tiles = start_tile[k];
    walk(min(nb, k * per), min(nb, (k + 1) * per), pos, tiles, off);
  }
}

// The forward's rows, a warp a row of the m = nb*n rows: a valid row r of
// egonet b staged as stage_input_kernel stages it (its own masks) into xp
// at its packed row off[b] + q (q: its place among the egonet's valid
// rows), which row_map (r) and row_info (slot | ngp << 8 | the egonet's
// first row in its tile << 16) record; an invalid row's output act(b)
// (norm 0), in E.
template <bool kAct, class E>
__global__ void stage_packed_rows_kernel(
    OperandT<E> op, TrainArgs ta, const int* __restrict__ ngp,
    const int* __restrict__ nsib, int p, const int* __restrict__ off, int nb,
    E* __restrict__ xp, int kxp, int* __restrict__ row_map,
    int* __restrict__ row_info, const float* __restrict__ bias,
    E* __restrict__ out, int dout, float alpha) {
  const unsigned kf = stream_key(ta.seed, kStreamFeat);
  const unsigned kp = stream_key(ta.seed, kStreamPe);
  const int n = op.n;
  const long long m = (long long)nb * n;
  const int warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  for (long long r = (long long)blockIdx.x * warps + (threadIdx.x >> 5);
       r < m; r += (long long)gridDim.x * warps) {
    const long long b = r / n;
    const int slot = (int)(r % n);
    const int g = min(max(ngp[b], 0), p);
    const int q = valid_pos(slot, g, min(max(nsib[b], 0), n - p - 1), p);
    if (q < 0) {
      E* o = out + r * dout;
      if (sizeof(E) == 2 && dout % 2 == 0) {
        for (int k = 2 * lane; k < dout; k += 64)
          *reinterpret_cast<__nv_bfloat162*>(o + k) = __floats2bfloat162_rn(
              act<kAct>(bias[k], alpha), act<kAct>(bias[k + 1], alpha));
      } else {
        for (int k = lane; k < dout; k += 32)
          o[k] = from_float<E>(act<kAct>(bias[k], alpha));
      }
      continue;
    }
    const int o = off[b];
    const long long ci = o + q;
    if (lane == 0) {
      row_map[ci] = (int)r;
      row_info[ci] = slot | (g << 8) | ((o % kPackTile) << 16);
    }
    stage_row(op, ta, kf, kp, r, xp + ci * kxp, kxp, lane);
  }
}

// The valid-rows backward's dz pass: blocks as gcn_star_bwd_kernel's, the
// same arithmetic in the same order, with z read from the compacted valid
// rows (row_off) and dz written there once in E (zero in the padding
// columns), g of element type E upcast; the column sums of g2 over all
// rows into g2sum; with dzf (bf16) the float32 dz in the original layout
// (zero on invalid rows) for d z_bias. A thread a column: four columns a
// thread (8- and 16-byte loads) took 10-25 % longer in bf16 on an NVIDIA
// H100 80GB HBM3 at 700 W (PERF.md).
template <bool kAct, class E>
__global__ void __launch_bounds__(kStarCols)
gcn_star_bwd_rows_kernel(const float* __restrict__ z, int ldd,
                         const E* __restrict__ g,
                         const float* __restrict__ bias,
                         const int* __restrict__ ngp_arr,
                         const int* __restrict__ nsib_arr,
                         const int* __restrict__ row_off,
                         E* __restrict__ dzc, float* __restrict__ g2sum,
                         float* __restrict__ dzf, int n, int dout, int p,
                         float alpha) {
  const int ntiles = (ldd + kStarCols - 1) / kStarCols;
  const long long b = blockIdx.x / ntiles;
  const int c = (blockIdx.x % ntiles) * kStarCols + threadIdx.x;
  if (c >= ldd) return;
  const int ngp = min(max(ngp_arr[b], 0), p);
  const int nsib = min(max(nsib_arr[b], 0), n - p - 1);
  const long long base = row_off[b];
  E* dc = dzc + base * ldd + c;                  // valid row q
  float* fc = dzf != nullptr ? dzf + (size_t)b * n * ldd + c : nullptr;
  if (c >= dout) {  // the padding columns the products read
    for (int q = 0; q < ngp + 1 + nsib; ++q)
      dc[(size_t)q * ldd] = from_float<E>(0.f);
    if (fc != nullptr)
      for (int r = 0; r < n; ++r) fc[(size_t)r * ldd] = 0.f;
    return;
  }
  const float na = rsqrtf(1.f + (float)ngp), ns = rsqrtf(2.f);
  const float* zc = z + base * ldd + c;
  const E* gc = g + (size_t)b * n * dout + c;
  const auto grow = [&](int r) { return to_float(gc[(size_t)r * dout]); };
  const auto zrow = [&](int q) { return zc[(size_t)q * ldd]; };
  const auto put = [&](int q, int r, float v) {  // valid row q, slot r
    dc[(size_t)q * ldd] = from_float<E>(v);
    if (fc != nullptr) fc[(size_t)r * ldd] = v;
  };
  const auto zero = [&](int r) {
    if (fc != nullptr) fc[(size_t)r * ldd] = 0.f;
  };
  const int sq = ngp - p;  // a sibling slot's valid row: slot + sq
  const float bc = bias[c];
  float za = 0.f, pre_a = 0.f;
  if (kAct) {  // the anchor's pre-activation, from the forward's z
    za = zrow(ngp) * na;
    float acc = za;
    row_batches<float>(0, ngp, zrow, [&](int, float v) { acc += v; });
    pre_a = acc * na + bc;
  }
  const float ga = through_act<kAct>(pre_a, grow(p), alpha);
  const float ga_n = ga * na;
  float sum = 0.f;  // db's column sum over all rows, in row order
  row_batches<float2>(
      0, ngp,
      [&](int r) { return make_float2(grow(r), kAct ? zrow(r) : 0.f); },
      [&](int r, float2 v) {
        const float gr = through_act<kAct>(v.y + bc, v.x, alpha);
        sum += gr;
        put(r, r, gr + ga_n);
      });
  row_batches<float>(ngp, p, grow, [&](int r, float v) {
    sum += through_act<kAct>(bc, v, alpha);
    zero(r);
  });
  sum += ga;
  float anc = ga_n;  // the anchor's dz: self and the valid sibs
  row_batches<float2>(
      p + 1, p + 1 + nsib,
      [&](int r) { return make_float2(grow(r), kAct ? zrow(r + sq) : 0.f); },
      [&](int r, float2 v) {
        const float gr =
            through_act<kAct>((v.y * ns + za) * ns + bc, v.x, alpha);
        sum += gr;
        anc += gr * ns;
        put(r + sq, r, gr * ns * ns);
      });
  row_batches<float>(p + 1 + nsib, n, grow, [&](int r, float v) {
    sum += through_act<kAct>(bc, v, alpha);
    zero(r);
  });
  put(ngp, p, anc * na);
  g2sum[b * dout + c] = sum;
}

// part[c][s * ldd + col] = the sum over the egonets of chunk c, in order,
// of column col of slot s's dz row, read from the compacted valid rows
// (row_off; the invalid slots skipped): colsum_partial_kernel's sum over
// dz in the original layout, where those rows hold +0, bit for bit (a sum
// from +0 never becomes -0, so adding +0 changes no bit).
__global__ void colsum_valid_rows_kernel(const float* __restrict__ dz,
                                         int ldd, const int* __restrict__ ngp,
                                         const int* __restrict__ nsib,
                                         const int* __restrict__ row_off,
                                         long long nb, int n, int p,
                                         long long chunk_b,
                                         float* __restrict__ part) {
  const long long rw = (long long)n * ldd;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rw) return;
  const int s = (int)(i / ldd), col = (int)(i % ldd);
  const long long b0 = blockIdx.y * chunk_b;
  const long long b1 = min(nb, b0 + chunk_b);
  float sum = 0.f;
  for (long long bb = b0; bb < b1; ++bb) {
    const int q = valid_pos(s, min(max(ngp[bb], 0), p),
                            min(max(nsib[bb], 0), n - p - 1), p);
    if (q >= 0) sum += dz[((long long)row_off[bb] + q) * ldd + col];
  }
  part[blockIdx.y * rw + i] = sum;
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

template <class E>
cudaError_t layer_fwd_rows(const GcnArgsT<E>& a, const TrainArgs& ta,
                           cudaStream_t st);
template <class E>
cudaError_t layer_bwd_rows(const GcnArgsT<E>& a, const TrainArgs& ta,
                           cudaStream_t st);

// The forward: the projection, then the star pass (the valid-rows form:
// layer_fwd_rows).
template <class E>
cudaError_t layer_fwd(const GcnArgsT<E>& a, const TrainArgs& ta,
                      cudaStream_t st) {
  const long long m = (long long)a.b * a.n;
  if (m == 0) return cudaSuccess;
  if (a.row_off != nullptr) return layer_fwd_rows(a, ta, st);
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

// The forward's valid-rows form: the packed rows' offsets and tables; the
// rows staged, the invalid rows' outputs, W and z_bias packed; the product
// over the packed rows with the star pass in its epilogue
// (gemm_wgmma.cuh:kEpiGcn, on the bf16 or the 3xTF32 kernel). Marks
// before, between and after.
template <class E>
cudaError_t layer_fwd_rows(const GcnArgsT<E>& a, const TrainArgs& ta,
                           cudaStream_t st) {
  const long long m = (long long)a.b * a.n;
  if (a.xm == nullptr || a.wcat == nullptr || a.biascat == nullptr ||
      a.row_map == nullptr || a.row_info == nullptr || a.n > kPackTile ||
      (long long)a.rows + kRowPad > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const OperandT<E> op = layer_operand(a, ta);
  const size_t table = sizeof(int) * ((size_t)a.rows + kRowPad);
  mark(g_fwd_marks, st);
  packed_row_offsets_kernel<<<1, 1024, 0, st>>>(a.ngp, a.nsib, a.b, a.n, a.p,
                                                a.row_off);
  cudaError_t err = cudaMemsetAsync(a.row_map, 0xff, table, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(a.row_info, 0xff, table, st);
  if (err != cudaSuccess) return err;
  mark(g_fwd_marks, st);
  const unsigned grid = grid_for(m * 32);  // 8 rows a block of 256 threads
  if (a.has_alpha)
    stage_packed_rows_kernel<true, E><<<grid, 256, 0, st>>>(
        op, ta, a.ngp, a.nsib, a.p, a.row_off, a.b, a.xm, a.kxp, a.row_map,
        a.row_info, a.bias, a.out, a.dout, a.alpha);
  else
    stage_packed_rows_kernel<false, E><<<grid, 256, 0, st>>>(
        op, ta, a.ngp, a.nsib, a.p, a.row_off, a.b, a.xm, a.kxp, a.row_map,
        a.row_info, a.bias, a.out, a.dout, a.alpha);
  const ProductWorkT<E> pack = {nullptr, nullptr, nullptr, a.kxp, a.ldd,
                                0,       1};  // X staged above
  err = stage_and_pack(op, ta, m, pack, 0, a.wcat, st);
  if (err != cudaSuccess) return err;
  pack_bias_kernel<<<grid_for((long long)a.n * a.ldd), 256, 0, st>>>(
      a.z_bias, nullptr, nullptr, a.n, a.dout, a.dout, a.dout, a.ldd,
      a.biascat);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mark(g_fwd_marks, st);
  GemmArgsT<E> g = {};
  g.a = a.xm;
  g.lda = a.kxp;
  g.b = a.wcat;
  g.ldb = a.ldd;
  if constexpr (sizeof(E) == 4) {  // W^T planes [2][ldd][kxp]
    g.b_lo = a.wcat + (long long)a.ldd * a.kxp;
    g.ldb = a.kxp;
  }
  g.ldc = a.ldd;  // z_bias's row stride
  g.m = (long long)a.rows + kRowPad;
  g.n = a.dout;
  g.k = a.kxp;
  g.k_chunk = a.kxp;
  g.bias = a.biascat;
  g.bias_rows = a.n;
  g.rows = a.row_off + a.b;
  g.row_map = a.row_map;
  StarArgs sa = {};
  sa.ngp = a.ngp;
  sa.b = a.b;
  sa.n = a.n;
  sa.p = a.p;
  sa.out_alpha = a.alpha;
  sa.has_out_alpha = a.has_alpha;
  sa.row_info = a.row_info;
  sa.bias = a.bias;
  if constexpr (sizeof(E) == 2) {
    sa.out = a.out;
    err = product_wgmma<true, kEpiGcn, 128>(g, TrainArgs{}, 1, sa, st);
  } else {
    sa.out_f = a.out;
    err = product_wgmma_f32<true, kEpiGcn, 128>(g, TrainArgs{}, 1, sa, st);
  }
  mark(g_fwd_marks, st);
  return err;
}

// The backward's valid-rows form: the valid rows counted, compacted and
// staged (dx and the pe rows' grads zeroed on the invalid rows, the
// kRowPad rows after them zero in X and dz), W packed; z recomputed on
// them; the dz pass into dz of E; the db / d z_bias sums; dW and dx on the
// valid rows. Marks before and after each.
template <class E>
cudaError_t layer_bwd_rows(const GcnArgsT<E>& a, const TrainArgs& ta,
                           cudaStream_t st) {
  constexpr bool kBf16 = sizeof(E) == 2;
  const long long m = (long long)a.b * a.n;
  const bool act = a.has_alpha != 0;
  if (a.xm == nullptr || a.dzp == nullptr || a.row_map == nullptr ||
      (act && a.z == nullptr) || (kBf16 && a.need_dzb && a.dzf == nullptr) ||
      m + kRowPad > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const OperandT<E> op = layer_operand(a, ta);
  const ProductWorkT<E> work = {a.xm,  a.wt,  a.part_w, a.kxp,
                                a.ldd, a.ntp, a.splits, a.bt};
  const int* rows = a.row_off + a.b;
  cudaError_t err;

  mark(g_bwd_marks, st);
  valid_row_offsets_kernel<<<1, 1024, 0, st>>>(a.ngp, a.nsib, a.b, a.n, a.p,
                                               a.row_off);
  stage_valid_rows_kernel<E, E><<<grid_for((m + kRowPad) * 32), 256, 0, st>>>(
      op, ta, a.ngp, a.nsib, a.p, a.row_off, a.b, a.xm, a.kxp, a.row_map,
      a.need_dx ? a.dx : nullptr, a.pe_rows, a.dzp, a.ldd);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ProductWorkT<E> pack = work;
  pack.xm = nullptr;  // staged above
  err = stage_and_pack(op, ta, m, pack, a.need_dx ? 0 : a.din,
                       act ? a.wcat : nullptr, st);
  if (err != cudaSuccess) return err;
  mark(g_bwd_marks, st);
  if (act) {  // z recomputed on the valid rows for leaky'
    err = gat_projection(op, a.xm, a.kxp, a.wcat, a.ldd, a.z_bias, nullptr,
                         nullptr, a.biascat, a.z, m, st, rows, a.row_map);
    if (err != cudaSuccess) return err;
  }
  mark(g_bwd_marks, st);

  const unsigned blocks = star_blocks(a.b, a.ldd);
  if (blocks == 0) return cudaErrorInvalidValue;
  // bf16: the float32 dz for d z_bias beside the bf16 one; float32 sums
  // the compacted dz itself
  float* dzf = kBf16 && a.need_dzb ? a.dzf : nullptr;
  if (act)
    gcn_star_bwd_rows_kernel<true, E><<<blocks, kStarCols, 0, st>>>(
        a.z, a.ldd, a.g, a.bias, a.ngp, a.nsib, a.row_off, a.dzp, a.g2sum,
        dzf, a.n, a.dout, a.p, a.alpha);
  else
    gcn_star_bwd_rows_kernel<false, E><<<blocks, kStarCols, 0, st>>>(
        a.z, a.ldd, a.g, a.bias, a.ngp, a.nsib, a.row_off, a.dzp, a.g2sum,
        dzf, a.n, a.dout, a.p, a.alpha);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mark(g_bwd_marks, st);

  err = sum_over_egonets(a.g2sum, a.b, 1, a.dout, a.dout, a.chunks,
                         a.part_b, a.db, st);
  if (err != cudaSuccess) return err;
  if (a.need_dzb) {
    if constexpr (kBf16) {
      err = sum_over_egonets(a.dzf, a.b, a.n, a.ldd, a.dout, a.chunks,
                             a.part_b, a.dzb, st);
    } else {  // the two-pass form's chunks and order over the valid rows
      const long long rw = (long long)a.n * a.ldd;
      colsum_valid_rows_kernel<<<dim3(blocks_for(rw), a.chunks), kThreads,
                                 0, st>>>(
          a.dzp, a.ldd, a.ngp, a.nsib, a.row_off, a.b, a.n, a.p,
          (a.b + a.chunks - 1) / a.chunks, a.part_b);
      reduce_scatter_kernel<float><<<blocks_for(rw), kThreads, 0, st>>>(
          a.part_b, a.chunks, a.n, a.ldd, a.n, a.dout, a.dout, a.dout, a.dzb,
          nullptr, nullptr, nullptr, nullptr, nullptr);
      err = cudaGetLastError();
    }
    if (err != cudaSuccess) return err;
  }
  mark(g_bwd_marks, st);
  E* const dw[3] = {a.dw, nullptr, nullptr};
  float* const dwp[3] = {a.dwp, nullptr, nullptr};
  return product_grads(op, ta, (const E*)a.dzp, a.ldd, m, work, a.chunks,
                       dw, dwp, a.need_dx, a.dx, a.pe_rows, a.part_pe,
                       a.dpe, g_bwd_marks, st, rows, a.row_map);
}

// The backward: every pass in order on st (the valid-rows form:
// layer_bwd_rows).
template <class E>
cudaError_t layer_bwd(const GcnArgsT<E>& a, const TrainArgs& ta,
                      cudaStream_t st) {
  const long long m = (long long)a.b * a.n;
  if (m == 0) return cudaSuccess;
  if (a.row_off != nullptr) return layer_bwd_rows(a, ta, st);
  const bool act = a.has_alpha != 0;
  const OperandT<E> op = layer_operand(a, ta);
  const ProductWorkT<E> work = {a.xm,  a.wt,  a.part_w, a.kxp,
                                a.ldd, a.ntp, a.splits, a.bt};
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
    cast_bf16_kernel<<<grid_for(m * a.ldd / 4), 256, 0, st>>>(a.z, a.dzp,
                                                             m * a.ldd);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    d = a.dzp;
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
// dw and the workspaces xm, wcat, wt, dzp), every other field as in the
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
