// The layer products of a bf16 star layer on Hopper's tensor cores: bf16
// operands, float32 accumulation, mma.sync.m16n8k16 (the products of
// pallas_gat.py:283-305 and of _bwd_epilogue :607-651, which take bf16
// operands and accumulate in float32: jnp.dot(...,
// preferred_element_type=float32)). One MMA a 16 x 8 x 16 step where the
// float32 layers' 3xTF32 product (gemm_tf32.cuh) runs three of 16 x 8 x 8.
//
// What bounds it on an H100: the tensor cores and the path that feeds them
// (989 TFLOP/s dense bf16 on the data sheet; mma.sync reaches less of it
// than wgmma). The products are large (config.mag.json layer 0: 262,144
// rows x 304 x 2008), so device-memory bytes do not bound them: each
// operand tile is read once and reused from shared memory across a 128 x
// 128 output tile.
//
// Accuracy: as in gemm_tf32.cuh, each 64-deep K tile is summed into a
// fresh register tile and added to the running sum with a float32 FADD
// (round to nearest), so the tensor cores' truncating accumulation reaches
// only 64-deep partial sums.
//
// Design: gemm_tf32.cuh's pipeline (gemm_kernel, its ring, tiles and
// epilogues) with this file's MmaStep<bf16> as the inner step over a K
// tile: 8 bf16 a 16-byte chunk, fragments from shared memory by ldmatrix.
// K-major A (row-major [M][K]: the projection's X, the dx product's D) as
// it lies; M-major A ([K][M]: X read as X^T by the dW product) and
// row-major B ([K][N]) transposed by ldmatrix.trans. The epilogues write
// float32: P with its slot biases, the split-K dW partials; the dx
// epilogue rounds the x columns' grad to bf16 after its float32 mask, the
// pe columns' grad stays float32. Deterministic: no atomics.
#pragma once

#include "gemm_tf32.cuh"

namespace gat {

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8; register q of a thread holds its two elements
// of matrix q (row lane / 4, columns 2 (lane % 4) and + 1), or with .trans
// of the transposed matrix.
__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The bf16 step of the product (gemm_tf32.cuh:gemm_kernel): a warp's
// mma.sync.m16n8k16 products over one K tile, fragments by ldmatrix.
template <>
struct MmaStep<bf16> {
  template <class T, bool kAKMajor>
  static __device__ __forceinline__ void tile(
      const bf16* as, const bf16* bs, int wm, int wn, int lane,
      float (&part)[T::MI][T::NI][4]) {
    constexpr int MI = T::MI, NI = T::NI;
    static_assert(NI % 2 == 0, "B fragments are loaded two n-tiles at once");
    // ldmatrix addressing: lane l gives row l % 8 of matrix l / 8
    const int lrow = lane & 7, lmat = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < T::BK; kk += 16) {
      // B fragments, two n-tiles an ldmatrix: matrices (k, n), (k + 8, n),
      // (k, n + 8), (k + 8, n + 8), each transposed
      unsigned bfr[NI][2];
#pragma unroll
      for (int ni = 0; ni < NI; ni += 2) {
        const int krow = kk + lrow + ((lmat & 1) ? 8 : 0);
        const int ncol = wn * NI * 8 + ni * 8 + ((lmat & 2) ? 8 : 0);
        unsigned r[4];
        ldmatrix_x4_trans(r, bs + krow * T::B_STRIDE + ncol);
        bfr[ni][0] = r[0], bfr[ni][1] = r[1];
        bfr[ni + 1][0] = r[2], bfr[ni + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r0 = wm * MI * 16 + mi * 16;
        unsigned af[4];  // rows r0 / r0 + 8, k columns kk / kk + 8
        if (kAKMajor) {
          ldmatrix_x4(af, as + (r0 + (lane & 15)) * T::A_STRIDE_K + kk +
                              (lane >> 4) * 8);
        } else {
          const int krow = kk + lrow + ((lmat & 2) ? 8 : 0);
          ldmatrix_x4_trans(af, as + krow * T::A_STRIDE_M + r0 +
                                    ((lmat & 1) ? 8 : 0));
        }
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_bf16(part[mi][ni], af, bfr[ni]);
      }
    }
  }
};

// dst [count] = src rounded to bf16 (count a multiple of 4): the grad of
// the layer's product cast once for the dW and dx products
// (pallas_gat.py:628-631).
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
