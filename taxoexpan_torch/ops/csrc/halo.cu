// K6, the halo gather of the row-partitioned feature table, for Hopper
// (sm_90a), and the CUDA IPC plumbing that lets one rank read its peers'
// shards.
//
// Replaces the Pallas ring kernel of taxoexpan_tpu/parallel/halo.py:
//   halo_gather (float32 or bf16 shards) <- ring_exchange (:195,
//                                           _ring_kernel :69)
// Semantics (the middle of partitioned_gather): rank i holds req [P, cap]
// int32, its requests bucketed by owner as local slots, and owner j holds
// shard_j [rows, D] (the global rows {g : g % P == j} at slot g / P). The
// result is ans [P, cap, D] float32 with
//   ans[j, r, :] = shard_j[req[j, r], :]  for 0 <= req[j, r] < rows,
//   ans[j, r, :] = 0                      otherwise.
// Out-of-range slots are the dedup padding slots (routed by position, so
// their local slot runs far past the shard); the ring kernel's one-hot
// product yields zero rows for them, and here they are written as zeros
// without a load: a load there would read another allocation, or another
// process's memory.
//
// Design: a pull instead of the TPU's push. The TPU design sends request
// buckets to their owners by RDMA, answers with a one-hot matmul (Mosaic has
// no row gather) and RDMAs the answers back into double-buffered slabs
// behind a barrier semaphore. On Hopper a peer's memory is reached by plain
// loads: between processes on one card through a CUDA IPC mapping of the
// owner's allocation, between cards of one host over NVLink (the mapping
// enables peer access). So rank i's kernel reads shard_j[req[i, j, r]]
// straight through owner j's mapped base pointer: no request traffic, no
// scratch in the peers and no flags. The table is static during training,
// so one barrier after the shards are placed (before any read) and one
// before an owner frees its shard (after every read) are all the ordering
// it needs; both live on the host (parallel/halo.py). Two ranks on one card
// without MPS time-slice their kernels; nothing here waits on a peer.
//
// One warp per output row: the lanes copy D values with vector loads of
// 16, 8 or 4 bytes (the widest the row width and the base pointers' alignment
// allow), converted to float32 (bf16 shards widen for free in the copy).
// What bounds it on an H100: bytes. At the data-parallel path's shapes
// (P = 2, n = 2048 egonets x 64 slots per rank, cap = n, D = 250) one call
// writes 2 x 131072 x 250 x 4 = 262 MB of ans and reads each distinct
// in-range row once: at most P x rows x D x 4 bytes (0.8 MB on the smoke's
// 800-node taxonomy), since the dedup asks for a row at most once a
// bucket. About 0.08 ms at 3.35 TB/s; the ranks' requests are dominated by
// the padding slots, which cost only their zero writes.
//
// The shards live in their own cudaMalloc allocations (halo_alloc), not in
// blocks of PyTorch's caching allocator: cudaIpcGetMemHandle maps a whole
// allocation, and a shard carved from a larger cached block would sit at an
// offset inside it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// W float32 values as one vector store.
template <int W>
struct FloatVec;
template <>
struct FloatVec<1> {
  using type = float;
  static __device__ __forceinline__ type make(const float* v) { return v[0]; }
};
template <>
struct FloatVec<2> {
  using type = float2;
  static __device__ __forceinline__ type make(const float* v) {
    return make_float2(v[0], v[1]);
  }
};
template <>
struct FloatVec<4> {
  using type = float4;
  static __device__ __forceinline__ type make(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

// W consecutive values of a row, as float32.
template <typename T, int W>
__device__ __forceinline__ void load_vec(const T* src, long long c,
                                         float* out);

template <>
__device__ __forceinline__ void load_vec<float, 1>(const float* src,
                                                   long long c, float* out) {
  out[0] = src[c];
}
template <>
__device__ __forceinline__ void load_vec<float, 2>(const float* src,
                                                   long long c, float* out) {
  const float2 v = reinterpret_cast<const float2*>(src)[c];
  out[0] = v.x;
  out[1] = v.y;
}
template <>
__device__ __forceinline__ void load_vec<float, 4>(const float* src,
                                                   long long c, float* out) {
  const float4 v = reinterpret_cast<const float4*>(src)[c];
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 1>(
    const __nv_bfloat16* src, long long c, float* out) {
  out[0] = __bfloat162float(src[c]);
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 2>(
    const __nv_bfloat16* src, long long c, float* out) {
  const float2 f =
      __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(src)[c]);
  out[0] = f.x;
  out[1] = f.y;
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 4>(
    const __nv_bfloat16* src, long long c, float* out) {
  const uint2 raw = reinterpret_cast<const uint2*>(src)[c];
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &raw.x, sizeof lo);
  memcpy(&hi, &raw.y, sizeof hi);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

template <int W>
__device__ __forceinline__ void store_vec(float* dst, long long c,
                                          const float* v) {
  reinterpret_cast<typename FloatVec<W>::type*>(dst)[c] =
      FloatVec<W>::make(v);
}

template <int W>
__device__ __forceinline__ void store_zero(float* dst, long long c) {
  reinterpret_cast<typename FloatVec<W>::type*>(dst)[c] =
      typename FloatVec<W>::type{};
}

// shards: device array of P base pointers (own shard and IPC-mapped peers);
// req [P, cap]; ans [P, cap, d]. W divides d.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
    halo_gather_kernel(const T* const* __restrict__ shards, int p,
                       long long rows, int d, const int* __restrict__ req,
                       long long cap, float* __restrict__ ans) {
  const long long total = (long long)p * cap;
  const int lane = threadIdx.x & 31;
  const long long dv = d / W;
  for (long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       row < total; row += (long long)gridDim.x * kWarps) {
    float* dst = ans + row * d;
    const int slot = req[row];
    if (slot < 0 || (long long)slot >= rows) {
      for (long long c = lane; c < dv; c += 32) store_zero<W>(dst, c);
      continue;
    }
    const T* src = shards[row / cap] + (long long)slot * d;
    for (long long c = lane; c < dv; c += 32) {
      float v[W];
      load_vec<T, W>(src, c, v);
      store_vec<W>(dst, c, v);
    }
  }
}

template <typename T, int W>
cudaError_t launch(const void* const* shards, int p, long long rows, int d,
                   const int* req, long long cap, float* ans,
                   cudaStream_t stream) {
  const long long total = (long long)p * cap;
  if (total == 0) return cudaSuccess;
  long long blocks = (total + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
  halo_gather_kernel<T, W><<<(unsigned)blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const T* const*>(shards), p, rows, d, req, cap, ans);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* halo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The gather. elem_bytes: 4 (float32 shards) or 2 (bf16); vec: the values
// a lane moves at once, 1, 2 or 4, chosen by the caller so that it divides
// d and every shard's base, ans and the rows stay aligned to vec values
// (ops/halo_kernels.py). Returns cudaGetLastError() after the launch.
int halo_gather(const void* const* shards, int p, long long rows, int d,
                const int* req, long long cap, float* ans, int elem_bytes,
                int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 4) {
    if (vec == 4)
      return launch<float, 4>(shards, p, rows, d, req, cap, ans, s);
    if (vec == 2)
      return launch<float, 2>(shards, p, rows, d, req, cap, ans, s);
    if (vec == 1)
      return launch<float, 1>(shards, p, rows, d, req, cap, ans, s);
  } else if (elem_bytes == 2) {
    if (vec == 4)
      return launch<__nv_bfloat16, 4>(shards, p, rows, d, req, cap, ans, s);
    if (vec == 2)
      return launch<__nv_bfloat16, 2>(shards, p, rows, d, req, cap, ans, s);
    if (vec == 1)
      return launch<__nv_bfloat16, 1>(shards, p, rows, d, req, cap, ans, s);
  }
  return cudaErrorInvalidValue;
}

// A shard's own allocation, so that its IPC handle maps exactly the shard.
int halo_alloc(unsigned long long bytes, void** out) {
  return cudaMalloc(out, bytes);
}

int halo_free(void* ptr) { return cudaFree(ptr); }

// Host bytes into a shard, in place on the card when it returns. From
// pageable host memory cudaMemcpy may return once the bytes are staged,
// before the DMA into the shard has finished, so the device is synchronised
// before the shard's handle is handed to the peers.
int halo_copy_in(void* dst, const void* src, unsigned long long bytes) {
  const cudaError_t err = cudaMemcpy(dst, src, bytes, cudaMemcpyHostToDevice);
  if (err != cudaSuccess) return err;
  return cudaDeviceSynchronize();
}

int halo_ipc_handle_size(void) { return (int)sizeof(cudaIpcMemHandle_t); }

// The IPC handle of an allocation made by halo_alloc, into out
// (halo_ipc_handle_size() bytes).
int halo_ipc_handle(void* ptr, unsigned char* out) {
  cudaIpcMemHandle_t h;
  const cudaError_t err = cudaIpcGetMemHandle(&h, ptr);
  if (err != cudaSuccess) return err;
  memcpy(out, &h, sizeof h);
  return cudaSuccess;
}

// Map a peer's allocation into this process (on the current device; peer
// access is enabled when the owner's allocation lies on another card). A
// handle cannot be opened in the process that made it.
int halo_ipc_open(const unsigned char* handle, void** out) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof h);
  return cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess);
}

int halo_ipc_close(void* ptr) { return cudaIpcCloseMemHandle(ptr); }

}  // extern "C"
