#!/usr/bin/env python3
"""The tensor-core ceilings and the port's 3xTF32 projection on one NVIDIA
GPU (sm_90a):

    python3 scripts/tf32_probe.py

1. The raw TF32 rate of `mma.sync.m16n8k8` and of `wgmma.m64n128k8` (A in
   registers, B in shared memory), each issued over and over on the same
   fragments by one block of 256 threads an SM: the ceilings a product
   built on either instruction can approach on this card.
2. The star-GAT projection (`gat_kernels.gat_projection`, the first launch
   of K1 and K2) at the MTL per-slot final layer's shape (4096 egonets x 64
   slots, 3600 inputs, 1 head x 600 + 2): device ms, float32-equivalent
   TFLOP/s, and the largest error against a float64 product of the same
   inputs, beside one float32 torch.matmul of the same shape (cuBLAS, full
   float32) and its error.

Prints the card's name and power limit (nvidia-smi), then one JSON object.
Builds its probe kernels with nvcc into taxoexpan_torch/ops/_build/.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_ACC = ", ".join(f"%{i}" for i in range(64))
_OUTS = ", ".join(f'"+f"(d[{i}])' for i in range(64))
SOURCE = r"""
__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 8 warps x 16 independent m16n8k8 products an iteration
__global__ void __launch_bounds__(256, 1) peak_mma(float* out, int iters) {
  float acc[16][4] = {};
  const unsigned a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, 3};
  const unsigned b[2] = {threadIdx.x * 3, 7};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < 16; ++i) mma_tf32(acc[i], a, b);
  float s = 0.f;
  for (int i = 0; i < 16; ++i) s += acc[i][0] + acc[i][3];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

__device__ __forceinline__ void wgmma(float* d, const unsigned* a,
                                      unsigned long long desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{ACC}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : OUTS
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// 2 warpgroups, 12 products between waits, B (128 x 8 TF32) in shared
// memory as core matrices of 8 rows x 16 bytes
__global__ void __launch_bounds__(256, 1) peak_wgmma(float* out, int iters) {
  __shared__ __align__(128) float bs[128 * 8];
  for (int i = threadIdx.x; i < 128 * 8; i += 256) bs[i] = 0.001f * i;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float d[64] = {};
  const unsigned a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, 3};
  const unsigned long long addr =
      (unsigned long long)__cvta_generic_to_shared(bs);
  const unsigned long long desc = ((addr & 0x3FFFF) >> 4) |
                                  ((128ull >> 4) << 16) |
                                  ((256ull >> 4) << 32);
  for (int it = 0; it < iters; it += 12) {
    for (int q = 0; q < 64; ++q) asm volatile("" : "+f"(d[q])::"memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < 12; ++j) wgmma(d, a, desc);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    for (int q = 0; q < 64; ++q) asm volatile("" : "+f"(d[q])::"memory");
  }
  float s = 0.f;
  for (int q = 0; q < 64; ++q) s += d[q];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

extern "C" int probe(int which, float* out, int blocks, int iters,
                     void* stream) {
  if (which == 0)
    peak_mma<<<blocks, 256, 0, (cudaStream_t)stream>>>(out, iters);
  else
    peak_wgmma<<<blocks, 256, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
""".replace("ACC", _ACC).replace("OUTS", _OUTS)


def _events_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def peaks() -> dict:
    """Raw TF32 TFLOP/s of the two instructions, one block an SM."""
    import torch
    from taxoexpan_torch.ops import cuda_build
    build = cuda_build.BUILD_DIR / "tf32_probe"
    build.mkdir(parents=True, exist_ok=True)
    (build / "probe.cu").write_text(SOURCE)
    subprocess.run([cuda_build.nvcc_path(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o",
                    str(build / "libprobe.so"), str(build / "probe.cu")],
                   check=True)
    lib = ctypes.CDLL(str(build / "libprobe.so"))
    lib.probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    iters = 9600
    res = {}
    # flop an iteration a block: 8 warps x 16 x (16*8*8*2); 2 x (64*128*8*2)
    for which, name, flop in ((0, "mma_sync_m16n8k8", 8 * 16 * 2048),
                              (1, "wgmma_m64n128k8", 2 * 131072)):
        def run():
            rc = lib.probe(which, out.data_ptr(), sms, iters, stream)
            if rc:
                raise RuntimeError(f"probe {name}: CUDA error {rc}")
        ms = _events_ms(run, 3)
        res[f"{name}_tf32_tflops"] = sms * iters * flop / ms / 1e9
    return res


def projection() -> dict:
    """gat_projection at the MTL per-slot final layer's shape, eval form,
    against float64 and beside cuBLAS float32."""
    import torch
    from taxoexpan_torch.ops import gat_kernels as gk
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, n, din, hd = 4096, 64, 3600, 600
    x = torch.randn((b, n, din), device="cuda", generator=gen) / din ** 0.5
    w = [torch.randn(s, device="cuda", generator=gen) * (2.0 / 4200) ** 0.5
         for s in ((din, hd), (din, 1), (din, 1))]
    bias = [torch.randn(s, device="cuda", generator=gen) * 0.1
            for s in ((n, hd), (n, 1), (n, 1))]
    wcat = torch.cat(w, dim=1)
    bcat = torch.cat(bias, dim=1)
    ref = (x.double().reshape(b * n, din) @ wcat.double()).reshape(
        b, n, -1) + bcat.double()
    got = gk.gat_projection(x, *w, *bias)
    flops = 2.0 * b * n * din * (hd + 2)
    ms = _events_ms(lambda: gk.gat_projection(x, *w, *bias), 5)
    x2 = x.reshape(b * n, din)
    cublas = (x2 @ wcat).reshape(b, n, -1) + bcat
    return {"shape": [b * n, din, hd + 2], "ms": ms,
            "tflops_f32_equivalent": flops / ms / 1e9,
            "max_abs_err_vs_f64": float((got.double() - ref).abs().max()),
            "result_max_abs": float(ref.abs().max()),
            "cublas_f32_ms": _events_ms(lambda: x2 @ wcat, 5),
            "cublas_f32_max_abs_err_vs_f64":
                float((cublas.double() - ref).abs().max())}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tf32_probe: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {**peaks(), "projection": projection()}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
