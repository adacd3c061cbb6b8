"""The card's peak rate of ``mma.sync`` on TF32 operands: the ceiling of
the f32 flash attention kernel (``flash_attention_tf32x3_kernel``), whose
split TF32 products run as mma.sync m16n8k8.

Each warp of a full grid (132 x W warps) issues N independent
m16n8k8 (and, for comparison, m16n8k4) products per step on fixed
register operands, for 20 000 steps; the rate is the products' flops
over the time CUDA events measure. The operands never change, so this is
the instruction's throughput with no load, split or softmax in its way.

Usage (needs a card and nvcc; builds into build/tools, which git
ignores):
    PYTHONPATH=src python3 tools/mma_tf32_rate.py
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int K, int N>
__global__ void bench(float* out, int iters) {
  float c[N][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = a0 + 1, a2 = a0 + 2, a3 = a0 + 3;
  const uint32_t b0 = threadIdx.x * 3, b1 = b0 + 7;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (K == 8)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a0), "r"(a1), "r"(b0));
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// ms of one launch of k-depth K with N accumulators a warp (the second
// of two launches)
extern "C" int run(int k, int n, int blocks, int threads, int iters,
                   float* out, float* ms) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(e0);
    if (k == 8 && n == 4) bench<8, 4><<<blocks, threads>>>(out, iters);
    else if (k == 8 && n == 8) bench<8, 8><<<blocks, threads>>>(out, iters);
    else if (k == 8) bench<8, 16><<<blocks, threads>>>(out, iters);
    else bench<4, 8><<<blocks, threads>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
  }
  cudaEventElapsedTime(ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return (int)cudaGetLastError();
}
"""
ITERS = 20000


def main() -> int:
    import torch
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("mma_tf32_rate: needs a CUDA card", file=sys.stderr)
        return 1
    out_dir = ROOT / "build" / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "mma_tf32_rate.cu").write_text(SRC)
    lib_path = out_dir / "libmma_tf32_rate.so"
    subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
                    str(lib_path), str(out_dir / "mma_tf32_rate.cu")],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.run.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 16 * 32, device="cuda")
    for k, n in ((8, 4), (8, 8), (8, 16), (4, 8)):
        for warps in (4, 8, 16):       # warps a multiprocessor
            threads = 32 * min(warps, 8)
            blocks = sms * warps * 32 // threads
            ms = ctypes.c_float()
            err = lib.run(k, n, blocks, threads, ITERS, out.data_ptr(),
                          ctypes.byref(ms))
            if err:
                raise RuntimeError(f"CUDA error {err}")
            flops = 2.0 * 16 * 8 * k * n * ITERS * blocks * threads / 32
            print(f"mma.sync m16n8k{k} tf32: {n:2d} accumulators a warp, "
                  f"{warps:2d} warps a multiprocessor: "
                  f"{flops / ms.value / 1e9:.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
