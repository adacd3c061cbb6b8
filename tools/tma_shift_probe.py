"""Can TMA load a 128-byte-swizzled bf16 box whose first column is not on
a 16-byte boundary? The question behind K5's route for a base address off
16 bytes: a tensor map from the boundary below the base, its rows
starting ``off`` columns in.

One block loads one box (64 columns x 8 rows) of a (rows, cols) bf16
matrix with row stride ``ld`` elements, through a 2-D tensor map, and
waits on its mbarrier for at most ~0.5 s (no trap: a load that never
completes is reported as such). Cases, each at column offsets 0, 1
and 4 (elements), for the boxes at columns off and 64 + off:

* ``coord``: the map has the matrix's ``cols`` columns.
* ``shift``: the map has ``cols + off`` columns, as a map from the
  boundary below a base ``off`` elements past it; ld = cols + 16 leaves
  room for them.
* ``shift tight``: the same with ld = cols, so a map row (cols + off
  columns) overlaps the next row's first elements, as in a contiguous
  tensor.

For each launch, one JSON line: the encode's or the launch's error code
(a CUDA error ends the process; the next launch runs in a new one),
whether the load completed, and whether the box holds the expected
values (zero past the map's columns).

Usage (needs a card and nvcc; builds into build/tools, which git
ignores):
    PYTHONPATH=src python3 tools/tma_shift_probe.py
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = r"""
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
typedef CUresult (*EncodeFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

__global__ void load_box(const __grid_constant__ CUtensorMap map, int c0,
                         uint16_t* out, int* done) {
  __shared__ alignas(1024) uint16_t tile[8 * 64];
  __shared__ alignas(8) uint64_t bar;
  const uint32_t t = (uint32_t)__cvta_generic_to_shared(tile);
  const uint32_t b = (uint32_t)__cvta_generic_to_shared(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(b));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(b), "r"(8 * 64 * 2) : "memory");
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];"
        :: "r"(t), "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(0),
           "r"(b) : "memory");
    uint32_t ok = 0;
    const long long start = clock64();
    while (!ok && clock64() - start < (1ll << 30))
      asm volatile("{\n.reg .pred p;\n"
                   "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                   "selp.u32 %0, 1, 0, p;\n}\n"
                   : "=r"(ok) : "r"(b) : "memory");
    *done = ok;
    if (ok)
      for (int i = 0; i < 8 * 64; ++i) out[i] = tile[i];
  }
}

// returns the encode's CUresult; on success runs the load
extern "C" int probe(const void* base, int cols, int rows, int ld, int c0,
                     uint16_t* out, int* done) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                          &found);
  if (!fn) return -1;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, 8}, unit[2] = {1, 1};
  const CUresult r = reinterpret_cast<EncodeFn>(fn)(
      &map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)r;
  load_box<<<1, 32>>>(map, c0, out, done);
  return (int)cudaDeviceSynchronize();
}
"""


LAUNCHES = [(case, off, box) for case in ("coord", "shift", "shift tight")
            for off in (0, 1, 4) for box in (0, 1)]


def run_from(start: int) -> int:
    """Launch LAUNCHES[start:] in order, one JSON line each as it ends;
    stop (exit 3) at the first launch that leaves a CUDA error, which
    ends this process's context."""
    import torch
    from repro_torch.kernels import build
    out_dir = ROOT / "build" / "tools"
    lib_path = out_dir / "libtma_shift_probe.so"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "tma_shift_probe.cu").write_text(SRC)
        subprocess.run([build._nvcc(), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O2",
                        "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path),
                        str(out_dir / "tma_shift_probe.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.probe.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.c_void_p]
    cols, rows = 128, 8
    for idx in range(start, len(LAUNCHES)):
        case, off, nb = LAUNCHES[idx]
        ld = cols if case == "shift tight" else cols + 16
        # values 1..n, so a zero marks a column the load left empty
        mat = torch.arange(1, rows * ld + 17, device="cuda",
                           dtype=torch.float32).to(torch.bfloat16)
        map_cols = cols if case == "coord" else cols + off
        c0 = nb * 64 + off
        out = torch.zeros(8 * 64, dtype=torch.int16, device="cuda")
        done = torch.zeros(1, dtype=torch.int32, device="cuda")
        err = lib.probe(ctypes.c_void_p(mat.data_ptr()), map_cols, rows, ld,
                        c0, ctypes.c_void_p(out.data_ptr()),
                        ctypes.c_void_p(done.data_ptr()))
        row = {"i": idx, "case": case, "off": off, "box": nb, "error": err}
        if err == 0:
            row["completed"] = bool(done.item())
        if row.get("completed"):
            tile = out.view(torch.bfloat16).view(8, 8, 8)   # row, chunk
            got = torch.stack([tile[r, torch.arange(8, device="cuda")
                                    ^ (r % 8)] for r in range(8)])
            want = torch.zeros(8, 64, dtype=torch.bfloat16, device="cuda")
            n = max(0, min(64, map_cols - c0))
            for r in range(8):
                want[r, :n] = mat[r * ld + c0: r * ld + c0 + n]
            row["exact"] = bool(torch.equal(got.reshape(8, 64), want))
        print(json.dumps(row), flush=True)
        if err:
            return 3
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tma_shift_probe: needs a CUDA card", file=sys.stderr)
        return 1
    if len(sys.argv) > 1:
        return run_from(int(sys.argv[1]))
    start = 0
    while start < len(LAUNCHES):
        # a launch that faults ends its process's CUDA context: go on in
        # a new process after it
        run = subprocess.run([sys.executable, __file__, str(start)],
                             capture_output=True, text=True, timeout=300)
        done = [json.loads(x) for x in run.stdout.splitlines()
                if x.startswith("{")]
        for row in done:
            print(json.dumps(row))
        if not done:
            print(json.dumps({"i": start, "exit": run.returncode,
                              "stderr": run.stderr[-1500:]}))
        start = (done[-1]["i"] if done else start) + 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
