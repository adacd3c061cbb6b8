// Pairwise squared distances for K-means (Algorithm 2), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/kmeans_dist/kmeans_dist.py:pairwise_sq_dists_pallas
// (body _kernel):
//
//   out[n, k] = max(||x_n||^2 + ||c_k||^2 - 2 x_n . c_k, 0)
//
// with every product and sum an f32 FMA (no TF32).
//
// What bounds it on this card: 2*N*K*P flops of f32 FMA over
// (N + K)*P*4 bytes read. At the clustering's shapes (N = 100 devices,
// K = 10 centroids, P = 1640 mini-model weights) the bytes bound is
// about 0.2 us, below one launch, so the kernel is latency-bound: what
// counts is how few serial steps the longest block takes. At large N and
// K it becomes bound by the f32 (non-tensor-core) rate.
//
// Design: the TPU kernel walked P as a sequential third grid axis with a
// scratch accumulator. Here one (32 x kSide*CK) output tile is split
// along P across the `splits` blocks of a thread-block cluster (at most
// 8, the portable size), so that a handful of output tiles still keeps
// dozens of SMs busy and each block walks only its own slice of P. Inside
// a block, 16x16 threads each keep a 2 x CK micro-tile of partial dots
// and the partial squared norms of their rows in registers; kPStep-wide
// slices of x and c reach shared memory by cp.async into a two-stage
// ring (zero-filled beyond N, K and the slice), so the next slice loads
// while this one is summed. Each block then leaves its partials in its
// shared memory, and after a cluster barrier the rank-0 block reads them
// over distributed shared memory, sums them in rank order 0, 1, ...,
// clamps and writes: one launch, no atomics, the same bits on every run.
// K <= 16 takes a 16-wide column tile (CK = 1), so K = 10 stages 16 rows
// of c, not 32. The launch plan (tiles, splits, slice width) comes from
// the caller.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 32;    // x rows per output tile
constexpr int kSide = 16;    // threads per block side
constexpr int kPStep = 64;   // feature columns per ring stage
constexpr int kThreads = kSide * kSide;
constexpr int kMaxSplits = 8;

// 4 bytes global -> shared, asynchronously; zero-filled when !ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile(
      "cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
      :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src),
         "r"(ok ? 4 : 0)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <int CK>
__global__ void __launch_bounds__(kThreads)
pairwise_sq_dists_kernel(const float* __restrict__ x,   // (N, P)
                         const float* __restrict__ c,   // (K, P)
                         float* __restrict__ out,       // (N, K)
                         int N, int K, int P, int chunk) {
  constexpr int TK = kSide * CK;     // output columns (c rows) per tile
  __shared__ float xs[2][kRows][kPStep + 1];
  __shared__ float cs[2][TK][kPStep + 1];
  __shared__ float part[kRows * TK + kRows + TK];   // dots, |x|^2, |c|^2

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kSide + tx;
  const int split = blockIdx.x, splits = gridDim.x;  // the cluster's x
  const int k0 = blockIdx.y * TK, n0 = blockIdx.z * kRows;
  const int p_begin = min(P, split * chunk);
  const int p_end = min(P, p_begin + chunk);
  const int steps = (p_end - p_begin + kPStep - 1) / kPStep;

  auto load = [&](int stage, int p0) {
    for (int idx = tid; idx < kRows * kPStep; idx += kThreads) {
      const int r = idx / kPStep, col = idx % kPStep;
      const bool ok = n0 + r < N && p0 + col < p_end;
      cp_async4(&xs[stage][r][col],
                ok ? x + (int64_t)(n0 + r) * P + p0 + col : x, ok);
    }
    for (int idx = tid; idx < TK * kPStep; idx += kThreads) {
      const int r = idx / kPStep, col = idx % kPStep;
      const bool ok = k0 + r < K && p0 + col < p_end;
      cp_async4(&cs[stage][r][col],
                ok ? c + (int64_t)(k0 + r) * P + p0 + col : c, ok);
    }
    cp_async_commit();
  };

  float dot[2][CK], xx[2] = {0.f, 0.f}, cc[CK];
#pragma unroll
  for (int j = 0; j < CK; ++j) {
    dot[0][j] = dot[1][j] = 0.f;
    cc[j] = 0.f;
  }

  if (steps > 0) load(0, p_begin);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {             // the other stage, freed at s - 1
      load((s + 1) & 1, p_begin + (s + 1) * kPStep);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = s & 1;
#pragma unroll 8
    for (int j = 0; j < kPStep; ++j) {
      const float a0 = xs[st][ty][j], a1 = xs[st][ty + kSide][j];
      xx[0] = fmaf(a0, a0, xx[0]);
      xx[1] = fmaf(a1, a1, xx[1]);
#pragma unroll
      for (int q = 0; q < CK; ++q) {
        const float bq = cs[st][tx + kSide * q][j];
        dot[0][q] = fmaf(a0, bq, dot[0][q]);
        dot[1][q] = fmaf(a1, bq, dot[1][q]);
        cc[q] = fmaf(bq, bq, cc[q]);
      }
    }
    __syncthreads();                 // before this stage is refilled
  }

  if (splits > 1) {
    // partials to shared memory; rank 0 sums them in rank order
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int q = 0; q < CK; ++q)
        part[(ty + kSide * i) * TK + tx + kSide * q] = dot[i][q];
    if (tx == 0) {
      part[kRows * TK + ty] = xx[0];
      part[kRows * TK + ty + kSide] = xx[1];
    }
    if (ty == 0)
#pragma unroll
      for (int q = 0; q < CK; ++q)
        part[kRows * TK + kRows + tx + kSide * q] = cc[q];
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (cluster.block_rank() == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        xx[i] = 0.f;
#pragma unroll
        for (int q = 0; q < CK; ++q) dot[i][q] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < CK; ++q) cc[q] = 0.f;
      for (int r = 0; r < splits; ++r) {
        const float* rp = cluster.map_shared_rank(part, r);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int q = 0; q < CK; ++q)
            dot[i][q] += rp[(ty + kSide * i) * TK + tx + kSide * q];
          xx[i] += rp[kRows * TK + ty + kSide * i];
        }
#pragma unroll
        for (int q = 0; q < CK; ++q)
          cc[q] += rp[kRows * TK + kRows + tx + kSide * q];
      }
    }
    cluster.sync();                  // the partials live until rank 0 read
    if (cluster.block_rank() != 0) return;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = n0 + ty + kSide * i;
#pragma unroll
    for (int q = 0; q < CK; ++q) {
      const int k = k0 + tx + kSide * q;
      if (n < N && k < K)
        out[(int64_t)n * K + k] = fmaxf(xx[i] + cc[q] - 2.f * dot[i][q],
                                        0.f);
    }
  }
}

template <int CK>
int launch(const float* x, const float* c, float* out, int N, int K, int P,
           int splits, int chunk, cudaStream_t stream) {
  constexpr int TK = kSide * CK;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (K + TK - 1) / TK, (N + kRows - 1) / kRows);
  cfg.blockDim = dim3(kSide, kSide);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, pairwise_sq_dists_kernel<CK>, x, c, out, N, K, P, chunk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t as an int (0
// when it was accepted). The caller guarantees N, K >= 1, P >= 0,
// contiguous f32 buffers of the shapes above and an output it allocated
// itself, and passes the launch plan: col_tile 16 or 32 output columns a
// tile, `splits` in [1, 8] blocks a cluster along P, each over `chunk`
// columns (splits * chunk >= P), ceil(N / 32) and ceil(K / col_tile) at
// most 65535.
extern "C" int pairwise_sq_dists_f32(const float* x, const float* c,
                                     float* out, int N, int K, int P,
                                     int col_tile, int splits, int chunk,
                                     void* stream) {
  if (splits < 1 || splits > kMaxSplits || (int64_t)splits * chunk < P
      || (col_tile != 16 && col_tile != 32))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return col_tile == 16 ? launch<1>(x, c, out, N, K, P, splits, chunk, s)
                        : launch<2>(x, c, out, N, K, P, splits, chunk, s);
}
