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
// about 0.2 us, below one launch, so the kernel is launch-bound; at
// large N and K it becomes bound by the f32 (non-tensor-core) rate.
//
// Design: the TPU kernel walked P as a sequential third grid axis with
// a scratch accumulator; here blocks share nothing, so each block owns a
// (kTile x kTile) output tile and loops over P inside the block. 16x16
// threads each keep a 2x2 micro-tile of dot products plus the squared
// norms of their two x rows and two c rows in registers; kPTile-wide
// slices of x and c are staged in shared memory (rows padded by one word
// so the c reads are free of bank conflicts). Ragged N, K and P are
// masked, so any K (including K > 128) and any alignment is covered.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;    // output rows and columns per block
constexpr int kSide = 16;    // threads per block side; 2x2 outputs each
constexpr int kPTile = 32;   // feature columns staged per step
constexpr int kThreads = kSide * kSide;

__global__ void __launch_bounds__(kThreads)
pairwise_sq_dists_kernel(const float* __restrict__ x,   // (N, P)
                         const float* __restrict__ c,   // (K, P)
                         float* __restrict__ out,       // (N, K)
                         int N, int K, int P) {
  __shared__ float xs[kTile][kPTile + 1];
  __shared__ float cs[kTile][kPTile + 1];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kSide + tx;
  const int n0 = blockIdx.y * kTile, k0 = blockIdx.x * kTile;

  float dot[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float xx[2] = {0.f, 0.f}, cc[2] = {0.f, 0.f};

  for (int p0 = 0; p0 < P; p0 += kPTile) {
    for (int idx = tid; idx < kTile * kPTile; idx += kThreads) {
      const int r = idx / kPTile, col = idx % kPTile;
      const int gp = p0 + col;
      xs[r][col] = (n0 + r < N && gp < P) ? x[(int64_t)(n0 + r) * P + gp]
                                          : 0.f;
      cs[r][col] = (k0 + r < K && gp < P) ? c[(int64_t)(k0 + r) * P + gp]
                                          : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < kPTile; ++j) {
      const float a0 = xs[ty][j], a1 = xs[ty + kSide][j];
      const float b0 = cs[tx][j], b1 = cs[tx + kSide][j];
      dot[0][0] = fmaf(a0, b0, dot[0][0]);
      dot[0][1] = fmaf(a0, b1, dot[0][1]);
      dot[1][0] = fmaf(a1, b0, dot[1][0]);
      dot[1][1] = fmaf(a1, b1, dot[1][1]);
      xx[0] = fmaf(a0, a0, xx[0]);
      xx[1] = fmaf(a1, a1, xx[1]);
      cc[0] = fmaf(b0, b0, cc[0]);
      cc[1] = fmaf(b1, b1, cc[1]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = n0 + ty + kSide * i;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = k0 + tx + kSide * j;
      if (n < N && k < K)
        out[(int64_t)n * K + k] = fmaxf(xx[i] + cc[j] - 2.f * dot[i][j], 0.f);
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 when
// the launch was accepted). The caller guarantees N, K >= 1, P >= 0,
// ceil(N / 32) <= 65535, contiguous f32 buffers of the shapes above, and
// an output it allocated itself.
extern "C" int pairwise_sq_dists_f32(const float* x, const float* c,
                                     float* out, int N, int K, int P,
                                     void* stream) {
  const dim3 grid((K + kTile - 1) / kTile, (N + kTile - 1) / kTile);
  const dim3 block(kSide, kSide);
  pairwise_sq_dists_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      x, c, out, N, K, P);
  return (int)cudaGetLastError();
}
