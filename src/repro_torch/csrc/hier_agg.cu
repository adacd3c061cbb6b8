// Masked hierarchical aggregation, eqs. (2)-(3), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/hier_agg/hier_agg.py:masked_aggregate_batched_pallas
// (body _masked_kernel_batched, S=1 wrapper masked_aggregate_pallas):
//
//   out[s, m, p] = sum_h w[s, m, h] * deltas[s, h, p]
//   w[s, m, h]   = mask[s, m, h] * sizes[s, h]
//                  / max(sum_h' mask[s, m, h'] * sizes[s, h'], 1)
//
// Eq. (2) per edge with mask = the assignment one-hot and sizes = D_n;
// eq. (3) with mask = ones(1, M) and sizes = D_{N_m}. All-zero mask rows
// give zero rows.
//
// What bounds it on this card: a skinny product (M is 1-10 edges, H the
// cohort, P one parameter leaf) doing 2*M flops per delta element, far
// below the card's flop-per-byte balance, so the least time is reading
// the (H, P) delta matrix once: H*P*4 bytes over the memory rate.
//
// Design: grid (ceil(P / kBlock), S). Each thread owns one column p and
// keeps kMTile output rows in registers while it walks h, so a warp reads
// each row of deltas coalesced and every delta element is read from
// device memory once per M tile (once in total for M <= kMTile). Each
// block rebuilds the normalised (kMTile, kHTile) weight panel in shared
// memory (M*H multiplies, negligible beside H*kBlock loads); all threads
// of a warp read the same panel word, a broadcast. M and H are tiled in
// loops so neither is limited by registers or shared memory, the ragged
// end of P is masked, and nothing is padded. No TPU tile shapes remain.
// Left for later work: vector loads, one launch over all leaves, TMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;  // threads per block = columns per block
constexpr int kMTile = 8;    // output rows held in registers
constexpr int kHTile = 256;  // panel columns staged in shared memory
constexpr int kWarps = kBlock / 32;

__global__ void __launch_bounds__(kBlock)
masked_aggregate_kernel(const float* __restrict__ mask,    // (S, M, H)
                        const float* __restrict__ sizes,   // (S, H)
                        const float* __restrict__ deltas,  // (S, H, P)
                        float* __restrict__ out,           // (S, M, P)
                        int M, int H, int P) {
  __shared__ float panel[kMTile][kHTile];
  __shared__ float partial[kMTile][kWarps];
  __shared__ float denom[kMTile];

  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int64_t p = (int64_t)blockIdx.x * kBlock + tid;
  const bool live = p < P;
  const float* mask_s = mask + (int64_t)s * M * H;
  const float* sizes_s = sizes + (int64_t)s * H;
  const float* deltas_s = deltas + (int64_t)s * H * P;
  float* out_s = out + (int64_t)s * M * P;

  for (int m0 = 0; m0 < M; m0 += kMTile) {
    const int mt = min(kMTile, M - m0);

    // Row totals D_{N_m} = sum_h mask * sizes: a block reduction.
    float tot[kMTile];
#pragma unroll
    for (int i = 0; i < kMTile; ++i) tot[i] = 0.f;
    for (int h = tid; h < H; h += kBlock) {
      const float sz = sizes_s[h];
#pragma unroll
      for (int i = 0; i < kMTile; ++i)
        if (i < mt) tot[i] += mask_s[(int64_t)(m0 + i) * H + h] * sz;
    }
#pragma unroll
    for (int i = 0; i < kMTile; ++i) {
      float v = tot[i];
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if ((tid & 31) == 0) partial[i][tid >> 5] = v;
    }
    __syncthreads();
    if (tid < kMTile) {
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w) t += partial[tid][w];
      denom[tid] = fmaxf(t, 1.f);
    }
    __syncthreads();

    float acc[kMTile];
#pragma unroll
    for (int i = 0; i < kMTile; ++i) acc[i] = 0.f;
    for (int h0 = 0; h0 < H; h0 += kHTile) {
      const int ht = min(kHTile, H - h0);
      // Stage the normalised panel tile; rows >= mt and columns >= ht
      // are zero so the unrolled loop below never reads stale words.
      for (int idx = tid; idx < kMTile * kHTile; idx += kBlock) {
        const int i = idx / kHTile, j = idx % kHTile;
        panel[i][j] = (i < mt && j < ht)
            ? mask_s[(int64_t)(m0 + i) * H + h0 + j] * sizes_s[h0 + j]
                  / denom[i]
            : 0.f;
      }
      __syncthreads();
      if (live) {
        const float* d = deltas_s + (int64_t)h0 * P + p;
#pragma unroll 4
        for (int j = 0; j < ht; ++j) {
          const float v = d[(int64_t)j * P];
#pragma unroll
          for (int i = 0; i < kMTile; ++i) acc[i] = fmaf(panel[i][j], v, acc[i]);
        }
      }
      __syncthreads();
    }
    if (live) {
#pragma unroll
      for (int i = 0; i < kMTile; ++i)
        if (i < mt) out_s[(int64_t)(m0 + i) * P + p] = acc[i];
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 when
// the launch was accepted). The caller guarantees S, M, P >= 1, H >= 0,
// S <= 65535, contiguous f32 buffers of the shapes above, and an output
// it allocated itself.
extern "C" int masked_aggregate_f32(const float* mask, const float* sizes,
                                    const float* deltas, float* out, int S,
                                    int M, int H, int P, void* stream) {
  const dim3 grid((P + kBlock - 1) / kBlock, S);
  masked_aggregate_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      mask, sizes, deltas, out, M, H, P);
  return (int)cudaGetLastError();
}
