// Hierarchical aggregation, eqs. (2)-(3), for Hopper (sm_90a): three
// Pallas TPU kernels of src/repro/kernels/hier_agg/hier_agg.py on one
// templated loop.
//
//   K1 masked_aggregate_batched_pallas (body _masked_kernel_batched):
//     out[s, m, p] = sum_h w[s, m, h] * deltas[s, h, p]
//     w[s, m, h]   = mask[s, m, h] * sizes[s, h]
//                    / max(sum_h' mask[s, m, h'] * sizes[s, h'], 1)
//   K3 weighted_aggregate_batched_pallas (body _kernel_batched):
//     the same sum with a caller-supplied panel w[s, m, h], no row total.
//   K4 masked_decode_aggregate_batched_pallas (body
//     _masked_dec_kernel_batched): K1's normalised panel times the decode
//     scale, w[s, m, h] * scales[s, h], over the wire-format updates
//     q[s, h, p] (int8, bf16 or f32), so the decoded (H, P) matrix is
//     never written: each element is widened to f32 as it is loaded.
//
// Eq. (2) per edge with mask = the assignment one-hot and sizes = D_n;
// eq. (3) with mask = ones(1, M) and sizes = D_{N_m}. All-zero mask rows
// give zero rows (K1, K4).
//
// What bounds it on this card: a skinny product (M is 1-10 edges, H the
// cohort, P one parameter leaf) doing 2*M flops per operand element, far
// below the card's flop-per-byte balance, so the least time is reading
// the (H, P) operand once: H*P*sizeof(T) bytes over the memory rate.
//
// Design: grid (ceil(P / kBlock), S). Each thread owns one column p and
// keeps kMTile output rows in registers while it walks h, so a warp reads
// each row of the operand coalesced and every element is read from
// device memory once per M tile (once in total for M <= kMTile). Each
// block stages the (kMTile, kHTile) weight panel tile in shared memory
// (M*H multiplies, negligible beside H*kBlock loads); all threads of a
// warp read the same panel word, a broadcast. M and H are tiled in loops
// so neither is limited by registers or shared memory, the ragged end of
// P is masked, and nothing is padded. No TPU tile shapes remain (nor the
// TPU's 16/32-row padding of bf16/int8 operands). An int8 row is 1 byte
// per thread, 32 bytes per warp: correct, and slower than the f32 loop
// per byte. Left for later work: vector loads, one launch over all
// leaves, TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;  // threads per block = columns per block
constexpr int kMTile = 8;    // output rows held in registers
constexpr int kHTile = 256;  // panel columns staged in shared memory
constexpr int kWarps = kBlock / 32;

// How the panel is staged.
enum class Panel {
  kMasked,        // K1: mask * sizes / row total
  kWeighted,      // K3: the caller's weights as given
  kMaskedScaled,  // K4: mask * sizes / row total * scales
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <Panel kPanel, typename T>
__global__ void __launch_bounds__(kBlock)
aggregate_kernel(const float* __restrict__ panel_in,  // (S, M, H) mask or w
                 const float* __restrict__ sizes,     // (S, H) or null (K3)
                 const float* __restrict__ scales,    // (S, H) or null (K1, K3)
                 const T* __restrict__ x,             // (S, H, P)
                 float* __restrict__ out,             // (S, M, P)
                 int M, int H, int P) {
  __shared__ float panel[kMTile][kHTile];
  __shared__ float partial[kMTile][kWarps];
  __shared__ float denom[kMTile];

  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int64_t p = (int64_t)blockIdx.x * kBlock + tid;
  const bool live = p < P;
  const float* panel_s = panel_in + (int64_t)s * M * H;
  const float* sizes_s = sizes ? sizes + (int64_t)s * H : nullptr;
  const float* scales_s = scales ? scales + (int64_t)s * H : nullptr;
  const T* x_s = x + (int64_t)s * H * P;
  float* out_s = out + (int64_t)s * M * P;

  for (int m0 = 0; m0 < M; m0 += kMTile) {
    const int mt = min(kMTile, M - m0);

    if constexpr (kPanel != Panel::kWeighted) {
      // Row totals D_{N_m} = sum_h mask * sizes: a block reduction.
      float tot[kMTile];
#pragma unroll
      for (int i = 0; i < kMTile; ++i) tot[i] = 0.f;
      for (int h = tid; h < H; h += kBlock) {
        const float sz = sizes_s[h];
#pragma unroll
        for (int i = 0; i < kMTile; ++i)
          if (i < mt) tot[i] += panel_s[(int64_t)(m0 + i) * H + h] * sz;
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
    }

    float acc[kMTile];
#pragma unroll
    for (int i = 0; i < kMTile; ++i) acc[i] = 0.f;
    for (int h0 = 0; h0 < H; h0 += kHTile) {
      const int ht = min(kHTile, H - h0);
      // Stage the panel tile; rows >= mt and columns >= ht are zero so
      // the unrolled loop below never reads stale words.
      for (int idx = tid; idx < kMTile * kHTile; idx += kBlock) {
        const int i = idx / kHTile, j = idx % kHTile;
        float w = 0.f;
        if (i < mt && j < ht) {
          w = panel_s[(int64_t)(m0 + i) * H + h0 + j];
          if constexpr (kPanel != Panel::kWeighted)
            w = w * sizes_s[h0 + j] / denom[i];
          if constexpr (kPanel == Panel::kMaskedScaled) w *= scales_s[h0 + j];
        }
        panel[i][j] = w;
      }
      __syncthreads();
      if (live) {
        const T* d = x_s + (int64_t)h0 * P + p;
#pragma unroll 4
        for (int j = 0; j < ht; ++j) {
          const float v = widen(d[(int64_t)j * P]);
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

template <Panel kPanel, typename T>
int launch(const float* panel, const float* sizes, const float* scales,
           const T* x, float* out, int S, int M, int H, int P, void* stream) {
  const dim3 grid((P + kBlock - 1) / kBlock, S);
  aggregate_kernel<kPanel, T><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      panel, sizes, scales, x, out, M, H, P);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() as an int
// (0 when the launch was accepted). The caller guarantees S, M, P >= 1,
// H >= 0, S <= 65535, contiguous buffers of the shapes above (f32 except
// the operand, whose type the entry's name gives), and an output it
// allocated itself.

extern "C" int masked_aggregate_f32(const float* mask, const float* sizes,
                                    const float* deltas, float* out, int S,
                                    int M, int H, int P, void* stream) {
  return launch<Panel::kMasked, float>(mask, sizes, nullptr, deltas, out, S,
                                       M, H, P, stream);
}

extern "C" int weighted_aggregate_f32(const float* weights,
                                      const float* deltas, float* out, int S,
                                      int M, int H, int P, void* stream) {
  return launch<Panel::kWeighted, float>(weights, nullptr, nullptr, deltas,
                                         out, S, M, H, P, stream);
}

extern "C" int masked_decode_aggregate_f32(const float* mask,
                                           const float* sizes,
                                           const float* scales,
                                           const float* q, float* out, int S,
                                           int M, int H, int P,
                                           void* stream) {
  return launch<Panel::kMaskedScaled, float>(mask, sizes, scales, q, out, S,
                                             M, H, P, stream);
}

extern "C" int masked_decode_aggregate_bf16(const float* mask,
                                            const float* sizes,
                                            const float* scales,
                                            const __nv_bfloat16* q,
                                            float* out, int S, int M, int H,
                                            int P, void* stream) {
  return launch<Panel::kMaskedScaled, __nv_bfloat16>(mask, sizes, scales, q,
                                                     out, S, M, H, P, stream);
}

extern "C" int masked_decode_aggregate_i8(const float* mask,
                                          const float* sizes,
                                          const float* scales,
                                          const int8_t* q, float* out, int S,
                                          int M, int H, int P, void* stream) {
  return launch<Panel::kMaskedScaled, int8_t>(mask, sizes, scales, q, out, S,
                                              M, H, P, stream);
}
