// Causal / sliding-window grouped-query flash attention, forward only,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py:flash_attention_pallas
// (body _kernel):
//
//   out[b, i, h, :] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h/G])
//                     * v[b, j, h/G, :]
//
// over the keys j that the mask keeps: j <= i when causal, j > i - window
// when window > 0, and always j < S. scale = 1/sqrt(d); the running max,
// sum and accumulator are f32; the output is written in q's dtype (f32 or
// bf16). KV head = q head / G with G = Hq / Hkv, so keys are never
// repeated.
//
// What bounds it on this card: 4*d flops per unmasked (query, key) pair
// (two dots of length d) against each of q, k, v read once and the output
// written once. At the prefill's shape (B=2, S=4096, Hq=32, Hkv=2, d=128,
// causal, bf16) that is 2.75e11 flops and 143 MB, so it is bound by
// operations: 0.28 ms at the bf16 tensor-core rate.
//
// Design, common to both kernels: the TPU kernel walks every key tile as
// a sequential grid axis and skips unreachable ones with pl.when; Hopper
// blocks share nothing, so one block owns one (q tile, q head, batch) and
// loops over only the key tiles its rows can reach, from the window's
// first key to the causal diagonal. Heavy (late) q tiles are launched
// first. K and V tiles are staged in shared memory, zero-padded to the
// template width DP >= d and beyond S; the (B, S, H, d) layout is read
// through its strides (the d stride must be 1), nothing is padded or
// transposed in device memory, and no row >= S is written. Masked scores
// take the reference's finite -1e30: a row that is fully masked inside a
// reachable tile gets exp(0) = 1 "garbage", which the next tile with a
// real key clears through alpha = exp(-1e30 - m) = 0, exactly as in the
// reference; -INFINITY would give exp(-inf + inf) = NaN there.
//
// * bf16 (the model's path): tensor cores through mma.sync m16n8k16 with
//   f32 accumulators. Each of 4 warps owns 16 query rows of a 64-row tile
//   and keeps its Q fragments in registers; a 64-key tile gives S = Q K^T
//   in registers (products of bf16 are exact in f32), scaled and masked in
//   f32, then the online softmax in f32 with each row's max reduced over
//   the 4 lanes that hold it. P (f32) feeds P.V as two bf16 operands, a
//   rounded head and its rounded remainder (p = hi + lo to ~2^-16), so
//   the output keeps f32-level agreement with the plain version instead
//   of the 2^-8 of a single bf16 P; V^T fragments come from ldmatrix.trans.
// * f32: the same tiling with f32 FMAs outside the tensor cores (the
//   reference's f32 sweep and the 2-layer f32 oracle use it). Warp w owns
//   rows w, w + 8, ... of a 64-row tile, lane l key l of a 32-key tile and
//   output columns l, l + 32, ...; shuffles reduce and broadcast p.
//
// wgmma, TMA loads and a K/V ring in a warp-specialised pipeline are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
typedef __nv_bfloat16 bf16;

struct Strides {             // element strides of q, k, v in b, s, h
  int64_t qb, qs, qh, kb, ks, kh, vb, vs, vh;
};

__device__ __forceinline__ bool keep(int key, int row, int S, int causal,
                                     int window) {
  bool ok = key < S;
  if (causal) ok = ok && key <= row;
  if (window > 0) ok = ok && key > row - window;
  return ok;
}

// first key and one past the last key any row of [q0, q0 + rows) reaches
__device__ __forceinline__ void key_range(int q0, int rows, int S, int causal,
                                          int window, int* begin, int* end) {
  *begin = window > 0 ? max(0, q0 - window + 1) : 0;
  *end = causal ? min(q0 + rows, S) : S;
}

// ------------------------------------------------------------------ f32

constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 32;              // keys per tile (one per lane)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBQ / kWarps;  // rows per warp

template <int DP>
constexpr int fma_smem_bytes() {
  // Q (kBQ x DP+4) + K (kBK x DP+4) + V (kBK x DP), f32
  return 4 * (kBQ * (DP + 4) + kBK * (DP + 4) + kBK * DP);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_attention_fma_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int S, int Hq, int G,
                           int d, Strides st, int causal, int window,
                           float scale) {
  constexpr int QP = DP + 4;         // row pitch: float4-aligned, and the
                                     // lanes' float4 reads of K hit all banks
  constexpr int NC = DP / 32;        // accumulator columns per lane
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * QP;
  float* Vs = Ks + kBK * QP;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qt = gridDim.x - 1 - blockIdx.x;    // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / G;
  const int q0 = qt * kBQ;

  const float* qb = q + b * st.qb + h * st.qh;
  const float* kb = k + b * st.kb + hk * st.kh;
  const float* vb = v + b * st.vb + hk * st.vh;

  // q is scaled in f32 before the dot, as in the TPU kernel
  for (int idx = threadIdx.x; idx < kBQ * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    const int row = q0 + r;
    Qs[r * QP + c] = (row < S && c < d) ? qb[row * st.qs + c] * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  int k_begin, k_end;
  key_range(q0, kBQ, S, causal, window, &k_begin, &k_end);
  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();                 // previous tile fully consumed
    for (int idx = threadIdx.x; idx < kBK * DP; idx += kThreads) {
      const int r = idx / DP, c = idx % DP;
      const int key = k0 + r;
      const bool in = key < S && c < d;
      Ks[r * QP + c] = in ? kb[key * st.ks + c] : 0.f;
      Vs[r * DP + c] = in ? vb[key * st.vs + c] : 0.f;
    }
    __syncthreads();

    // scores of rows warp + 8 i against key k0 + lane
    float s[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(Ks + lane * QP);
#pragma unroll 4
    for (int c4 = 0; c4 < DP / 4; ++c4) {
      const float4 kv = krow[c4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qv =
            reinterpret_cast<const float4*>(Qs + (warp + kWarps * i) * QP)[c4];
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }

    const int key = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + warp + kWarps * i;
      const float si = keep(key, row, S, causal, window) ? s[i] : kNegInf;
      float mx = si;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float p = expf(si - m_new);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + ps;
      m[i] = m_new;
      s[i] = p;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
    }

    // acc[row, col] += sum_key p[row, key] * V[key, col]
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float vk[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) vk[j] = Vs[kk * DP + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = __shfl_sync(0xffffffffu, s[i], kk);
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(p, vk[j], acc[i][j]);
      }
    }
  }

  float* ob = out + ((int64_t)b * S * Hq + h) * d;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + warp + kWarps * i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      if (c < d) ob[(int64_t)row * Hq * d + c] = acc[i][j] * inv;
    }
  }
}

// ----------------------------------------------------- bf16, tensor cores

constexpr int kMmaBQ = 64;           // query rows per block (16 per warp)
constexpr int kMmaBK = 64;           // keys per tile
constexpr int kMmaThreads = 128;

template <int DP>
constexpr int mma_smem_bytes() {     // Q, K, V tiles of (64 x DP+8) bf16
  return 2 * (kMmaBQ + 2 * kMmaBK) * (DP + 8);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// D = A (16x16 bf16, row) * B (16x8 bf16, col) + D, f32 accumulators
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices, transposed: lanes 8i..8i+7 give matrix i's rows
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const bf16* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// rows [r0, r0 + 64) of one head into a (64 x DP+8) tile, zero beyond S
// and d; 16-byte loads when `vec` (d and the strides multiples of 8 and
// the base 16-byte aligned)
template <int DP>
__device__ __forceinline__ void stage(bf16* tile, const bf16* base,
                                      int64_t row_stride, int r0, int S,
                                      int d, bool vec) {
  constexpr int P = DP + 8;
  if (vec) {
    constexpr int C = DP / 8;        // 16-byte chunks per row
    for (int idx = threadIdx.x; idx < 64 * C; idx += kMmaThreads) {
      const int r = idx / C, c = (idx % C) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r0 + r < S && c < d)
        val = *reinterpret_cast<const uint4*>(base + (r0 + r) * row_stride
                                              + c);
      *reinterpret_cast<uint4*>(tile + r * P + c) = val;
    }
  } else {
    for (int idx = threadIdx.x; idx < 64 * DP; idx += kMmaThreads) {
      const int r = idx / DP, c = idx % DP;
      tile[r * P + c] = (r0 + r < S && c < d)
          ? base[(r0 + r) * row_stride + c] : __float2bfloat16(0.f);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           int S, int Hq, int G, int d, Strides st,
                           int causal, int window, float scale, int vec) {
  constexpr int P = DP + 8;          // row pitch (bf16): 16-byte aligned
                                     // rows whose 8 fragment rows hit
                                     // distinct banks
  constexpr int KS = DP / 16;        // k-steps of Q K^T
  constexpr int ND = DP / 8;         // n-tiles of the output
  constexpr int NT = kMmaBK / 8;     // n-tiles of S
  extern __shared__ uint4 smem16[];
  bf16* Qs = reinterpret_cast<bf16*>(smem16);
  bf16* Ks = Qs + kMmaBQ * P;
  bf16* Vs = Ks + kMmaBK * P;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qt = gridDim.x - 1 - blockIdx.x;    // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / G;
  const int q0 = qt * kMmaBQ;
  const int quad = lane >> 2, pair = (lane & 3) * 2;
  const int row0 = q0 + warp * 16 + quad;       // this thread's rows:
  const int row1 = row0 + 8;                    // row0 and row0 + 8

  stage<DP>(Qs, q + b * st.qb + h * st.qh, st.qs, q0, S, d, vec);
  __syncthreads();
  uint32_t qa[KS][4];                // A fragments of this warp's 16 rows
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const bf16* p0 = Qs + (warp * 16 + quad) * P + ks * 16 + pair;
    qa[ks][0] = ld32(p0);
    qa[ks][1] = ld32(p0 + 8 * P);
    qa[ks][2] = ld32(p0 + 8);
    qa[ks][3] = ld32(p0 + 8 * P + 8);
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const bf16* kb = k + b * st.kb + hk * st.kh;
  const bf16* vb = v + b * st.vb + hk * st.vh;
  int k_begin, k_end;
  key_range(q0, kMmaBQ, S, causal, window, &k_begin, &k_end);
  for (int k0 = (k_begin / kMmaBK) * kMmaBK; k0 < k_end; k0 += kMmaBK) {
    __syncthreads();                 // previous tile fully consumed
    stage<DP>(Ks, kb, st.ks, k0, S, d, vec);
    stage<DP>(Vs, vb, st.vs, k0, S, d, vec);
    __syncthreads();

    // S = Q K^T: s[nt] holds keys nt*8 + pair + {0, 1} of row0 ([0], [1])
    // and of row1 ([2], [3])
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* kp = Ks + (nt * 8 + quad) * P + pair;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        mma(s[nt], qa[ks], ld32(kp + ks * 16), ld32(kp + ks * 16 + 8));
    }

    // scale, mask and the online softmax; each row lives in a quad
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = hr ? row1 : row0;
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + nt * 8 + pair + e;
          float& x = s[nt][2 * hr + e];
          x = keep(key, row, S, causal, window) ? x * scale : kNegInf;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      const float alpha = expf(m[hr] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * hr + e];
          x = expf(x - m_new);
          ps += x;
        }
      l[hr] = alpha * l[hr] + ps;    // this lane's share; quad-summed last
      m[hr] = m_new;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][2 * hr] *= alpha;
        o[n][2 * hr + 1] *= alpha;
      }
    }

    // O += P V over 4 k-steps of 16 keys; P = hi + lo, both bf16
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {  // A fragment f: n-tile 2kk + f/2,
        const float* x = s[2 * kk + (f >> 1)] + 2 * (f & 1);  // row f&1
        hi[f] = pack(x[0], x[1]);
        const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(
            &hi[f]);
        lo[f] = pack(x[0] - __low2float(t), x[1] - __high2float(t));
      }
      const bf16* vp = Vs + (kk * 16 + (lane & 15)) * P + (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vp + n * 8);
        mma(o[n], hi, vf[0], vf[1]);
        mma(o[n], lo, vf[0], vf[1]);
        mma(o[n + 1], hi, vf[2], vf[3]);
        mma(o[n + 1], lo, vf[2], vf[3]);
      }
    }
  }

  bf16* ob = out + ((int64_t)b * S * Hq + h) * d;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lt = l[hr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = hr ? row1 : row0;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    bf16* orow = ob + (int64_t)row * Hq * d;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + pair + e;
        if (c < d) orow[c] = __float2bfloat16(o[n][2 * hr + e] * inv);
      }
  }
}

// ----------------------------------------------------------- launching

// cudaFuncSetAttribute once per kernel, so that a launch inside a
// CUDA-graph capture makes no such call
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  *done = err == cudaSuccess;
  return err;
}

template <int DP>
int launch_f32(const float* q, const float* k, const float* v, float* out,
               int B, int S, int Hq, int Hkv, int d, const Strides& st,
               int causal, int window, cudaStream_t stream) {
  static bool done = false;
  auto kernel = flash_attention_fma_kernel<DP>;
  constexpr int bytes = fma_smem_bytes<DP>();
  const cudaError_t err = allow_smem(kernel, bytes, &done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      q, k, v, out, S, Hq, Hq / Hkv, d, st, causal, window,
      (float)(1.0 / sqrt((double)d)));
  return (int)cudaGetLastError();
}

template <int DP>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                int B, int S, int Hq, int Hkv, int d, const Strides& st,
                int causal, int window, cudaStream_t stream) {
  static bool done = false;
  auto kernel = flash_attention_mma_kernel<DP>;
  constexpr int bytes = mma_smem_bytes<DP>();
  const cudaError_t err = allow_smem(kernel, bytes, &done);
  if (err != cudaSuccess) return (int)err;
  const int64_t all = st.qb | st.qs | st.qh | st.kb | st.ks | st.kh | st.vb
      | st.vs | st.vh | d;
  const uintptr_t addr = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  const int vec = (all % 8 == 0) && (addr % 16 == 0);
  const dim3 grid((S + kMmaBQ - 1) / kMmaBQ, Hq, B);
  kernel<<<grid, kMmaThreads, bytes, stream>>>(
      q, k, v, out, S, Hq, Hq / Hkv, d, st, causal, window,
      (float)(1.0 / sqrt((double)d)), vec);
  return (int)cudaGetLastError();
}

Strides strides_of(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8]};
}

}  // namespace

// Launch on `stream`; return cudaGetLastError() as an int (0 when the
// launch was accepted). The caller guarantees: q (B, S, Hq, d), k and v
// (B, S, Hkv, d) of one dtype on one device, unit stride in d, element
// strides `strides` = (q: b, s, h; k: b, s, h; v: b, s, h), all >= 0;
// 1 <= d <= 128; Hq % Hkv == 0; B, Hq <= 65535; S >= 1; window >= 0; out
// a contiguous (B, S, Hq, d) buffer it allocated.
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* out, int B, int S,
                                   int Hq, int Hkv, int d,
                                   const long long* strides, int causal,
                                   int window, void* stream) {
  const Strides st = strides_of(strides);
  const cudaStream_t s = (cudaStream_t)stream;
  if (d <= 32)
    return launch_f32<32>(q, k, v, out, B, S, Hq, Hkv, d, st, causal,
                          window, s);
  if (d <= 64)
    return launch_f32<64>(q, k, v, out, B, S, Hq, Hkv, d, st, causal,
                          window, s);
  return launch_f32<128>(q, k, v, out, B, S, Hq, Hkv, d, st, causal, window,
                         s);
}

extern "C" int flash_attention_bf16(const bf16* q, const bf16* k,
                                    const bf16* v, bf16* out, int B, int S,
                                    int Hq, int Hkv, int d,
                                    const long long* strides, int causal,
                                    int window, void* stream) {
  const Strides st = strides_of(strides);
  const cudaStream_t s = (cudaStream_t)stream;
  if (d <= 32)
    return launch_bf16<32>(q, k, v, out, B, S, Hq, Hkv, d, st, causal,
                           window, s);
  if (d <= 64)
    return launch_bf16<64>(q, k, v, out, B, S, Hq, Hkv, d, st, causal,
                           window, s);
  return launch_bf16<128>(q, k, v, out, B, S, Hq, Hkv, d, st, causal, window,
                          s);
}
