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
// Design, common to the kernels: the TPU kernel walks every key tile as
// a sequential grid axis and skips unreachable ones with pl.when; Hopper
// blocks share nothing, so one block owns one (q tile, q head, batch) and
// loops over only the key tiles its rows can reach, from the window's
// first key to the causal diagonal. Heavy (late) q tiles are launched
// first. The (B, S, H, d) layout is read through its strides (the d
// stride must be 1), nothing is transposed in device memory, and no row
// >= S is written. Masked scores take the reference's finite
// -1e30: a row that is fully masked inside a reachable tile gets
// exp(0) = 1 "garbage", which the next tile with a real key clears
// through alpha = exp(-1e30 - m) = 0, exactly as in the reference;
// -INFINITY would give exp(-inf + inf) = NaN there.
//
// * bf16: flash_attention_wgmma_kernel, warp-specialised. TMA reads a
//   tensor whose b, s, h strides are positive multiples of 16 bytes and
//   whose base is 16-byte aligned (the model's path). Any other bf16
//   tensor (d not a multiple of 8, a slice of a wider buffer, a view at an odd
//   offset, a broadcast batch) the wrapper first copies into a fresh
//   buffer whose rows are padded to 16 bytes, and launches this same
//   kernel on the copy: a TMA box cannot start off a 16-byte boundary,
//   and a producer that reads such rows itself (cp.async and byte
//   shifts) ran at 1.7-2.6x this kernel's time on an H100, where the
//   copy costs a tenth of it.
//   A producer warpgroup (one thread issuing, registers given back with
//   setmaxnreg) loads Q once and K/V tiles of 128 keys into a ring of
//   kWgStages = 3 stages with TMA, through 4-D tensor maps over
//   (d, H, S, B) with the real strides and 64-column, 128-byte-swizzled
//   boxes (d = 128 is two boxes; TMA zero-fills rows >= S and columns
//   >= d, so nothing is padded). Full/empty mbarriers guard each stage,
//   so loads overlap the math. Two consumer warpgroups own 64 query rows
//   each of a 128-row tile: S = Q K^T by wgmma with both operands in
//   shared memory, the online softmax in f32 registers (the wgmma
//   accumulator of each warp is the mma.sync m16n8 layout repeated along
//   N, so a row lives in a quad), masks only on the diagonal and
//   window-edge tiles, then O += P V by wgmma with P from registers and
//   V read MN-major from shared memory (the transpose bit). The softmax
//   is what keeps the tensor cores idle, so it is hidden twice over, as
//   in FlashAttention-3: a warpgroup issues tile j's P V together with
//   tile j+1's Q K^T and computes j+1's softmax while they run, and the
//   two warpgroups take turns to issue (named barriers), so one's
//   softmax runs under the other's products. That asks a third ring
//   stage (224 KB at d = 128): tile j+1's K must be loaded before tile
//   j's P V is issued. P enters as a bf16 head plus its bf16 remainder
//   (p = hi + lo to ~2^-16, two wgmmas on the same V tile) so the output
//   keeps f32-level agreement with the plain version instead of the
//   2^-8 of a single bf16 P; the products cost 1.5x the function's
//   bound, the kernel's own arithmetic floor.
// * f32 (the f32 LM oracles and every smoke config):
//   flash_attention_tf32x3_kernel, split TF32 on the tensor cores. f32
//   FMAs outside them top out at 67 TFLOP/s; a single TF32 product
//   keeps 2^-11 of each operand, too coarse for f32 (2e-5). So each
//   operand x is split into a TF32 head hi and the remainder lo = x - hi
//   (of which the tensor core reads the top TF32 bits), and a product is
//   lo*hi + hi*lo + hi*hi (lo*lo, ~2^-20, dropped) by mma.sync m16n8k8
//   with f32 accumulators. hi truncates x (one and; ptxas then passes x
//   itself, as the tensor core ignores the 13 low bits) except for V,
//   whose hi is rounded to nearest (see split_tf32_rn). What bounds it:
//   three times the function's flops at the 495 TFLOP/s TF32 rate (1.67
//   ms at the prefill's shape); mma.sync itself peaks near two thirds of
//   that rate, and the splits and the softmax share the warps' issue
//   slots with the products. 8 warps own 32 rows each (two m16 tiles)
//   of a 256-row tile, so each split K or V value feeds two products
//   and each 32-key K/V tile in shared memory serves 256 rows; the tiles
//   arrive by cp.async in a two-stage ring (16 bytes a copy where the
//   layout allows, zero-filled past S and d) while the previous one is
//   consumed, one barrier a tile. Q sits scaled in shared memory with
//   each warp's rows g and g + 8 interleaved and a permutation of d
//   inside each 16 columns (in both operands), so one 16-byte read gives
//   an A fragment and one read of K the B fragments of two k-steps. The
//   S accumulator's P[g][2t], P[g][2t + 1] serve as P V's A fragment
//   directly, with V's keys permuted to match, so P moves through no
//   shuffle. The softmax runs once per 32 keys on the rows a quad holds,
//   in log2 units.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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

// 2^x by the SFU's ex2.approx (a few f32 ulp; results below 2^-126
// flush to 0), the softmax's exponential; exp2f adds range handling
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------- f32, split TF32 tensor cores

constexpr int kTfMT = 2;             // m16 tiles a warp: 32 query rows
constexpr int kTfBQ = 128 * kTfMT;   // query rows per block
constexpr int kTfBK = 32;            // keys per tile
constexpr int kTfThreads = 256;      // 8 warps
constexpr int kTfStages = 2;         // depth of the cp.async K/V ring

// Shared memory, in floats. Each layout lets one 16-byte read give a
// thread mma operands in register order, and a quarter-warp's eight
// reads hit eight distinct 16-byte bank groups.
// * Q, scaled: rows r and r + 8 of each 16 interleaved ("pair-row" r),
//   element (r + 8s, c) at 2c + s; pitch 2 DP + 4 (4 mod 32).
// * K: row-major, pitch DP + 16 (16 mod 32).
// * V: row-major, pitch DP + 4 (4 mod 32).
template <int DP>
struct TfLayout {
  static constexpr int kQP = 2 * DP + 4;
  static constexpr int kKP = DP + 16;
  static constexpr int kVP = DP + 4;
  static constexpr int kQ = kTfBQ / 2 * kQP;
  static constexpr int kK = kTfBK * kKP;
  static constexpr int kV = kTfBK * kVP;
  static constexpr int kBytes = 4 * (kQ + kTfStages * (kK + kV));
};

// x = hi + lo exactly, hi = x with its 13 low mantissa bits cleared (a
// TF32 value); the tensor core reads the top TF32 bits of lo, so
// |x - hi - tf32(lo)| < 2^-20 |x|. Where hi feeds an mma operand ptxas
// passes x itself (the tensor core ignores those 13 bits): the split
// costs one and and one subtraction.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// the same split with hi rounded to nearest (ties away from zero), by
// integer ops. hi is then a register of its own, written where the mma
// operand needs it: V's operand pairs come from two reads, and a
// truncated hi (the loaded register itself) would first be copied next
// to its partner. |x - hi - tf32(lo)| < 2^-21 |x|
__device__ __forceinline__ void split_tf32_rn(float x, uint32_t& hi,
                                              uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// D = A (16x8 tf32, row) * B (8x8 tf32, col) + D, f32 accumulators
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// keys [k0, k0 + 64) of one KV head into a (64 x pitch P) tile by
// cp.async: 16 bytes a copy when the head's base is 16-byte aligned and
// its s stride a multiple of 4 floats (vec), else 4. A whole tile of
// whole rows takes straight-line copies; an edge tile is zero-filled
// beyond S and d (a copy reads only the bytes in range).
template <int DP, int P>
__device__ __forceinline__ void load_tile(float* tile, const float* base,
                                          int64_t row_stride, int k0, int S,
                                          int d, bool vec) {
  constexpr int C = DP / 4, R = kTfThreads / C;   // a pass: R rows
  if (vec && d == DP && k0 + kTfBK <= S) {
    const int r = threadIdx.x / C, c = threadIdx.x % C * 4;
    const float* src = base + (k0 + r) * row_stride + c;
    float* dst = tile + r * P + c;
#pragma unroll
    for (int j = 0; j < kTfBK / R; ++j)
      cp_async16(dst + j * R * P, src + j * R * row_stride, 16);
  } else if (vec) {
    for (int idx = threadIdx.x; idx < kTfBK * C; idx += kTfThreads) {
      const int r = idx / C, c = idx % C * 4, key = k0 + r;
      const int n = key < S ? max(0, min(4, d - c)) : 0;
      cp_async16(tile + r * P + c, n ? base + key * row_stride + c : base,
                 4 * n);
    }
  } else {
    for (int idx = threadIdx.x; idx < kTfBK * DP; idx += kTfThreads) {
      const int r = idx / DP, c = idx % DP, key = k0 + r;
      const bool in = key < S && c < d;
      cp_async4(tile + r * P + c, in ? base + key * row_stride + c : base,
                in ? 4 : 0);
    }
  }
}

__device__ __forceinline__ bool vec_rows(const float* base, int64_t stride,
                                         int S) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0
      && (stride % 4 == 0 || S == 1);
}

template <int DP>
__global__ void __launch_bounds__(kTfThreads, 1)
flash_attention_tf32x3_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              float* __restrict__ out, int B, int S, int Hq,
                              int G, int d, Strides st, int causal,
                              int window, float scale_log2) {
  using L = TfLayout<DP>;
  constexpr int QP = L::kQP, KP = L::kKP, VP = L::kVP;
  constexpr int MT = kTfMT;          // m-tiles a warp, 16 rows each
  constexpr int NT = kTfBK / 8;      // n-tiles of S, 8 keys each
  constexpr int ND = DP / 8;         // n-tiles of O, 8 columns each
  constexpr int NJ = DP / 32;        // 32-column blocks of O
  extern __shared__ float4 tf_smem[];
  float* Qs = reinterpret_cast<float*>(tf_smem);
  auto Ks = [&](int s) { return Qs + L::kQ + s * (L::kK + L::kV); };
  auto Vs = [&](int s) { return Ks(s) + L::kK; };

  // heavy (late) q tiles first, over every head and batch
  const int n_qt = (S + kTfBQ - 1) / kTfBQ, per_qt = Hq * B;
  const int qt = n_qt - 1 - (int)(blockIdx.x / per_qt);
  const int h = blockIdx.x % per_qt % Hq, b = blockIdx.x % per_qt / Hq;
  const int hk = h / G, q0 = qt * kTfBQ;
  int k_begin, k_end;
  key_range(q0, kTfBQ, S, causal, window, &k_begin, &k_end);
  const int kt0 = k_begin / kTfBK;
  const int n_tiles = (k_end + kTfBK - 1) / kTfBK - kt0;

  const float* kb = k + b * st.kb + hk * st.kh;
  const float* vb = v + b * st.vb + hk * st.vh;
  const bool k_vec = vec_rows(kb, st.ks, S), v_vec = vec_rows(vb, st.vs, S);
  load_tile<DP, KP>(Ks(0), kb, st.ks, kt0 * kTfBK, S, d, k_vec);
  load_tile<DP, VP>(Vs(0), vb, st.vs, kt0 * kTfBK, S, d, v_vec);
  cp_async_commit();

  // q in log2 units (scale * log2 e), scaled in f32 before the dot as in
  // the TPU kernel, while the first tile is in flight
  const float* qb = q + b * st.qb + h * st.qh;
  for (int idx = threadIdx.x; idx < kTfBQ * DP; idx += kTfThreads) {
    const int r = idx / DP, c = idx % DP, row = q0 + r;
    Qs[(r >> 4 << 3 | (r & 7)) * QP + 2 * c + (r >> 3 & 1)] =
        (row < S && c < d) ? qb[row * st.qs + c] * scale_log2 : 0.f;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // this thread's rows: w_first + 16 mt + g + 8 hr
  const int w_first = q0 + warp * 16 * MT, w_last = w_first + 16 * MT - 1;
  // Q K^T permutes d inside each 16 columns, in both operands: k-step e
  // of a pair takes columns 4t + 2e (A's column t, B's row t) and 4t + 2e
  // + 1 (t + 4), so a 16-byte read of Q gives A (rows g, g + 8) and one of
  // K gives B of both k-steps
  const float* qf = Qs + (warp * MT * 8 + g) * QP + 8 * t;

  float o[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < ND; ++n)
      o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait_all();
    __syncthreads();                 // tile i landed, tile i - 1 consumed
    if (i + 1 < n_tiles) {
      const int nk = (kt0 + i + 1) * kTfBK, ns = (i + 1) % kTfStages;
      load_tile<DP, KP>(Ks(ns), kb, st.ks, nk, S, d, k_vec);
      load_tile<DP, VP>(Vs(ns), vb, st.vs, nk, S, d, v_vec);
      cp_async_commit();
    }
    const int k0 = (kt0 + i) * kTfBK;
    // a warp skips a tile none of its rows reaches (warp-uniform)
    if (w_first >= S || (causal && k0 > w_last)
        || (window > 0 && k0 + kTfBK - 1 <= w_first - window))
      continue;
    const bool masked = k0 + kTfBK > S
        || (causal && k0 + kTfBK - 1 > w_first)
        || (window > 0 && k0 <= w_last - window);
    const float* Kt = Ks(i % kTfStages) + g * KP + 4 * t;
    const float* Vt = Vs(i % kTfStages) + 2 * t * VP + 4 * g;

    // S = Q K^T: s[mt][nt] holds keys nt*8 + 2t + {0, 1} of row g ([0],
    // [1]) and row g + 8 ([2], [3]) of m-tile mt. Each split K value
    // serves both m-tiles; the products run so that independent ones
    // separate two on one accumulator.
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.f;
#pragma unroll
    for (int p = 0; p < DP / 16; ++p) {
      float4 kv[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        kv[nt] = *reinterpret_cast<const float4*>(Kt + nt * 8 * KP + 16 * p);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float4 qv = *reinterpret_cast<const float4*>(
              qf + mt * 8 * QP + 32 * p + 4 * e);
          split_tf32(qv.x, ah[mt][0], al[mt][0]);
          split_tf32(qv.y, ah[mt][1], al[mt][1]);
          split_tf32(qv.z, ah[mt][2], al[mt][2]);
          split_tf32(qv.w, ah[mt][3], al[mt][3]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          split_tf32(e ? kv[nt].z : kv[nt].x, bh[nt][0], bl[nt][0]);
          split_tf32(e ? kv[nt].w : kv[nt].y, bh[nt][1], bl[nt][1]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_tf32(s[mt][nt], al[mt], bh[nt][0], bh[nt][1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_tf32(s[mt][nt], ah[mt], bl[nt][0], bl[nt][1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_tf32(s[mt][nt], ah[mt], bh[nt][0], bh[nt][1]);
      }
    }

    // mask (edge tiles only) and the online softmax in log2 units; each
    // row lives in a quad
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = w_first + 16 * mt + g + 8 * hr;
        float mx = kNegInf;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[mt][nt][2 * hr + e];
            if (masked && !keep(k0 + nt * 8 + 2 * t + e, row, S, causal,
                                window))
              x = kNegInf;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][hr], mx);
        const float alpha = exp2_approx(m[mt][hr] - m_new);
        float ps = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[mt][nt][2 * hr + e];
            x = exp2_approx(x - m_new);
            ps += x;
          }
        l[mt][hr] = alpha * l[mt][hr] + ps;  // this lane's share
        m[mt][hr] = m_new;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          o[mt][n][2 * hr] *= alpha;
          o[mt][n][2 * hr + 1] *= alpha;
        }
      }

    // O += P V, k-step kk = keys kk*8 .. kk*8 + 7. The accumulator's
    // P[g][2t], P[g][2t + 1] serve as A's (g, t), (g, t + 4): keys 2t and
    // 2t + 1 take A's columns t and t + 4, so B's rows t and t + 4 are
    // V's keys 2t and 2t + 1, and no shuffle moves P. Column n of O's
    // n-tile 4j + c is output column 32j + 4n + c, so a thread's 16-byte
    // reads of rows 2t and 2t + 1 give B of four n-tiles, for both
    // m-tiles.
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split_tf32(s[mt][kk][0], ph[mt][0], pl[mt][0]);
        split_tf32(s[mt][kk][2], ph[mt][1], pl[mt][1]);
        split_tf32(s[mt][kk][1], ph[mt][2], pl[mt][2]);
        split_tf32(s[mt][kk][3], ph[mt][3], pl[mt][3]);
      }
      const float* vr = Vt + kk * 8 * VP;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t vh[8], vl[8];
        const float4 v0 = *reinterpret_cast<const float4*>(vr + 32 * j);
        const float4 v1 =
            *reinterpret_cast<const float4*>(vr + VP + 32 * j);
        split_tf32_rn(v0.x, vh[0], vl[0]);
        split_tf32_rn(v1.x, vh[1], vl[1]);
        split_tf32_rn(v0.y, vh[2], vl[2]);
        split_tf32_rn(v1.y, vh[3], vl[3]);
        split_tf32_rn(v0.z, vh[4], vl[4]);
        split_tf32_rn(v1.z, vh[5], vl[5]);
        split_tf32_rn(v0.w, vh[6], vl[6]);
        split_tf32_rn(v1.w, vh[7], vl[7]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            mma_tf32(o[mt][4 * j + c], pl[mt], vh[2 * c], vh[2 * c + 1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            mma_tf32(o[mt][4 * j + c], ph[mt], vl[2 * c], vl[2 * c + 1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            mma_tf32(o[mt][4 * j + c], ph[mt], vh[2 * c], vh[2 * c + 1]);
      }
    }
  }

  // thread (g, t) holds output columns 32j + 8t .. 32j + 8t + 7 of its
  // rows: o[mt][4j + c][2hr] is column 32j + 8t + c, o[mt][4j + c][2hr +
  // 1] column 32j + 8t + 4 + c
  float* ob = out + ((int64_t)b * S * Hq + h) * d;
  const bool vec_out = d % 4 == 0;   // 16-byte aligned column groups
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float lt = l[mt][hr];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int row = w_first + 16 * mt + g + 8 * hr;
      if (row >= S) continue;
      const float inv = 1.f / fmaxf(lt, 1e-30f);
      float* orow = ob + (int64_t)row * Hq * d;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c0 = 32 * j + 8 * t;
        float x[8];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          x[c] = o[mt][4 * j + c][2 * hr] * inv;
          x[c + 4] = o[mt][4 * j + c][2 * hr + 1] * inv;
        }
        if (vec_out && c0 + 8 <= d) {
          *reinterpret_cast<float4*>(orow + c0) =
              make_float4(x[0], x[1], x[2], x[3]);
          *reinterpret_cast<float4*>(orow + c0 + 4) =
              make_float4(x[4], x[5], x[6], x[7]);
        } else {
#pragma unroll
          for (int c = 0; c < 8; ++c)
            if (c0 + c < d) orow[c0 + c] = x[c];
        }
      }
    }
}

// ------------------------------------- bf16, wgmma on TMA-fed tiles

constexpr int kWgBQ = 128;           // query rows per block, 64 a consumer
constexpr int kWgBK = 128;           // keys per tile
constexpr int kWgStages = 3;         // depth of the K/V ring
constexpr int kWgThreads = 384;      // consumer warpgroups 0, 1; producer 2
constexpr int kBoxCols = 64;         // bf16 columns of a TMA box: 128 bytes
constexpr int kProducerRegs = 24;    // setmaxnreg: 128 x 24 + 256 x 240
constexpr int kConsumerRegs = 240;   // = 64 512 of the SM's 65 536

// p (two f32) as a bf16 pair, p[0] in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// D = A (16x16 bf16, row) * B (16x8 bf16, col) + D, f32 accumulators

// shared memory, as byte offsets from a 1024-byte-aligned base: Q (all
// boxes of the 128-row tile), then per stage a K tile and a V tile, then
// the mbarriers q_full and per stage k_full, v_full, empty
template <int DP>
struct WgLayout {
  static constexpr int kBoxes = DP / kBoxCols;
  static constexpr int kQBox = kWgBQ * 128;
  static constexpr int kKBox = kWgBK * 128;
  static constexpr int kQ = kBoxes * kQBox;
  static constexpr int kKV = kBoxes * kKBox;
  static constexpr int kBars = kQ + kWgStages * 2 * kKV;
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kWgStages)
      + 1024;                        // room to align the base
};

// O (64 x DP) += P (64 x 16, registers) V (16 x DP, MN-major)
template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2],
                                         const uint32_t (&p)[4],
                                         uint64_t v) {
  if constexpr (DP == 128)
    hopper::wgmma_m64n128k16_rs_tb(o, p, v);
  else
    hopper::wgmma_m64n64k16_rs_tb(o, p, v);
}

template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             bf16* __restrict__ out, int B, int S, int Hq,
                             int G, int d, int causal, int window,
                             float scale_log2) {
  using L = WgLayout<DP>;
  constexpr int NS = kWgBK / 2;      // S accumulators a thread (64 x 128)
  constexpr int NO = DP / 2;         // O accumulators a thread (64 x DP)
  constexpr int KT = kWgBK / 16;     // k-steps of P V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, bars = base + L::kBars, q_full = bars;
  auto k_s = [&](int st) { return base + L::kQ + st * 2 * L::kKV; };
  auto v_s = [&](int st) { return k_s(st) + L::kKV; };
  auto k_full = [&](int st) { return bars + 8 * (1 + 3 * st); };
  auto v_full = [&](int st) { return bars + 8 * (2 + 3 * st); };
  auto empty = [&](int st) { return bars + 8 * (3 + 3 * st); };

  // heavy (late) q tiles first, over every head and batch
  const int n_qt = (S + kWgBQ - 1) / kWgBQ, per_qt = Hq * B;
  const int qt = n_qt - 1 - (int)(blockIdx.x / per_qt);
  const int h = blockIdx.x % per_qt % Hq, b = blockIdx.x % per_qt / Hq;
  const int hk = h / G, q0 = qt * kWgBQ;
  int k_begin, k_end;
  key_range(q0, kWgBQ, S, causal, window, &k_begin, &k_end);
  const int t0 = k_begin / kWgBK;
  const int n_tiles = (k_end + kWgBK - 1) / kWgBK - t0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int st = 0; st < kWgStages; ++st) {
      hopper::mbar_init(k_full(st), 1);
      hopper::mbar_init(v_full(st), 1);
      hopper::mbar_init(empty(st), 2 * 128);   // every consumer thread
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer: one thread keeps the ring full
    hopper::regs_dealloc<kProducerRegs>();
    if (tid == 256) {
      hopper::mbar_expect_tx(q_full, L::kQ);
      for (int nb = 0; nb < L::kBoxes; ++nb)
        hopper::tma_load_4d(q_s + nb * L::kQBox, &qmap, q_full,
                            nb * kBoxCols, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kWgStages, round = i / kWgStages;
        if (round > 0) hopper::mbar_wait(empty(st), (round - 1) & 1);
        const int k0 = (t0 + i) * kWgBK;
        hopper::mbar_expect_tx(k_full(st), L::kKV);
        for (int nb = 0; nb < L::kBoxes; ++nb)
          hopper::tma_load_4d(k_s(st) + nb * L::kKBox, &kmap, k_full(st),
                              nb * kBoxCols, hk, k0, b);
        hopper::mbar_expect_tx(v_full(st), L::kKV);
        for (int nb = 0; nb < L::kBoxes; ++nb)
          hopper::tma_load_4d(v_s(st) + nb * L::kKBox, &vmap, v_full(st),
                              nb * kBoxCols, hk, k0, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [r0, r0 + 64). The two take
    // turns on the tensor cores (named barriers 1 and 2): in its turn a
    // warpgroup issues Q K^T of the next tile and P V of this one, then
    // runs the next tile's softmax while the other one's products run.
    // Both walk every key tile of the block, as the reference's 128-row
    // tiles do: one that none of a warpgroup's rows reaches (a window's
    // first tile) gives them exp(0) "garbage", cleared at the next key.
    hopper::regs_alloc<kConsumerRegs>();
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int r0 = q0 + wg * 64;
    const int row0 = r0 + warp * 16 + (lane >> 2), row1 = row0 + 8;
    const int pair = (lane & 3) * 2;
    const uint32_t q_wg = q_s + wg * 64 * 128;
    auto turn_wait = [&] { hopper::bar_sync(1 + wg, 256); };
    auto turn_pass = [&] { hopper::bar_arrive(2 - wg, 256); };

    // S (64 x 128) = Q K^T of the tile in stage st, as one commit group:
    // s[4j + 2hr + e] is row (hr ? row1 : row0), key k0 + 8j + pair + e.
    // Each tile has its own s: a loop-carried s, last written in the
    // softmax's masked/unmasked branches, makes ptxas serialise wgmma.
    auto issue_qk = [&](float (&s)[NS], int st) {
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        const int off = (ks / 4) * L::kQBox + (ks % 4) * 32;
        const int koff = (ks / 4) * L::kKBox + (ks % 4) * 32;
        hopper::wgmma_m64n128k16_ss(
            s, hopper::sw128_desc(q_wg + off, 16, 1024),
            hopper::sw128_desc(k_s(st) + koff, 16, 1024), ks);
      }
      hopper::wgmma_commit();
    };

    // O += P V for the tile in stage st, P = hi + lo (bf16 A fragments of
    // keys 16kk..16kk+15), as one commit group
    float o[NO];
#pragma unroll
    for (int j = 0; j < NO; ++j) o[j] = 0.f;
    uint32_t hi[KT][4], lo[KT][4];
    auto issue_pv = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const uint64_t vd =
            hopper::sw128_desc(v_s(st) + kk * 16 * 128, L::kKBox, 1024);
        wgmma_pv<DP>(o, hi[kk], vd);
        wgmma_pv<DP>(o, lo[kk], vd);
      }
      hopper::wgmma_commit();
    };
    auto fence_pv = [&] {           // after the wait for a P V group
#pragma unroll
      for (int j = 0; j < NO; ++j) hopper::reg_fence(o[j]);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          hopper::reg_fence(hi[kk][f]);
          hopper::reg_fence(lo[kk][f]);
        }
    };

    // scale (log2 domain), mask where the tile is not inside every row's
    // reach, and the online softmax statistics of the scores of tile k0;
    // s becomes p, alpha the rescaling of O. A row lives in a quad.
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
    auto softmax = [&](float (&s)[NS], int k0) {
      const bool inside = k0 + kWgBK <= S
          && (!causal || k0 + kWgBK - 1 <= r0)
          && (window == 0 || k0 > r0 + 63 - window);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = hr ? row1 : row0;
        float mx = kNegInf;
        if (inside) {
#pragma unroll
          for (int j = 0; j < NS / 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = s[4 * j + 2 * hr + e];
              x *= scale_log2;
              mx = fmaxf(mx, x);
            }
        } else {
#pragma unroll
          for (int j = 0; j < NS / 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = s[4 * j + 2 * hr + e];
              x = keep(k0 + 8 * j + pair + e, row, S, causal, window)
                  ? x * scale_log2 : kNegInf;
              mx = fmaxf(mx, x);
            }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hr], mx);
        alpha[hr] = exp2_approx(m[hr] - m_new);
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < NS / 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * hr + e];
            x = exp2_approx(x - m_new);
            ps += x;
          }
        l[hr] = alpha[hr] * l[hr] + ps;  // this lane's share, quad-summed
        m[hr] = m_new;                   // at the end
      }
    };
    // O *= alpha; p -> hi, lo
    auto rescale_and_pack = [&](const float (&s)[NS]) {
#pragma unroll
      for (int j = 0; j < NO / 4; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          o[4 * j + 2 * hr] *= alpha[hr];
          o[4 * j + 2 * hr + 1] *= alpha[hr];
        }
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const float* x = s + 8 * kk + 2 * f;
          hi[kk][f] = pack(x[0], x[1]);
          const __nv_bfloat162 t =
              *reinterpret_cast<const __nv_bfloat162*>(&hi[kk][f]);
          lo[kk][f] = pack(x[0] - __low2float(t), x[1] - __high2float(t));
        }
    };

    // both warpgroups take n_tiles + 1 turns; warpgroup 0 goes first
    if (wg == 1) turn_pass();
    hopper::mbar_wait(q_full, 0);
    hopper::mbar_wait(k_full(0), 0);
    {
      float s[NS];
      turn_wait();
      hopper::wgmma_fence();
      issue_qk(s, 0);
      turn_pass();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < NS; ++j) hopper::reg_fence(s[j]);
      softmax(s, t0 * kWgBK);
      rescale_and_pack(s);
    }
    // every tile but the last: its P V and the next tile's Q K^T in one
    // turn (no branch around a wgmma, or ptxas serialises them)
    for (int i = 0; i + 1 < n_tiles; ++i) {
      const int st = i % kWgStages, nst = (i + 1) % kWgStages;
      hopper::mbar_wait(k_full(nst), ((i + 1) / kWgStages) & 1);
      hopper::mbar_wait(v_full(st), (i / kWgStages) & 1);
      float s[NS];
      turn_wait();
      hopper::wgmma_fence();
      issue_qk(s, nst);
      issue_pv(st);
      turn_pass();
      hopper::wgmma_wait<1>();           // S of the next tile
#pragma unroll
      for (int j = 0; j < NS; ++j) hopper::reg_fence(s[j]);
      softmax(s, (t0 + i + 1) * kWgBK);
      hopper::wgmma_wait<0>();           // P V of this tile
      fence_pv();
      hopper::mbar_arrive(empty(st));
      rescale_and_pack(s);
    }
    {                                    // the last tile's P V
      const int i = n_tiles - 1, st = i % kWgStages;
      hopper::mbar_wait(v_full(st), (i / kWgStages) & 1);
      turn_wait();
      hopper::wgmma_fence();
      issue_pv(st);
      if (wg == 0) turn_pass();          // warpgroup 1's last turn ends it
      hopper::wgmma_wait<0>();
      fence_pv();
      hopper::mbar_arrive(empty(st));
    }

    bf16* ob = out + ((int64_t)b * S * Hq + h) * d;
    const bool pairs = (d & 1) == 0;       // 4-byte aligned bf16 pairs
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
      for (int j = 0; j < NO / 4; ++j) {
        const int c = 8 * j + pair;
        const float x0 = o[4 * j + 2 * hr] * inv;
        const float x1 = o[4 * j + 2 * hr + 1] * inv;
        if (pairs && c + 1 < d) {
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          if (c < d) orow[c] = __float2bfloat16(x0);
          if (c + 1 < d) orow[c + 1] = __float2bfloat16(x1);
        }
      }
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
int launch_tf32x3(const float* q, const float* k, const float* v, float* out,
                  int B, int S, int Hq, int Hkv, int d, const Strides& st,
                  int causal, int window, cudaStream_t stream) {
  static bool done = false;
  auto kernel = flash_attention_tf32x3_kernel<DP>;
  constexpr int bytes = TfLayout<DP>::kBytes;
  const cudaError_t err = allow_smem(kernel, bytes, &done);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)((S + kTfBQ - 1) / kTfBQ) * Hq * B;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)d));
  kernel<<<(unsigned)blocks, kTfThreads, bytes, stream>>>(
      q, k, v, out, B, S, Hq, Hq / Hkv, d, st, causal, window, scale_log2);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, a driver-API function, through the runtime's
// driver entry point, so that the library links nothing beyond the
// runtime (the card's machine may have no unversioned libcuda.so)
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// host-side failures of the wgmma launch, below every cudaError_t
constexpr int kErrNoEncoder = -1;    // no cuTensorMapEncodeTiled
constexpr int kErrTensorMap = -2;    // the driver refused a tensor map

// a (B, S, H, d) bf16 tensor with element strides sb, ss, sh (d stride 1)
// as a 4-D map over (d, H, S, B) whose box is 64 columns x `rows` rows of
// one head, 128-byte swizzled, zero outside the tensor
bool make_map(EncodeTiledFn encode, CUtensorMap* map, const bf16* ptr,
              int B, int S, int H, int d, int64_t sb, int64_t ss,
              int64_t sh, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const int64_t extent[3] = {H, S, B}, stride[3] = {sh, ss, sb};
  cuuint64_t bytes[3];
  for (int i = 0; i < 3; ++i)        // a dimension of size 1 is never
    bytes[i] = extent[i] > 1         // stepped: any legal stride will do
        ? (cuuint64_t)stride[i] * 2 : (cuuint64_t)((2 * d + 15) / 16 * 16);
  const cuuint32_t box[4] = {kBoxCols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, (void*)ptr, dims,
                bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int launch_wgmma(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                 int B, int S, int Hq, int Hkv, int d, const Strides& st,
                 int causal, int window, cudaStream_t stream) {
  static bool done = false;
  auto kernel = flash_attention_wgmma_kernel<DP>;
  constexpr int bytes = WgLayout<DP>::kBytes;
  const cudaError_t err = allow_smem(kernel, bytes, &done);
  if (err != cudaSuccess) return (int)err;
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return kErrNoEncoder;
  CUtensorMap qm, km, vm;            // 64-byte aligned by their type
  if (!make_map(encode, &qm, q, B, S, Hq, d, st.qb, st.qs, st.qh, kWgBQ)
      || !make_map(encode, &km, k, B, S, Hkv, d, st.kb, st.ks, st.kh, kWgBK)
      || !make_map(encode, &vm, v, B, S, Hkv, d, st.vb, st.vs, st.vh, kWgBK))
    return kErrTensorMap;
  const int64_t blocks = (int64_t)((S + kWgBQ - 1) / kWgBQ) * Hq * B;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)d));
  kernel<<<(unsigned)blocks, kWgThreads, bytes, stream>>>(
      qm, km, vm, out, B, S, Hq, Hq / Hkv, d, causal, window, scale_log2);
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
// 1 <= d <= 128; Hq % Hkv == 0; S >= 1; window >= 0;
// ceil(S / 128) * Hq * B < 2^31; out a contiguous (B, S, Hq, d) buffer it
// allocated.
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* out, int B, int S,
                                   int Hq, int Hkv, int d,
                                   const long long* strides, int causal,
                                   int window, void* stream) {
  const Strides st = strides_of(strides);
  const cudaStream_t s = (cudaStream_t)stream;
  if (d <= 32)
    return launch_tf32x3<32>(q, k, v, out, B, S, Hq, Hkv, d, st,
                             causal, window, s);
  if (d <= 64)
    return launch_tf32x3<64>(q, k, v, out, B, S, Hq, Hkv, d, st,
                             causal, window, s);
  return launch_tf32x3<128>(q, k, v, out, B, S, Hq, Hkv, d, st, causal,
                            window, s);
}

// The wgmma kernel. The caller guarantees in addition: every base address
// 16-byte aligned and every b, s, h stride of a dimension longer than 1
// a positive multiple of 8 elements.
// Returns kErrNoEncoder or kErrTensorMap (negative) when the tensor maps
// cannot be made.
extern "C" int flash_attention_bf16_wgmma(const bf16* q, const bf16* k,
                                          const bf16* v, bf16* out, int B,
                                          int S, int Hq, int Hkv, int d,
                                          const long long* strides,
                                          int causal, int window,
                                          void* stream) {
  const Strides st = strides_of(strides);
  const cudaStream_t s = (cudaStream_t)stream;
  if (d <= 64)
    return launch_wgmma<64>(q, k, v, out, B, S, Hq, Hkv, d, st, causal,
                            window, s);
  return launch_wgmma<128>(q, k, v, out, B, S, Hq, Hkv, d, st, causal,
                           window, s);
}
