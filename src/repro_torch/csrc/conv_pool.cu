// K6: the paper CNN's conv block, 5x5 VALID conv -> ReLU -> 2x2/2
// max-pool, fused, forward and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes the block as plain
// jnp (an im2col stack and a matmul, src/repro/models/cnn.py _conv and
// _maxpool2), and so did the port until this kernel. Under vmap that
// composition writes 25 shifted copies of every input (the patches) to
// device memory with a strided copy that does not coalesce, then reads
// them back for the GEMM; its backward zero-fills and adds the full
// input 25 times. The copies took a third to over half of every traced
// benchmark window.
//
// Layouts are the model's: x (G, B, H, W, C) NHWC and w (G, 5, 5, C, O)
// HWIO, one weight set a group (G is the vmapped device axis, 1 outside
// vmap). With Ho = H - 4, Wo = W - 4 (both even):
//
//   forward  y[g,b,i,j,o]   = max(0, max_{a,c in 0..1} z[g,b,2i+a,2j+c,o])
//            idx[g,b,i,j,o] = 2a + c of the first maximum in row-major
//                             order, or 255 where the maximum is <= 0
//            z[g,b,p,q,o]   = sum_{kh,kw,c} x[g,b,p+kh,q+kw,c] w[g,kh,kw,c,o]
//   backward dz = dy at each window's idx, 0 elsewhere (ReLU and pool)
//            dw[g,kh,kw,c,o] = sum_{b,p,q} x[g,b,p+kh,q+kw,c] dz[g,b,p,q,o]
//            dx[g,b,r,t,c]   = sum_{kh,kw,o} dz[g,b,r-kh,t-kw,o] w[g,kh,kw,c,o]
//
// Every product and sum is an f32 FMA (no TF32): the configurations'
// precision is float32 with TF32 off.
//
// What bounds it on this card: the forward, operations. At the main
// path's shapes a sample's block is 0.43-2.1 MFLOP over 3-12 KB in and
// 2-15 KB out (y and a byte of idx a pooled element), so at 67 TFLOP/s
// f32 and 3.35 TB/s the flops take 1.6x (conv 1) to 6x (conv 2) the
// bytes' time, provided nothing else reaches device memory. The
// backward needs a quarter of the dense flops (idx routes each window's
// gradient to one position) and is bound by bytes for conv 1.
//
// Design: implicit GEMM, with every operand staged in shared memory and
// every sum kept in registers.
// - Forward: a block holds one group's weights (each group of OC output
//   channels padded to a multiple of 4, so a thread reads them as
//   float4s that every thread of a warp shares) and a stage of samples
//   (odd sample stride: two samples of a warp fall on other banks). A
//   thread computes one pooled position, the 2x2 quad under it, for OC
//   channels: for each (kh, c) it reads the 2 x 6 inputs the quad's five
//   taps kw need, then 4 x OC FMAs a tap. Pool, ReLU and idx happen in
//   registers; the pre-pool activation never leaves them.
// - dW: dz is rebuilt in shared memory from dy and idx (one pooled
//   element writes its window's four positions), position-major with
//   each position's channels padded to float4 groups plus 4 floats, so
//   consecutive positions of a warp's lanes fall on other banks. A
//   thread owns one (og, kh, c) and the 5 kw x OC sums of it; `lanes`
//   threads split the positions of a stage where the tiles are few
//   (conv 1), and sum their partials by a fixed butterfly of warp
//   shuffles. Each block writes its partial to `part`; a second kernel
//   sums the blocks of a group in block order. No float atomics: the
//   same inputs give the same bits, and since the plan depends on the
//   shapes of one group alone, a group's dW does not depend on G.
// - dx (an implicit transposed conv): the weights transposed to
//   [kh][kw][o][c] (c padded to 4), dz rebuilt channel-major (odd plane
//   stride); a thread computes a 2x2 quad of input positions for every
//   c, reading 2 x 6 dz values a (kh, o) (zero outside the conv output)
//   and 4 x C FMAs a tap.
// Plain copies into shared memory (weights, inputs) are 4-byte cp.async,
// every copy of a stage in flight before one wait; dz is built from dy
// and idx loaded 8 elements a thread before any is written, for the same
// reason: a stage's loads overlap instead of queuing behind each other.
// Each entry makes its own launch plan (`make_plan`: samples a stage,
// samples a block, threads, lanes) from the shapes alone, so the caller
// passes only shapes and pointers; `conv_pool_takes` says which shapes
// the entries take, and `conv_pool_dw_chunks` how many partial sums of
// dW a group needs.

#include <cuda_runtime.h>
#include <initializer_list>
#include <stdint.h>

namespace {

constexpr int kK = 5;                 // kernel side
constexpr int kTaps = kK * kK;
constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 232448;      // dynamic shared memory of a block
constexpr int kMaxDevices = 64;
constexpr uint8_t kNone = 255;        // idx where the window's max <= 0

__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

// output channels a forward thread keeps, and a dW thread
template <int O> struct Groups;
template <> struct Groups<15> { static constexpr int fwd = 15, dw = 15; };
template <> struct Groups<28> { static constexpr int fwd = 7, dw = 14; };

// 4 bytes global -> shared, asynchronously; zero-filled when !ok. A
// stage issues every copy before it waits once, so their latencies
// overlap instead of adding up.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok = true) {
  asm volatile(
      "cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
      :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src),
         "r"(ok ? 4 : 0)
      : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void load4(float* dst, const float* src) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(src)[q];
    dst[4 * q] = v.x;
    dst[4 * q + 1] = v.y;
    dst[4 * q + 2] = v.z;
    dst[4 * q + 3] = v.w;
  }
}

// dz of the stage's samples [first, first + ns) in shared memory, from
// dy and idx: pooled element (s, i, j, o) writes dy to its window's idx
// position and 0 to the other three; element (s, p, q, o) lands at
// s*s_stride + p*row + q*col + o_off(o)
// (kBatch elements a thread are loaded before any is written, so that
// many loads are in flight at once)
template <int O, typename Off>
__device__ __forceinline__ void stage_dz(float* dst, const float* dy,
                                         const uint8_t* idx, int ns,
                                         int Hp, int Wp, int s_stride,
                                         int row, int col, Off o_off) {
  constexpr int kBatch = 8;
  const int PO = Hp * Wp * O, n = ns * PO, nt = blockDim.x;
  for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * nt) {
    float v[kBatch];
    int k[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * nt;
      v[b] = i < n ? dy[i] : 0.f;
      k[b] = i < n ? idx[i] : kNone;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * nt;
      if (i >= n) break;
      const int o = i % O, pq = (i / O) % (Hp * Wp), s = i / PO;
      float* d = dst + s * s_stride + 2 * (pq / Wp) * row
                 + 2 * (pq % Wp) * col + o_off(o);
      d[0] = k[b] == 0 ? v[b] : 0.f;
      d[col] = k[b] == 1 ? v[b] : 0.f;
      d[row] = k[b] == 2 ? v[b] : 0.f;
      d[row + col] = k[b] == 3 ? v[b] : 0.f;
    }
  }
}

// ------------------------------------------------------------- forward

template <int C, int O>
size_t fwd_smem(int H, int W, int stage) {
  constexpr int OC = Groups<O>::fwd;
  return 4 * ((size_t)kTaps * C * (O / OC) * pad4(OC)
              + (size_t)stage * ((H * W * C) | 1));
}

template <int C, int O, int OC>
__global__ void __launch_bounds__(kMaxThreads)
conv_pool_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ y, uint8_t* __restrict__ idx,
                     int B, int H, int W, int stage, int per_block) {
  constexpr int OCP = pad4(OC), NOG = O / OC, WS = kTaps * C * NOG * OCP;
  extern __shared__ float4 smem[];
  float* ws = reinterpret_cast<float*>(smem);   // [kh][kw][c][og][OCP]
  float* xs = ws + WS;                          // [stage][XS]
  const int Hp = (H - kK + 1) / 2, Wp = (W - kK + 1) / 2, P = Hp * Wp;
  const int HWC = H * W * C, XS = HWC | 1;
  const int g = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;
  const float* wg = w + (size_t)g * kTaps * C * O;
  for (int i = tid; i < WS; i += nt) {
    const int j = i % OCP, og = (i / OCP) % NOG, tap = i / (OCP * NOG);
    cp_async4(ws + i, wg + tap * O + og * OC + min(j, OC - 1), j < OC);
  }
  const int first = blockIdx.x * per_block;
  const int last = min(B, first + per_block);
  for (int s0 = first; s0 < last; s0 += stage) {
    const int ns = min(stage, last - s0);
    __syncthreads();     // the last stage is read
    const float* xg = x + ((size_t)g * B + s0) * HWC;
    for (int i = tid; i < ns * HWC; i += nt)
      cp_async4(xs + (i / HWC) * XS + i % HWC, xg + i);
    cp_async_wait_all();
    __syncthreads();
    const int items = ns * P;
    for (int it = tid; it < NOG * items; it += nt) {
      const int og = it / items, s = (it % items) / P, pq = it % P;
      const int pi = pq / Wp, pj = pq % Wp;
      const float* xb = xs + s * XS + (2 * pi * W + 2 * pj) * C;
      const float* wb = ws + og * OCP;
      float acc[4][OC];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int o = 0; o < OC; ++o) acc[a][o] = 0.f;
#pragma unroll
      for (int kh = 0; kh < kK; ++kh) {
#pragma unroll (C <= 3 ? C : 1)
        for (int c = 0; c < C; ++c) {
          const float* r0 = xb + kh * W * C + c;
          float a0[kK + 1], a1[kK + 1];
#pragma unroll
          for (int j = 0; j <= kK; ++j) {
            a0[j] = r0[j * C];
            a1[j] = r0[(W + j) * C];
          }
#pragma unroll
          for (int kw = 0; kw < kK; ++kw) {
            float wv[OCP];
            load4<OCP>(wv, wb + ((kh * kK + kw) * C + c) * NOG * OCP);
#pragma unroll
            for (int o = 0; o < OC; ++o) {
              acc[0][o] = fmaf(a0[kw], wv[o], acc[0][o]);
              acc[1][o] = fmaf(a0[kw + 1], wv[o], acc[1][o]);
              acc[2][o] = fmaf(a1[kw], wv[o], acc[2][o]);
              acc[3][o] = fmaf(a1[kw + 1], wv[o], acc[3][o]);
            }
          }
        }
      }
      const size_t out = (((size_t)g * B + s0 + s) * P + pq) * O + og * OC;
#pragma unroll
      for (int o = 0; o < OC; ++o) {
        float best = acc[0][o];
        int k = 0;
        if (acc[1][o] > best) { best = acc[1][o]; k = 1; }
        if (acc[2][o] > best) { best = acc[2][o]; k = 2; }
        if (acc[3][o] > best) { best = acc[3][o]; k = 3; }
        y[out + o] = best > 0.f ? best : 0.f;
        idx[out + o] = best > 0.f ? (uint8_t)k : kNone;
      }
    }
  }
}

// ------------------------------------------------------------------ dW

template <int C, int O>
size_t dw_smem(int H, int W, int stage) {
  constexpr int OC = Groups<O>::dw;
  const int HoWo = (H - kK + 1) * (W - kK + 1);
  return 4 * (size_t)stage
         * ((size_t)HoWo * ((O / OC) * pad4(OC) + 4) + H * W * C);
}

template <int C, int O, int OC>
__global__ void __launch_bounds__(kMaxThreads)
conv_pool_dw_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                    const uint8_t* __restrict__ idx, float* __restrict__ part,
                    int B, int H, int W, int stage, int per_block,
                    int lanes) {
  constexpr int OCP = pad4(OC), NOG = O / OC, DS = NOG * OCP + 4;
  constexpr int M = NOG * kK * C;     // threads that own a tile
  extern __shared__ float4 smem[];
  const int Ho = H - kK + 1, Wo = W - kK + 1, Hp = Ho / 2, Wp = Wo / 2;
  const int HW = Ho * Wo, HWC = H * W * C, PO = Hp * Wp * O;
  float* ds = reinterpret_cast<float*>(smem);   // [stage][Ho*Wo][DS]
  float* xs = ds + stage * HW * DS;             // [stage][H*W*C]
  const int g = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;
  const int m = tid / lanes, r = tid % lanes;
  const bool owner = m < M;
  const int og = m / (kK * C), kh = (m / C) % kK, c = m % C;
  for (int i = tid; i < stage * HW * DS; i += nt) ds[i] = 0.f;  // padding
  float acc[kK][OC];
#pragma unroll
  for (int kw = 0; kw < kK; ++kw)
#pragma unroll
    for (int o = 0; o < OC; ++o) acc[kw][o] = 0.f;
  const int first = blockIdx.x * per_block;
  const int last = min(B, first + per_block);
  for (int s0 = first; s0 < last; s0 += stage) {
    const int ns = min(stage, last - s0);
    __syncthreads();
    const float* xg = x + ((size_t)g * B + s0) * HWC;
    for (int i = tid; i < ns * HWC; i += nt) cp_async4(xs + i, xg + i);
    const size_t at = ((size_t)g * B + s0) * PO;
    stage_dz<O>(ds, dy + at, idx + at, ns, Hp, Wp, HW * DS, Wo * DS, DS,
                [](int o) { return (o / OC) * OCP + o % OC; });
    cp_async_wait_all();
    __syncthreads();
    if (owner) {
      for (int u = r; u < ns * HW; u += lanes) {
        const int s = u / HW, pq = u % HW;
        const float* xr =
            xs + s * HWC + ((pq / Wo + kh) * W + pq % Wo) * C + c;
        float xv[kK], dv[OCP];
#pragma unroll
        for (int kw = 0; kw < kK; ++kw) xv[kw] = xr[kw * C];
        load4<OCP>(dv, ds + u * DS + og * OCP);
#pragma unroll
        for (int kw = 0; kw < kK; ++kw)
#pragma unroll
          for (int o = 0; o < OC; ++o)
            acc[kw][o] = fmaf(xv[kw], dv[o], acc[kw][o]);
      }
    }
  }
  // the lanes of a tile (aligned groups of a warp) sum their partials
  for (int off = lanes / 2; off > 0; off /= 2)
#pragma unroll
    for (int kw = 0; kw < kK; ++kw)
#pragma unroll
      for (int o = 0; o < OC; ++o)
        acc[kw][o] += __shfl_xor_sync(0xffffffffu, acc[kw][o], off);
  if (owner && r == 0) {
    float* pg = part + ((size_t)g * gridDim.x + blockIdx.x) * kTaps * C * O;
#pragma unroll
    for (int kw = 0; kw < kK; ++kw)
#pragma unroll
      for (int o = 0; o < OC; ++o)
        pg[((kh * kK + kw) * C + c) * O + og * OC + o] = acc[kw][o];
  }
}

// dw[g, j] = sum over the group's blocks k, in order, of part[g, k, j]
__global__ void conv_pool_dw_sum_kernel(const float* __restrict__ part,
                                        float* __restrict__ dw, int G,
                                        int chunks, int n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)G * n) return;
  const float* p = part + (i / n) * chunks * n + i % n;
  float s = 0.f;
  for (int k = 0; k < chunks; ++k) s += p[(size_t)k * n];
  dw[i] = s;
}

// ------------------------------------------------------------------ dx

template <int C, int O>
size_t dx_smem(int H, int W, int stage) {
  const int HoWo = (H - kK + 1) * (W - kK + 1);
  return 4 * ((size_t)kTaps * O * pad4(C)
              + (size_t)stage * O * (HoWo | 1));
}

template <int C, int O>
__global__ void __launch_bounds__(kMaxThreads)
conv_pool_dx_kernel(const float* __restrict__ w, const float* __restrict__ dy,
                    const uint8_t* __restrict__ idx, float* __restrict__ dx,
                    int B, int H, int W, int stage, int per_block) {
  constexpr int CP = pad4(C), WS = kTaps * O * CP;
  extern __shared__ float4 smem[];
  const int Ho = H - kK + 1, Wo = W - kK + 1, Hp = Ho / 2, Wp = Wo / 2;
  const int PS = (Ho * Wo) | 1, PO = Hp * Wp * O;
  const int Wq = W / 2, P = (H / 2) * Wq;       // input quads a sample
  float* wt = reinterpret_cast<float*>(smem);   // [kh][kw][o][CP]
  float* dc = wt + WS;                          // [stage][O][PS]
  const int g = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;
  const float* wg = w + (size_t)g * kTaps * C * O;
  for (int i = tid; i < WS; i += nt) {
    const int cc = i % CP, o = (i / CP) % O, tap = i / (CP * O);
    cp_async4(wt + i, wg + (tap * C + min(cc, C - 1)) * O + o, cc < C);
  }
  const int first = blockIdx.x * per_block;
  const int last = min(B, first + per_block);
  for (int s0 = first; s0 < last; s0 += stage) {
    const int ns = min(stage, last - s0);
    __syncthreads();
    const size_t at = ((size_t)g * B + s0) * PO;
    stage_dz<O>(dc, dy + at, idx + at, ns, Hp, Wp, O * PS, Wo, 1,
                [PS](int o) { return o * PS; });
    cp_async_wait_all();  // the weights, the first time
    __syncthreads();
    for (int it = tid; it < ns * P; it += nt) {
      const int s = it / P, qr = (it % P) / Wq, qc = it % Wq;
      const int c0 = 2 * qc - (kK - 1);   // conv column of window slot 0
      bool cv[kK + 1];
#pragma unroll
      for (int j = 0; j <= kK; ++j) cv[j] = c0 + j >= 0 && c0 + j < Wo;
      const float* planes = dc + s * O * PS;
      float acc[4][C];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int cc = 0; cc < C; ++cc) acc[a][cc] = 0.f;
#pragma unroll
      for (int kh = 0; kh < kK; ++kh) {
        const int r0 = 2 * qr - kh;       // conv row under input row 2qr
        const bool v0 = r0 >= 0 && r0 < Ho, v1 = r0 + 1 >= 0 && r0 + 1 < Ho;
        const int b0 = r0 * Wo + c0;      // read only where valid
#pragma unroll 1
        for (int o = 0; o < O; ++o) {
          const int b = o * PS + b0;
          float d0[kK + 1], d1[kK + 1];
#pragma unroll
          for (int j = 0; j <= kK; ++j) {
            d0[j] = v0 && cv[j] ? planes[b + j] : 0.f;
            d1[j] = v1 && cv[j] ? planes[b + Wo + j] : 0.f;
          }
#pragma unroll
          for (int kw = 0; kw < kK; ++kw) {
            float wv[CP];
            load4<CP>(wv, wt + ((kh * kK + kw) * O + o) * CP);
#pragma unroll
            for (int cc = 0; cc < C; ++cc) {
              acc[0][cc] = fmaf(d0[kK - 1 - kw], wv[cc], acc[0][cc]);
              acc[1][cc] = fmaf(d0[kK - kw], wv[cc], acc[1][cc]);
              acc[2][cc] = fmaf(d1[kK - 1 - kw], wv[cc], acc[2][cc]);
              acc[3][cc] = fmaf(d1[kK - kw], wv[cc], acc[3][cc]);
            }
          }
        }
      }
      float* out = dx + (((size_t)g * B + s0 + s) * H + 2 * qr) * W * C
                   + 2 * qc * C;
#pragma unroll
      for (int cc = 0; cc < C; ++cc) {
        out[cc] = acc[0][cc];
        out[C + cc] = acc[1][cc];
        out[W * C + cc] = acc[2][cc];
        out[(W + 1) * C + cc] = acc[3][cc];
      }
    }
  }
}


// ----------------------------------------------------------- launching

enum Kind { kFwd, kDw, kDx };

// shared memory a block stages samples into (forward and dx also hold
// the weights in it): two blocks an SM, three for dW
constexpr long long kStageBytes[] = {100 * 1024, 72 * 1024, 100 * 1024};
constexpr int kBlockSamples = 32;     // samples a block covers, about

template <int C, int O>
size_t smem_of(Kind kind, int H, int W, int stage) {
  return kind == kFwd  ? fwd_smem<C, O>(H, W, stage)
         : kind == kDw ? dw_smem<C, O>(H, W, stage)
                       : dx_smem<C, O>(H, W, stage);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// threads (a multiple of 32, at most kMaxThreads) that take `items` in
// the fewest passes, each thread as many
int spread(int items) {
  return 32 * ceil_div(ceil_div(items, ceil_div(items, kMaxThreads)), 32);
}

struct Plan {
  int stage;       // samples a block stages in shared memory at once
  int per_block;   // samples a block covers (a multiple of stage)
  int chunks;      // blocks along a group's samples
  int threads;     // a block
  int lanes;       // dW: threads that split one tile's positions
};

// How a `kind` launch covers B samples of (H, W, C) a group: as many
// samples a stage as fit kStageBytes (at least one), about kBlockSamples
// a block. Forward threads each take a pooled position for Groups<O>::fwd
// channels, dx threads a 2x2 quad of input positions; dW threads own a
// (channel group, kh, c) tile, and where there are fewer than 128 tiles,
// `lanes` threads (a power of two) split each tile's positions. The plan
// depends on one group's shapes alone, so a group's dW sums in the same
// order whatever G is.
template <int C, int O>
Plan make_plan(Kind kind, int B, int H, int W) {
  const long long fixed = (long long)smem_of<C, O>(kind, H, W, 0);
  const long long per = (long long)smem_of<C, O>(kind, H, W, 1) - fixed;
  const long long fit = (kStageBytes[kind] - fixed) / per;
  const int stage = (int)(fit < 1 ? 1 : fit < B ? fit : B);
  const int mult = (2 * kBlockSamples + stage) / (2 * stage);  // rounded
  const int per_block = stage * (mult > 1 ? mult : 1);
  const int Ho = H - kK + 1, Wo = W - kK + 1;
  int threads, lanes = 1;
  if (kind == kFwd) {
    threads = spread(stage * (Ho / 2) * (Wo / 2) * (O / Groups<O>::fwd));
  } else if (kind == kDx) {
    threads = spread(stage * (H / 2) * (W / 2));
  } else {
    const int tiles = (O / Groups<O>::dw) * kK * C;
    while (lanes < 32 && 2 * lanes * tiles <= kMaxThreads) lanes *= 2;
    threads = 32 * ceil_div(tiles * lanes, 32);
  }
  return {stage, per_block, ceil_div(B, per_block), threads, lanes};
}

// Whether the entries take a (H, W, C) input into O channels: 5x5 VALID
// with even conv output sides, one sample's staging within a block's
// shared memory for all three kernels, and dW's tiles within a block.
template <int C, int O>
bool takes(int H, int W) {
  if (H <= kK || W <= kK || (H - kK + 1) % 2 || (W - kK + 1) % 2)
    return false;
  for (Kind kind : {kFwd, kDw, kDx})
    if (smem_of<C, O>(kind, H, W, 1) > kMaxSmem) return false;
  return (O / Groups<O>::dw) * kK * C <= kMaxThreads;
}

// cudaFuncSetAttribute once per kernel and device, so that a launch
// inside a CUDA-graph capture makes no such call
template <auto Kernel>
cudaError_t allow_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  done[dev] = err == cudaSuccess;
  return err;
}

template <int C, int O>
int launch_fwd(const float* x, const float* w, float* y, uint8_t* idx,
               int G, int B, int H, int W, cudaStream_t st) {
  constexpr auto kernel = conv_pool_fwd_kernel<C, O, Groups<O>::fwd>;
  const Plan p = make_plan<C, O>(kFwd, B, H, W);
  cudaError_t err = allow_smem<kernel>();
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(p.chunks, G), p.threads, fwd_smem<C, O>(H, W, p.stage),
           st>>>(x, w, y, idx, B, H, W, p.stage, p.per_block);
  return (int)cudaGetLastError();
}

template <int C, int O>
int launch_dw(const float* x, const float* dy, const uint8_t* idx,
              float* part, float* dw, int G, int B, int H, int W,
              cudaStream_t st) {
  constexpr auto kernel = conv_pool_dw_kernel<C, O, Groups<O>::dw>;
  const Plan p = make_plan<C, O>(kDw, B, H, W);
  cudaError_t err = allow_smem<kernel>();
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(p.chunks, G), p.threads, dw_smem<C, O>(H, W, p.stage),
           st>>>(x, dy, idx, part, B, H, W, p.stage, p.per_block, p.lanes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = kTaps * C * O;
  const size_t total = (size_t)G * n;
  conv_pool_dw_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      part, dw, G, p.chunks, n);
  return (int)cudaGetLastError();
}

template <int C, int O>
int launch_dx(const float* w, const float* dy, const uint8_t* idx,
              float* dx, int G, int B, int H, int W, cudaStream_t st) {
  constexpr auto kernel = conv_pool_dx_kernel<C, O>;
  const Plan p = make_plan<C, O>(kDx, B, H, W);
  cudaError_t err = allow_smem<kernel>();
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(p.chunks, G), p.threads, dx_smem<C, O>(H, W, p.stage),
           st>>>(w, dy, idx, dx, B, H, W, p.stage, p.per_block);
  return (int)cudaGetLastError();
}

bool grid_ok(int G, int B) { return G >= 1 && G <= 65535 && B >= 1; }

}  // namespace

// The (C, O) pairs built: the paper CNN's conv 1 on 1- and 3-channel
// images (15 outputs) and its conv 2 (15 -> 28).
#define CONV_POOL_PAIRS(X) X(1, 15) X(3, 15) X(15, 28)

extern "C" int conv_pool_takes(int H, int W, int C, int O) {
#define TAKES(c, o) if (C == c && O == o) return takes<c, o>(H, W);
  CONV_POOL_PAIRS(TAKES)
#undef TAKES
  return 0;
}

// The blocks along a group's B samples that dW's first kernel writes a
// partial sum for: `part` holds (G, chunks, 25*C*O) floats. 0 where the
// entries do not take the shapes.
extern "C" int conv_pool_dw_chunks(int B, int H, int W, int C, int O) {
#define CHUNKS(c, o)                                                     \
  if (C == c && O == o)                                                  \
    return B >= 1 && takes<c, o>(H, W)                                   \
               ? make_plan<c, o>(kDw, B, H, W).chunks : 0;
  CONV_POOL_PAIRS(CHUNKS)
#undef CHUNKS
  return 0;
}

// Each entry launches on `stream` and returns the launch's cudaError_t as
// an int (0 when accepted), cudaErrorInvalidValue for shapes that
// conv_pool_takes refuses or a grid beyond G in [1, 65535], B >= 1. The
// caller guarantees contiguous buffers of the shapes above that it
// allocated itself: y, idx, part (G, conv_pool_dw_chunks(...), 25*C*O),
// dw, dx.
extern "C" int conv_pool_fwd_f32(const float* x, const float* w, float* y,
                                 uint8_t* idx, int G, int B, int H, int W,
                                 int C, int O, void* stream) {
  if (!grid_ok(G, B)) return (int)cudaErrorInvalidValue;
#define FWD(c, o)                                                        \
  if (C == c && O == o && takes<c, o>(H, W))                             \
    return launch_fwd<c, o>(x, w, y, idx, G, B, H, W,                    \
                            (cudaStream_t)stream);
  CONV_POOL_PAIRS(FWD)
#undef FWD
  return (int)cudaErrorInvalidValue;
}

extern "C" int conv_pool_dw_f32(const float* x, const float* dy,
                                const uint8_t* idx, float* part, float* dw,
                                int G, int B, int H, int W, int C, int O,
                                void* stream) {
  if (!grid_ok(G, B)) return (int)cudaErrorInvalidValue;
#define DW(c, o)                                                          \
  if (C == c && O == o && takes<c, o>(H, W))                              \
    return launch_dw<c, o>(x, dy, idx, part, dw, G, B, H, W,              \
                           (cudaStream_t)stream);
  CONV_POOL_PAIRS(DW)
#undef DW
  return (int)cudaErrorInvalidValue;
}

extern "C" int conv_pool_dx_f32(const float* w, const float* dy,
                                const uint8_t* idx, float* dx, int G, int B,
                                int H, int W, int C, int O, void* stream) {
  if (!grid_ok(G, B)) return (int)cudaErrorInvalidValue;
#define DX(c, o)                                                         \
  if (C == c && O == o && takes<c, o>(H, W))                             \
    return launch_dx<c, o>(w, dy, idx, dx, G, B, H, W,                   \
                           (cudaStream_t)stream);
  CONV_POOL_PAIRS(DX)
#undef DX
  return (int)cudaErrorInvalidValue;
}
