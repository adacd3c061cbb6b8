// Hierarchical aggregation, eqs. (2)-(3), for Hopper (sm_90a): three
// Pallas TPU kernels of src/repro/kernels/hier_agg/hier_agg.py on one
// templated loop, over every leaf of a hop in one launch.
//
//   K1 masked_aggregate_batched_pallas (body _masked_kernel_batched):
//     out[s, m, p] = sum_h w[s, m, h] * x[s, h, p]
//     w[s, m, h]   = mask[s, m, h] * sizes[s, h]
//                    / max(sum_h' mask[s, m, h'] * sizes[s, h'], 1)
//   K3 weighted_aggregate_batched_pallas (body _kernel_batched):
//     the same sum with a caller-supplied panel w[s, m, h], no row total.
//   K4 masked_decode_aggregate_batched_pallas (body
//     _masked_dec_kernel_batched): K1's panel times the decode scale,
//     w[s, m, h] * scales[s, h], over the wire-format updates x = q
//     (int8, bf16 or f32), so the decoded (H, P) matrix is never
//     written: each element is widened to f32 as it is loaded.
//
// Eq. (2) per edge with mask = the assignment one-hot and sizes = D_n;
// eq. (3) with mask = ones(1, M) and sizes = D_{N_m}. All-zero mask rows
// give zero rows (K1, K4).
//
// What bounds it on this card: a skinny product (M is 1-10 edges, H the
// cohort, P one parameter leaf) doing 2*M flops per operand element, far
// below the card's flop-per-byte balance, so the least time is reading
// the (H, P) operand once: H*P*sizeof(T) bytes over the memory rate. At
// the paper's shapes (H = 50, leaves of 375 to 101 248 columns) that is
// 0.03 to 7 us a leaf, so what a launch costs is mostly latency: the
// launch itself, the dependent steps before the first operand byte
// arrives, and the memory round trips each warp waits through.
//
// Design:
// - One launch per hop. The entry takes up to kMaxLeaves leaves (S, H,
//   P_i), each with its own output and, for K4, its own scales, and packs
//   their pointers, widths and the prefix sums of their column tiles into
//   a LeafTable passed by value as a __grid_constant__ parameter (nothing
//   is copied to the device). Grid x walks the column tiles of all leaves
//   (times the H splits below), grid y the S lanes; a block finds its
//   leaf by a binary search of the prefix sums.
// - Vector loads of 4 columns a lane: a warp reads a 128-column strip of
//   a row, each lane one vector (16 bytes of f32, 8 of bf16, 4 of int8;
//   512, 256 and 128 contiguous bytes a warp), widened to f32 in
//   registers (int8 through the 2^23 + b float trick, not I2F). So every
//   wire type keeps the same (MT x 4) accumulators and FMAs a lane: a
//   16-byte int8 vector (16 columns a lane) measured slower on the card,
//   with 4x the FMAs and partial sums a lane and a quarter of the blocks.
//   A leaf whose base, output or row stride is not a multiple of the
//   vector takes a scalar path, chosen per leaf: lane l loads columns
//   l + 32 e, still coalesced.
// - H split across the warps of a block, WH row groups (a template
//   argument the caller picks from H and the launch's width): 8, each
//   warp walking every 8th row of one strip; 4 over 2 strips a block
//   when the strips alone fill the card (half the partials to sum for
//   wide leaves); 1 when H <= 8, each warp walking all of H over its own
//   strip with nothing to sum. A lane keeps kU independent row loads in
//   flight, and issues the first batch before the panel is staged. The
//   row groups' partials meet in shared memory and every thread sums
//   four columns of them in row-group order. Where the tiles of all
//   leaves times the lanes cannot fill the card (large H, narrow
//   leaves), the caller also splits H across the `splits` blocks of a
//   thread-block cluster (at most 8); after a cluster barrier every
//   block sums its share of the tile over distributed shared memory in
//   rank order. No atomics: two launches on the same inputs give the
//   same bits.
// - The panel in one pass: warp i < MT stages row i of the block's
//   mask * sizes (* scales for K4) for a round of up to kHTile rows into
//   shared memory, transposed so that one row h is MT consecutive words,
//   and keeps the running row total sum_h mask * sizes in a register.
//   The totals are reduced beside the partials (a warp shuffle, then the
//   cluster in rank order), and each output is multiplied by
//   1 / max(total, 1) as it is stored. So no phase before the operand
//   loads depends on global memory, and nothing is zero-filled beyond the
//   MT x ht words of the round.
// - The M tile MT is 1, 5 or 8 rows, chosen from M: every hop of the
//   paper's worlds (M <= 8; M = 5 edges in Table I) reads the operand
//   once with few idle accumulators; a larger M re-reads it once per
//   8-row tile.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 128;      // columns of a warp: 32 lanes of 4
constexpr int kHTile = 256;      // panel rows staged per round
constexpr int kU = 4;            // vector rows in flight a lane
constexpr int kUS = 2;           // scalar path: rows in flight a lane
constexpr int kMaxLeaves = 64;   // leaves one launch takes
constexpr int kMaxSplits = 8;    // blocks of a cluster (the portable size)

// How the panel is built.
enum class Panel {
  kMasked,        // K1: mask * sizes, divided by the row total
  kWeighted,      // K3: the caller's weights as given
  kMaskedScaled,  // K4: mask * sizes * scales, divided by the row total
};

struct LeafTable {
  int n;                           // leaves in this launch
  int tile_start[kMaxLeaves + 1];  // prefix sums of column tiles
  int P[kMaxLeaves];               // columns of each leaf
  int vec[kMaxLeaves];             // 1: the vector path
  const void* x[kMaxLeaves];       // (S, H, P) operand
  const float* scales[kMaxLeaves]; // (S, H) decode scales (K4) or null
  float* out[kMaxLeaves];          // (S, M, P) output
};

// The operand's wire types: a vector of 4 columns and one column
// (Scalar), each widened to f32.
template <typename T>
struct Wire;

template <>
struct Wire<float> {
  using Vec = uint4;
  using Scalar = float;
  __device__ static void widen(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ static float widen1(float x) { return x; }
};

template <>
struct Wire<__nv_bfloat16> {
  using Vec = uint2;
  using Scalar = unsigned short;              // the bf16 bits
  __device__ static void widen(const uint2& r, float* v) {
    v[0] = __uint_as_float(r.x << 16);       // bf16 is f32's high half
    v[1] = __uint_as_float(r.x & 0xffff0000u);
    v[2] = __uint_as_float(r.y << 16);
    v[3] = __uint_as_float(r.y & 0xffff0000u);
  }
  __device__ static float widen1(unsigned short x) {
    return __uint_as_float((unsigned int)x << 16);
  }
};

template <>
struct Wire<int8_t> {
  using Vec = unsigned int;
  using Scalar = signed char;
  // byte b lands in the mantissa of 2^23 + (b + 128), exact in f32
  __device__ static void widen(unsigned int r, float* v) {
    const unsigned int u = r ^ 0x80808080u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7540 + k))
             - 8388736.f;
  }
  __device__ static float widen1(signed char x) { return (float)x; }
};

// The register budget allows 3 blocks an SM (80 registers a thread)
// where the H split over 4 or 8 warps carries the wide leaves, and 2
// (128) where 80 would spill (8-row tiles, bf16) or a warp walks all of
// H (H <= 8).
template <Panel kPanel, typename T, int MT, int WH>
__global__ void __launch_bounds__(
    kThreads, (WH == 1 || MT > 5 || sizeof(T) == 2) ? 2 : 3)
aggregate_kernel(const __grid_constant__ LeafTable tab,
                 const float* __restrict__ panel_in,  // (S, M, H)
                 const float* __restrict__ sizes,     // (S, H) or null (K3)
                 int M, int H, int splits) {
  using W = Wire<T>;
  using Vec = typename W::Vec;
  constexpr bool kMasked = kPanel != Panel::kWeighted;
  constexpr bool kScaled = kPanel == Panel::kMaskedScaled;

  // The panel round [kHTile][MT]; after the rows, the block's summed tile
  // [MT][spb * kStrip] for the cluster (spb <= 2 there). The warps'
  // partials [WH][spb][MT][kStrip].
  __shared__ __align__(16) float pan[kHTile * MT];
  __shared__ __align__(16) float red[kWarps * MT * kStrip];
  __shared__ float tot[MT];
  float* part = pan;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int spb = kWarps / WH;               // strips a block
  const int rg = warp % WH, st = warp / WH;      // row group, strip
  const int tile = blockIdx.x / splits;
  const int rank = blockIdx.x - tile * splits;
  int leaf = 0, hi = tab.n - 1;                  // last tile_start <= tile
  while (leaf < hi) {
    const int mid = (leaf + hi + 1) >> 1;
    if (tab.tile_start[mid] <= tile) leaf = mid; else hi = mid - 1;
  }
  const int P = tab.P[leaf];
  const int cb = (tile - tab.tile_start[leaf]) * spb * kStrip;  // block's
  const int c0 = cb + st * kStrip;                              // warp's
  const bool vec = tab.vec[leaf] != 0;
  const int64_t s = blockIdx.y;
  const T* x = static_cast<const T*>(tab.x[leaf]) + s * H * P;
  const float* sc = kScaled ? tab.scales[leaf] + s * H : nullptr;
  float* out = tab.out[leaf] + s * M * P;
  const float* pin = panel_in + s * M * H;
  const float* sz = kMasked ? sizes + s * H : nullptr;
  const int chunk = (H + splits - 1) / splits;
  const int h_begin = min(H, rank * chunk), h_end = min(H, h_begin + chunk);
  const int col_v = c0 + lane * 4;               // the vector path's
  const bool live_v = col_v < P;                 // (P % 4 == 0 there)
  const int64_t rstride = (int64_t)WH * P;       // between a warp's rows

  for (int m0 = 0; m0 < M; m0 += MT) {
    const int mt = min(MT, M - m0);
    float acc[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    float rowtot = 0.f;     // warp i < MT: row i's mask * sizes so far

    // Warp i < MT stages row i of this round's panel (zeros past mt),
    // then the block waits for the whole panel.
    auto stage = [&](int h0, int ht) {
      if (warp < MT) {
        const float* prow = pin + (int64_t)(m0 + warp) * H + h0;
#pragma unroll 4
        for (int j = lane; j < ht; j += 32) {
          float w = 0.f;
          if (warp < mt) {
            w = prow[j];
            if constexpr (kMasked) {
              w *= sz[h0 + j];
              rowtot += w;
            }
            if constexpr (kScaled) w *= sc[h0 + j];
          }
          pan[j * MT + warp] = w;
        }
      }
      __syncthreads();
    };
    // acc[i][:] += panel[j][i] * v[:], the panel row a broadcast
    auto fma_row = [&](int j, const float* v) {
      float p[MT];
      if constexpr (MT % 4 == 0) {
#pragma unroll
        for (int q = 0; q < MT / 4; ++q) {
          const float4 t = reinterpret_cast<const float4*>(pan + j * MT)[q];
          p[4 * q] = t.x;
          p[4 * q + 1] = t.y;
          p[4 * q + 2] = t.z;
          p[4 * q + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < MT; ++i) p[i] = pan[j * MT + i];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(p[i], v[e], acc[i][e]);
    };

    for (int h0 = h_begin; h0 < h_end; h0 += kHTile) {
      const int ht = min(kHTile, h_end - h0);
      // this warp's rows of the round: h0 + rg + WH * k, k < nk
      const int nk = ht > rg ? (ht - rg + WH - 1) / WH : 0;
      const T* xr = x + (int64_t)(h0 + rg) * P;
      if (vec) {
        Vec raw[kU];
        auto load = [&](int k0) {
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            raw[u] = Vec{};
            if (live_v && k0 + u < nk)
              raw[u] = __ldg(reinterpret_cast<const Vec*>(
                  xr + (k0 + u) * rstride + col_v));
          }
        };
        load(0);                 // in flight while the panel is staged
        stage(h0, ht);
        for (int k0 = 0; k0 < nk; k0 += kU) {
          if (k0 > 0) load(k0);
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            if (k0 + u < nk) {
              float v[4];
              W::widen(raw[u], v);
              fma_row(rg + WH * (k0 + u), v);
            }
          }
        }
      } else {
        float vs[kUS][4];
        auto load = [&](int k0) {
#pragma unroll
          for (int u = 0; u < kUS; ++u) {
            // one address a row, the 4 columns at immediate offsets
            const T* xrow = xr + (k0 + u) * rstride + c0 + lane;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              vs[u][e] = (k0 + u < nk && c0 + lane + 32 * e < P)
                             ? W::widen1(__ldg(reinterpret_cast<
                                   const typename W::Scalar*>(xrow + 32 * e)))
                             : 0.f;
          }
        };
        load(0);
        stage(h0, ht);
        for (int k0 = 0; k0 < nk; k0 += kUS) {
          if (k0 > 0) load(k0);
#pragma unroll
          for (int u = 0; u < kUS; ++u)
            if (k0 + u < nk) fma_row(rg + WH * (k0 + u), vs[u]);
        }
      }
      if (h0 + kHTile < h_end) __syncthreads();   // before the next round
    }

    if constexpr (kMasked) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rowtot += __shfl_xor_sync(0xffffffffu, rowtot, off);
      if (lane == 0 && warp < MT) tot[warp] = rowtot;
    }
    // out = sum * (1 / max(total, 1)) (K1, K4) or the sum (K3), four
    // columns at block offset c at a time
    auto store = [&](int i, int c, float4 a, float den) {
      if constexpr (kMasked) {
        const float r = 1.f / fmaxf(den, 1.f);
        a.x *= r;
        a.y *= r;
        a.z *= r;
        a.w *= r;
      }
      const int col = cb + c;
      float* o = out + (int64_t)(m0 + i) * P + col;
      if (vec) {
        if (col < P) *reinterpret_cast<float4*>(o) = a;
      } else {
        if (col < P) o[0] = a.x;
        if (col + 1 < P) o[1] = a.y;
        if (col + 2 < P) o[2] = a.z;
        if (col + 3 < P) o[3] = a.w;
      }
    };
    if constexpr (WH == 1) {
      // one warp a strip: nothing to sum, each lane stores its columns
      if constexpr (kMasked) __syncthreads();    // the row totals
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= mt) continue;
        const float den = kMasked ? tot[i] : 1.f;
        if (vec) {
          store(i, col_v - cb, make_float4(acc[i][0], acc[i][1], acc[i][2],
                                           acc[i][3]), den);
        } else {
          const float r = kMasked ? 1.f / fmaxf(den, 1.f) : 1.f;
          float* o = out + (int64_t)(m0 + i) * P;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c0 + lane + 32 * e < P)
              o[c0 + lane + 32 * e] = kMasked ? acc[i][e] * r : acc[i][e];
        }
      }
    } else {
      // The warps' partials of the live rows to shared memory at the
      // columns they cover, red[rg][st][i][kStrip], then every thread
      // sums four columns over the row groups, in order
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i < mt) {
          float* dst = red + ((rg * spb + st) * MT + i) * kStrip;
          if (vec) {
            *reinterpret_cast<float4*>(dst + lane * 4) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) dst[lane + 32 * e] = acc[i][e];
          }
        }
      }
      __syncthreads();
      const int per_row = spb * kStrip / 4;      // column groups a row
      const int groups = mt * per_row;
      const float4* red4 = reinterpret_cast<const float4*>(red);
      for (int g = threadIdx.x; g < groups; g += kThreads) {
        const int i = g / per_row, c = 4 * (g % per_row);
        const int sg = c / kStrip, cs = (c % kStrip) / 4;
        float4 a = red4[((0 * spb + sg) * MT + i) * (kStrip / 4) + cs];
#pragma unroll
        for (int r = 1; r < WH; ++r) {
          const float4 b = red4[((r * spb + sg) * MT + i) * (kStrip / 4)
                                + cs];
          a.x += b.x;
          a.y += b.y;
          a.z += b.z;
          a.w += b.w;
        }
        if (splits == 1)
          store(i, c, a, kMasked ? tot[i] : 1.f);
        else
          reinterpret_cast<float4*>(part)[g] = a;
      }
      if (splits > 1) {
        // every block sums its share of the tile over the cluster, in
        // rank order
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();
        for (int g = rank + splits * threadIdx.x; g < groups;
             g += splits * kThreads) {
          const int i = g / per_row, c = 4 * (g % per_row);
          float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
          float den = 0.f;
          for (int r = 0; r < splits; ++r) {
            const float4 b = reinterpret_cast<const float4*>(
                cluster.map_shared_rank(part, r))[g];
            a.x += b.x;
            a.y += b.y;
            a.z += b.z;
            a.w += b.w;
            if constexpr (kMasked) den += cluster.map_shared_rank(tot, r)[i];
          }
          store(i, c, a, den);
        }
        cluster.sync();      // the tiles live until every block read them
      }
    }
    if (m0 + MT < M) __syncthreads();   // red, tot and pan are rewritten
  }
}

template <Panel kPanel, typename T, int MT, int WH>
int launch_mt(const LeafTable& tab, int tiles, const float* panel,
              const float* sizes, int S, int M, int H, int splits,
              cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * splits, S);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, aggregate_kernel<kPanel, T, MT, WH>, tab, panel, sizes, M, H,
      splits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <Panel kPanel, typename T>
int launch(const float* panel, const float* sizes, int n,
           const float* const* scales, const void* const* x,
           float* const* out, const int* P, int S, int M, int H, int splits,
           int wh, void* stream) {
  constexpr int kVecBytes = 4 * sizeof(T);
  if (n < 1 || n > kMaxLeaves || splits < 1 || splits > kMaxSplits
      || (wh != 1 && wh != 4 && wh != kWarps) || (splits > 1 && wh == 1)
      || S < 1 || S > 65535 || M < 1 || H < 0)
    return (int)cudaErrorInvalidValue;
  const int cols = kWarps / wh * kStrip;
  LeafTable tab = {};
  tab.n = n;
  int64_t tiles = 0;
  for (int l = 0; l < n; ++l) {
    if (P[l] < 1) return (int)cudaErrorInvalidValue;
    tab.tile_start[l] = (int)tiles;
    tab.P[l] = P[l];
    tab.x[l] = x[l];
    tab.scales[l] = scales ? scales[l] : nullptr;
    tab.out[l] = out[l];
    tab.vec[l] = (uintptr_t)x[l] % kVecBytes == 0
                 && (uintptr_t)out[l] % 16 == 0 && P[l] % 4 == 0;
    tiles += (P[l] + cols - 1) / cols;
    if (tiles * splits > INT_MAX) return (int)cudaErrorInvalidValue;
  }
  tab.tile_start[n] = (int)tiles;
  const cudaStream_t st = (cudaStream_t)stream;
  const int t = (int)tiles;
  auto go = [&](auto mt) {
    constexpr int MT = decltype(mt)::value;
    if (wh == 1)
      return launch_mt<kPanel, T, MT, 1>(tab, t, panel, sizes, S, M, H,
                                         splits, st);
    if (wh == 4)
      return launch_mt<kPanel, T, MT, 4>(tab, t, panel, sizes, S, M, H,
                                         splits, st);
    return launch_mt<kPanel, T, MT, kWarps>(tab, t, panel, sizes, S, M, H,
                                            splits, st);
  };
  if (M <= 1) return go(std::integral_constant<int, 1>{});
  if (M <= 5) return go(std::integral_constant<int, 5>{});
  return go(std::integral_constant<int, 8>{});
}

}  // namespace

// Each entry launches once on `stream` over n leaves and returns the
// launch's cudaError_t as an int (0 when it was accepted). The caller
// passes host arrays of n device pointers (operand, output and, for K4,
// scales) and the leaves' widths P[l] >= 1, and guarantees 1 <= n <=
// hier_agg_leaf_capacity(), S in [1, 65535], M >= 1, H >= 0, wh = 1 or 8
// warps of a block along H, splits in [1, 8] blocks of a cluster along H
// (wh = 8 when splits > 1), contiguous buffers of the
// shapes above (f32 except the operand, whose type the entry's name
// gives) on one device, and outputs it allocated itself.

extern "C" int hier_agg_leaf_capacity() { return kMaxLeaves; }

extern "C" int masked_aggregate_f32(const float* mask, const float* sizes,
                                    int n, const void* const* x,
                                    float* const* out, const int* P, int S,
                                    int M, int H, int splits, int wh,
                                    void* stream) {
  return launch<Panel::kMasked, float>(mask, sizes, n, nullptr, x, out, P, S,
                                       M, H, splits, wh, stream);
}

extern "C" int weighted_aggregate_f32(const float* weights, int n,
                                      const void* const* x, float* const* out,
                                      const int* P, int S, int M, int H,
                                      int splits, int wh, void* stream) {
  return launch<Panel::kWeighted, float>(weights, nullptr, n, nullptr, x, out,
                                         P, S, M, H, splits, wh, stream);
}

extern "C" int masked_decode_aggregate_f32(
    const float* mask, const float* sizes, int n, const float* const* scales,
    const void* const* q, float* const* out, const int* P, int S, int M,
    int H, int splits, int wh, void* stream) {
  return launch<Panel::kMaskedScaled, float>(mask, sizes, n, scales, q, out,
                                             P, S, M, H, splits, wh, stream);
}

extern "C" int masked_decode_aggregate_bf16(
    const float* mask, const float* sizes, int n, const float* const* scales,
    const void* const* q, float* const* out, const int* P, int S, int M,
    int H, int splits, int wh, void* stream) {
  return launch<Panel::kMaskedScaled, __nv_bfloat16>(
      mask, sizes, n, scales, q, out, P, S, M, H, splits, wh, stream);
}

extern "C" int masked_decode_aggregate_i8(
    const float* mask, const float* sizes, int n, const float* const* scales,
    const void* const* q, float* const* out, const int* P, int S, int M,
    int H, int splits, int wh, void* stream) {
  return launch<Panel::kMaskedScaled, int8_t>(mask, sizes, n, scales, q, out,
                                              P, S, M, H, splits, wh, stream);
}
