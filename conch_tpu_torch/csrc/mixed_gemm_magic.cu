// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// int4 weight-only GEMM over the "magic" packing, stacked per layer (K1).
//
// Replaces conch_tpu/kernels/quantization/gemm.py:_mixed_gemm_magic_kernel
// (launcher mixed_precision_gemm_launcher, with layer_index).
// out[M, N] = x[M, K] @ W, W[k, n] = (code[k, n] - bias) * scale[k / G, n],
// x and out bf16, the sum in f32, for a group size G of 128 or 64 (a
// template parameter; any other group raises in the wrapper).
//
// Layout (conch_tpu_torch/utils/quant_utils.py:pack_rows_magic): in group
// g, word row r (0..G/8-1) and column n, bits 4j + 16h hold logical row
// g*G + j*G/4 + 2r + h. So field j of one word, masked to the low nibble of
// each 16-bit half and OR'd with 0x4300, is a bf16x2 pair (128 + c, 128 + c')
// for two neighbouring rows; subtracting 128 + bias in bf16 gives the exact
// values c - bias (-8..7). These go straight into mma.sync m16n8k16 as the B
// operand, so every product is exact and each group's partial sum over its
// G rows is taken in f32, then scaled by s[g, n] and added to the running
// f32 sum. (The TPU kernel instead computes x@(128+c) - 136*sum(x), which
// loses digits to cancellation; that form is not copied here.)
//
// The k order inside one mma is free as long as A and B agree. Thread
// (group g, lane-in-group t) takes the W = G/32 word rows W*t..W*t+W-1 of
// a group (4 at G 128, 2 at G 64); with that choice the rows of field j
// that it holds are j*G/4 + 2Wt + {0..2W-1}, which make W/2 k-steps
// (j, s) whose rows are j*G/4 + 2Wt + 4s + {0,1,2,3}, so its A values for
// field j are 2W contiguous bf16 of an x row: one 16-byte load at G 128,
// one 8-byte load at G 64. The column order inside
// the warp's four n8 tiles is free too: column c of tile q is warp column
// 4c + q, so a thread's B words for the four tiles are 4 neighbouring
// columns (one 16-byte load per word row) and its outputs 8 neighbouring
// columns of a row (one 16-byte store, and 8 scales in one load).
//
// Bound on the H100: bytes at decode (M <= 32: K*N/2 bytes of codes plus
// the scales, e.g. 8.4 MB for 4096 x 4096), operations at a 512-row
// prefill chunk. Design for both: tensor cores (mma.sync, bf16 -> f32), the
// layer is a pointer offset taken by the wrapper so the stack is never
// sliced, each warp owns 32 columns, and
//  - M <= 32 (decode): blocks of 16 rows x 32 columns whose 8 warps split
//    K (groups interleaved) and add their sums in shared memory, so 4096
//    columns still give 128 blocks; each warp keeps its words two groups
//    ahead in registers;
//  - M > 32 (prefill): blocks of 32 rows x 64 columns, 2 warps side by side
//    on N, each pair splitting K in two; the row tiles of one column tile
//    are launched together, so the weight tile comes from HBM once and
//    from L2 for the other row tiles.
// No shared-memory staging of the operands, TMA or wgmma yet; the x loads
// of a group are issued just before its products. The kernel runs several
// times above its bound (PERF.md); which of these limits it is not
// measured yet.

#include "common.cuh"

namespace conch {
namespace {

constexpr int kNT = 4;  // n8 tiles per warp: 32 columns

// A group of G rows of K: G/8 int32 word rows, W = G/32 of them a thread,
// W/2 m16n8k16 k-steps a field.
template <int G>
struct Group {
  static_assert(G == 64 || G == 128, "the magic GEMM is written for groups of 64 and 128");
  static constexpr int kWordRows = G / 8;
  static constexpr int kWords = G / 32;
  static constexpr int kSteps = kWords / 2;
};

// The 2W contiguous bf16 of an x row that one thread's k-steps of a field
// take, as 32-bit pairs: one 16-byte load (W 4) or one 8-byte load (W 2).
template <int W>
__device__ __forceinline__ void load_x(uint32_t (&v)[W], const __nv_bfloat16* p) {
  if constexpr (W == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    v[0] = q.x, v[1] = q.y;
  }
}

__device__ __forceinline__ uint32_t bits_of(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }

// Field j of a packed word as the bf16x2 pair (c_lo - bias, c_hi - bias).
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t word, int j, __nv_bfloat162 offset) {
  uint32_t magic = ((word >> (4 * j)) & 0x000F000Fu) | 0x43004300u;  // bf16 pair 128 + code
  return bits_of(__hsub2(*reinterpret_cast<__nv_bfloat162*>(&magic), offset));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Word rows W*tig .. W*tig+W-1 of group grp at columns col .. col+3.
template <int G>
__device__ __forceinline__ void load_words(uint4 (&w)[Group<G>::kWords], const int32_t* __restrict__ packed,
                                           int grp, int n, int col, int tig) {
  constexpr int W = Group<G>::kWords;
  const int32_t* p = packed + static_cast<int64_t>(grp * Group<G>::kWordRows + W * tig) * n + col;
#pragma unroll
  for (int q = 0; q < W; ++q) w[q] = __ldg(reinterpret_cast<const uint4*>(p + static_cast<int64_t>(q) * n));
}

__device__ __forceinline__ uint32_t lane_of(const uint4& v, int t) {
  return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
}

// One group of G rows of K for this warp's MT x 16 rows and 32 columns:
// partial sums over the group in f32, scaled by the group's scales into acc.
template <int G, int MT>
__device__ __forceinline__ void group_product(float (&acc)[MT][kNT][4], const uint4 (&words)[Group<G>::kWords],
                                              const __nv_bfloat16* __restrict__ x, int64_t x_row_stride, int m,
                                              int m0, const __nv_bfloat16* __restrict__ scale_row, int grp,
                                              int g, int tig, __nv_bfloat162 offset) {
  // Scales of this thread's output columns 8*tig .. 8*tig+7.
  const uint4 sv = __ldg(reinterpret_cast<const uint4*>(scale_row));
  float part[MT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[mi][t][e] = 0.0f;

  constexpr int W = Group<G>::kWords;
  constexpr int S = Group<G>::kSteps;
  const int kcol = grp * G + 2 * W * tig;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t b[S][kNT][2];  // [k-step][n8 tile][register]
#pragma unroll
    for (int st = 0; st < S; ++st)
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        b[st][t][0] = codes_bf16x2(lane_of(words[2 * st], t), j, offset);
        b[st][t][1] = codes_bf16x2(lane_of(words[2 * st + 1], t), j, offset);
      }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int row = m0 + 16 * mi + g;
      uint32_t lo[W] = {}, hi[W] = {};
      if (row < m) load_x<W>(lo, x + row * x_row_stride + kcol + (G / 4) * j);
      if (row + 8 < m) load_x<W>(hi, x + (row + 8) * x_row_stride + kcol + (G / 4) * j);
#pragma unroll
      for (int t = 0; t < kNT; ++t)
#pragma unroll
        for (int st = 0; st < S; ++st)
          mma_bf16(part[mi][t], lo[2 * st], hi[2 * st], lo[2 * st + 1], hi[2 * st + 1], b[st][t][0], b[st][t][1]);
    }
  }
  // Accumulator of tile t: e0, e1 at (row g, tile columns 2*tig, 2*tig+1),
  // e2, e3 at row g + 8; tile column c is warp column 4c + t.
  const __nv_bfloat162* s2 = reinterpret_cast<const __nv_bfloat162*>(&sv);
#pragma unroll
  for (int t = 0; t < kNT; ++t) {
    const float s_lo = t & 1 ? __high2float(s2[t >> 1]) : __low2float(s2[t >> 1]);        // column 8*tig + t
    const float s_hi = t & 1 ? __high2float(s2[2 + (t >> 1)]) : __low2float(s2[2 + (t >> 1)]);  // 8*tig + 4 + t
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      acc[mi][t][0] += part[mi][t][0] * s_lo;
      acc[mi][t][1] += part[mi][t][1] * s_hi;
      acc[mi][t][2] += part[mi][t][2] * s_lo;
      acc[mi][t][3] += part[mi][t][3] * s_hi;
    }
  }
}

// MT m16 tiles of rows per warp; WARPS_N warps side by side on N; WARPS_K
// warps splitting the groups of K (their sums added in shared memory);
// each warp's words DEPTH groups ahead of its products.
template <int G, int MT, int WARPS_N, int WARPS_K, int DEPTH, typename O>
__global__ void __launch_bounds__(32 * WARPS_N * WARPS_K)
    magic_gemm_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ packed,
                      const __nv_bfloat16* __restrict__ scales, O* __restrict__ out, int m, int n,
                      int k, int64_t x_row_stride, int bias) {
  constexpr int BM = 16 * MT;
  constexpr int BN = 32 * WARPS_N;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int warp_n = warp % WARPS_N;
  const int warp_k = warp / WARPS_N;
  const int m0 = blockIdx.x * BM;
  const int n_warp = blockIdx.y * BN + warp_n * 32;
  const int num_groups = k / G;
  const __nv_bfloat162 offset = __bfloat162bfloat162(__float2bfloat16_rn(128.0f + static_cast<float>(bias)));

  float acc[MT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][t][e] = 0.0f;

  uint4 ring[DEPTH + 1][Group<G>::kWords];
#pragma unroll
  for (int i = 0; i < DEPTH; ++i) {
    const int grp = warp_k + i * WARPS_K;
    if (grp < num_groups) load_words<G>(ring[i], packed, grp, n, n_warp + 4 * g, tig);
  }
  for (int base = warp_k; base < num_groups; base += (DEPTH + 1) * WARPS_K) {
#pragma unroll
    for (int st = 0; st <= DEPTH; ++st) {
      const int grp = base + st * WARPS_K;
      if (grp >= num_groups) break;
      const int ahead = grp + DEPTH * WARPS_K;
      if (ahead < num_groups) load_words<G>(ring[(st + DEPTH) % (DEPTH + 1)], packed, ahead, n, n_warp + 4 * g, tig);
      group_product<G, MT>(acc, ring[st], x, x_row_stride, m, m0, scales + static_cast<int64_t>(grp) * n + n_warp + 8 * tig,
                        grp, g, tig, offset);
    }
  }

  if constexpr (WARPS_K == 1) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + 16 * mi + g + 8 * hh;
        if (row >= m) continue;
        // Columns 8*tig + c, c in 0..7: tile c & 3, element 2*hh + (c >> 2).
        O* dst = out + static_cast<int64_t>(row) * n + n_warp + 8 * tig;
        if constexpr (std::is_same_v<O, float>) {
          float v[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) v[c] = acc[mi][c & 3][2 * hh + (c >> 2)];
          reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
          reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
          __nv_bfloat162 v[4];
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int c0 = 2 * p, c1 = 2 * p + 1;  // the pair's columns
            v[p] = __floats2bfloat162_rn(acc[mi][c0 & 3][2 * hh + (c0 >> 2)], acc[mi][c1 & 3][2 * hh + (c1 >> 2)]);
          }
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
        }
      }
  } else {
    __shared__ float red[WARPS_K][BM][BN];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int t = 0; t < kNT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[warp_k][16 * mi + g + 8 * (e >> 1)][warp_n * 32 + 8 * tig + 4 * (e & 1) + t] = acc[mi][t][e];
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * BN; idx += blockDim.x) {
      const int r = idx / BN;
      const int c = idx - r * BN;
      if (m0 + r >= m) continue;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS_K; ++w) sum += red[w][r][c];
      out[static_cast<int64_t>(m0 + r) * n + blockIdx.y * BN + c] = from_float<O>(sum);
    }
  }
}

template <int G, int MT, int WARPS_N, int WARPS_K, int DEPTH, typename O>
void launch(const void* x, const void* packed, const void* scales, void* out, int m, int n, int k,
            int64_t x_row_stride, int bias, cudaStream_t stream) {
  const dim3 grid((m + 16 * MT - 1) / (16 * MT), n / (32 * WARPS_N));
  magic_gemm_kernel<G, MT, WARPS_N, WARPS_K, DEPTH, O><<<grid, 32 * WARPS_N * WARPS_K, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int32_t*>(packed),
      static_cast<const __nv_bfloat16*>(scales), static_cast<O*>(out), m, n, k, x_row_stride, bias);
}

template <int G, typename O>
void launch_group(const void* x, const void* packed, const void* scales, void* out, int m, int n, int k,
                  int64_t x_row_stride, int bias, cudaStream_t stream) {
  // Tile shapes picked by timing the engine's four (K, N) at M = 8, 32 and
  // 512 on the H100 at group 128 (see the header comment for the two
  // regimes); group 64 takes the same.
  if (m <= 32) {
    launch<G, 1, 1, 8, 2, O>(x, packed, scales, out, m, n, k, x_row_stride, bias, stream);
  } else {
    launch<G, 2, 2, 2, 1, O>(x, packed, scales, out, m, n, k, x_row_stride, bias, stream);
  }
}

}  // namespace
}  // namespace conch

// x (M, K) bf16 with row stride x_row_stride (a multiple of 8, 16-byte
// aligned); packed (K/8, N) int32 and scales (K/group, N) bf16 of ONE
// layer (the wrapper offsets the stack's pointers); out (M, N) bf16
// (out_dtype 1) or f32 (0), contiguous: the f32 sums' one rounding is the
// final store. group 64 or 128; K a multiple of the group, N of 128.
extern "C" int conch_mixed_gemm_magic(const void* x, const void* packed, const void* scales, void* out,
                                      int out_dtype, int m, int n, int k, int group, int64_t x_row_stride, int bias,
                                      void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (m == 0) return static_cast<int>(cudaSuccess);
  if ((group != 64 && group != 128) || k % group != 0 || n % 128 != 0 || x_row_stride % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool known = conch::dispatch_out(out_dtype, [&](auto out_tag) {
    using O = typename decltype(out_tag)::type;
    if (group == 128) {
      conch::launch_group<128, O>(x, packed, scales, out, m, n, k, x_row_stride, bias, s);
    } else {
      conch::launch_group<64, O>(x, packed, scales, out, m, n, k, x_row_stride, bias, s);
    }
  });
  return static_cast<int>(known ? cudaGetLastError() : cudaErrorInvalidValue);
}
