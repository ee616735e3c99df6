// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Weight-only GEMM over the planar packing, stacked per layer (K1b).
//
// Replaces conch_tpu/kernels/quantization/gemm.py:_mixed_gemm_planar_kernel
// (launcher mixed_precision_gemm_launcher, layout "planar", with
// layer_index). out[M, N] = x[M, K] @ W with 2-, 4- or 8-bit codes c and
// W[k, n] = (c[k, n] - z) * s[k / group, n], where z is a per-group
// zero-point, one scalar zero-point, or the type's bias. As in the TPU
// kernel the dequantization comes after the product: for each group
// G, acc += (x_G @ c_G - z * sum(x_G)) * s_G in f32. The raw codes are
// exact in bf16 and go straight into mma.sync as B.
//
// Layout (conch_tpu_torch/utils/quant_utils.py:pack_rows_planar): in a
// group of `group` rows, word row r holds logical row i * (group / epp) + r
// in bit field i (epp = 32 / bits fields). Thread (g, t) of a warp loads
// word rows 4t .. 4t+3 of a 16-word-row unit for the warp's 4 columns
// 4g .. 4g+3 (four 16-byte loads); one mma k-step is one bit field f of
// the unit, and the thread's four k slots are the logical rows
// f * (group / epp) + 16u + 4t + {0..3}: four neighbouring x values, one
// 8-byte load a row. The x values it loads are also summed for the
// zero-point term (the four threads of a row group add theirs by shuffle).
//
// Bound on the H100: bytes at decode (M <= 32: K*N*bits/8 bytes of codes
// plus the scales, 16.8 MB for an int8 4096 x 4096), operations at a
// 512-row prefill chunk. Each warp owns 32 columns and a share of the
// groups of K; the block's warps split K and add their sums in shared
// memory (8 warps at decode, so 4096 columns still give 128 blocks; 4 at
// prefill, 32 rows per block, the row tiles of one column tile launched
// together so the weight tile comes from HBM once). The next unit's words
// are loaded before the current one's products. No shared-memory staging,
// TMA or wgmma yet: a first kernel that is right.

#include "gemm_common.cuh"

namespace conch {
namespace {

template <int BITS>
__device__ __forceinline__ float field(uint32_t word, int f) {
  return static_cast<float>((word >> (BITS * f)) & ((1u << BITS) - 1u));
}

template <int BITS, int MT, int WARPS_K, typename S, typename O>
__global__ void __launch_bounds__(32 * WARPS_K)
    planar_gemm_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ packed,
                       const S* __restrict__ scales, const float* __restrict__ zp, int zp_mode,
                       O* __restrict__ out, int m, int n, int k, int64_t ldx, int group, float bias) {
  constexpr int EPP = 32 / BITS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int m0 = blockIdx.x * 16 * MT;
  const int n0 = blockIdx.y * 32;
  const int rpg = group / EPP;  // word rows per group
  const int units = rpg / 16;   // 16-word-row units per group
  const int num_groups = k / group;
  const int my_groups = warp < num_groups ? (num_groups - warp + WARPS_K - 1) / WARPS_K : 0;
  const int total = my_groups * units;

  float acc[MT][kTiles][4];
  float part[MT][kTiles][4];
  float xs[MT][2];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][t][e] = 0.0f;

  auto load_unit = [&](uint4 (&w)[4], int j) {
    const int grp = warp + (j / units) * WARPS_K;
    const int u = j % units;
    const int32_t* p = packed + (static_cast<int64_t>(grp) * rpg + 16 * u + 4 * tig) * n + n0 + 4 * g;
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __ldg(reinterpret_cast<const uint4*>(p + static_cast<int64_t>(i) * n));
  };

  uint4 cur[4], nxt[4];
  if (total > 0) load_unit(cur, 0);
  for (int j = 0; j < total; ++j) {
    if (j + 1 < total) load_unit(nxt, j + 1);
    const int grp = warp + (j / units) * WARPS_K;
    const int u = j % units;
    if (u == 0) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        xs[mi][0] = xs[mi][1] = 0.0f;
#pragma unroll
        for (int t = 0; t < kTiles; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mi][t][e] = 0.0f;
      }
    }
    const __nv_bfloat16* xg = x + static_cast<int64_t>(grp) * group + 16 * u + 4 * tig;
#pragma unroll
    for (int f = 0; f < EPP; ++f) {
      uint32_t b[kTiles][2];
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        b[t][0] = pack_bf16x2(field<BITS>(lane_of(cur[0], t), f), field<BITS>(lane_of(cur[1], t), f));
        b[t][1] = pack_bf16x2(field<BITS>(lane_of(cur[2], t), f), field<BITS>(lane_of(cur[3], t), f));
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int row = m0 + 16 * mi + g;
        uint2 lo = make_uint2(0, 0);
        uint2 hi = make_uint2(0, 0);
        if (row < m) lo = *reinterpret_cast<const uint2*>(xg + row * ldx + f * rpg);
        if (row + 8 < m) hi = *reinterpret_cast<const uint2*>(xg + (row + 8) * ldx + f * rpg);
        xs[mi][0] += (bf16_lo(lo.x) + bf16_hi(lo.x)) + (bf16_lo(lo.y) + bf16_hi(lo.y));
        xs[mi][1] += (bf16_lo(hi.x) + bf16_hi(hi.x)) + (bf16_lo(hi.y) + bf16_hi(hi.y));
#pragma unroll
        for (int t = 0; t < kTiles; ++t) mma_bf16_16816(part[mi][t], lo.x, hi.x, lo.y, hi.y, b[t][0], b[t][1]);
      }
    }
    if (u == units - 1) {
      // The group is done: fold its sums in with the zero-point and scale
      // of this thread's output columns 8t .. 8t+7.
      float s[8], z[8];
      load8<S>(s, scales + static_cast<int64_t>(grp) * n + n0 + 8 * tig);
      if (zp_mode == 2) {
        load8<float>(z, zp + static_cast<int64_t>(grp) * n + n0 + 8 * tig);
      } else {
        const float zv = zp_mode == 1 ? __ldg(zp) : bias;
#pragma unroll
        for (int c = 0; c < 8; ++c) z[c] = zv;
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          xs[mi][h] += __shfl_xor_sync(0xffffffffu, xs[mi][h], 1);
          xs[mi][h] += __shfl_xor_sync(0xffffffffu, xs[mi][h], 2);
        }
#pragma unroll
        for (int t = 0; t < kTiles; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 4 * (e & 1) + t;
            acc[mi][t][e] += (part[mi][t][e] - z[c] * xs[mi][e >> 1]) * s[c];
          }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) cur[i] = nxt[i];
  }
  reduce_and_store<MT, WARPS_K>(acc, m, m0, [&](int row, int col, float v) {
    out[static_cast<int64_t>(row) * n + n0 + col] = from_float<O>(v);
  });
}

template <int BITS, typename S, typename O>
cudaError_t launch(const void* x, const void* packed, const void* scales, const void* zp, int zp_mode, void* out,
                   int m, int n, int k, int64_t ldx, int group, int bias, cudaStream_t stream) {
  auto run = [&](auto kernel, int rows, int warps) {
    const dim3 grid((m + rows - 1) / rows, n / 32);
    kernel<<<grid, 32 * warps, 0, stream>>>(static_cast<const __nv_bfloat16*>(x), static_cast<const int32_t*>(packed),
                                            static_cast<const S*>(scales), static_cast<const float*>(zp), zp_mode,
                                            static_cast<O*>(out), m, n, k, ldx, group,
                                            static_cast<float>(bias));
  };
  if (m <= 16) {
    run(planar_gemm_kernel<BITS, 1, 8, S, O>, 16, 8);
  } else {
    run(planar_gemm_kernel<BITS, 2, 4, S, O>, 32, 4);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace conch

// x (M, K) bf16 with row stride ldx (a multiple of 4, 8-byte aligned);
// packed (K / (32 / bits), N) int32, scales (K / group, N) bf16
// (scale_dtype 1) or f32 (0), and per-group zero-points (K / group, N) f32
// (zp_mode 2), one f32 zero-point (1) or none (0: the bias), of ONE layer
// (the wrapper offsets the stack's pointers); out (M, N) bf16 (out_dtype 1)
// or f32 (0), contiguous. N must be a multiple of 32, group a multiple of
// 16 * (32 / bits), and K a multiple of group.
extern "C" int conch_mixed_gemm_planar(const void* x, const void* packed, const void* scales, int scale_dtype,
                                       const void* zp, int zp_mode, void* out, int out_dtype, int m, int n, int k,
                                       int64_t ldx, int bits, int group, int bias, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (m == 0) return static_cast<int>(cudaSuccess);
  if (n % 32 != 0 || ldx % 4 != 0 || group <= 0 || group % (16 * (32 / bits)) != 0 || k % group != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool f32 = scale_dtype == conch::kFloat32;
  cudaError_t status = cudaErrorInvalidValue;
  conch::dispatch_out(out_dtype, [&](auto out_tag) {
    using O = typename decltype(out_tag)::type;
    auto run = [&](auto bits_tag) {
      constexpr int B = decltype(bits_tag)::value;
      status = f32 ? conch::launch<B, float, O>(x, packed, scales, zp, zp_mode, out, m, n, k, ldx, group, bias, s)
                   : conch::launch<B, __nv_bfloat16, O>(x, packed, scales, zp, zp_mode, out, m, n, k, ldx, group,
                                                        bias, s);
    };
    switch (bits) {
      case 2: run(std::integral_constant<int, 2>{}); break;
      case 4: run(std::integral_constant<int, 4>{}); break;
      case 8: run(std::integral_constant<int, 8>{}); break;
      default: break;
    }
  });
  return static_cast<int>(status);
}
