// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Weight-only GEMM over GPTQ rows, with an optional 16-entry codebook,
// stacked per layer (K1c).
//
// Replaces conch_tpu/kernels/quantization/gemm.py:_mixed_gemm_kernel
// (launcher mixed_precision_gemm_launcher, layout "gptq", with
// layer_index). out[M, N] = x[M, K] @ W, with 2-, 4- or 8-bit codes c and,
// as in the TPU kernel, the weight dequantized BEFORE the product:
// W[k, n] = (c - bias [- z]) * s or, with a codebook (NF4, FP4),
// W[k, n] = (book[c] [- z]) * s, with s (absmax for NF4) and the
// optional zero-point z of group k / group, computed in f32 and rounded to
// bf16 (the activation dtype); the products are summed in f32.
//
// Layout (conch_tpu_torch/utils/quant_utils.py:pack_rows): word r holds
// logical rows r * epp + i in bit field i (epp = 32 / bits). A warp's unit
// is 16 word rows; thread (g, t) loads word rows 4i + t (i = 0..3) for the
// warp's 4 columns 4g .. 4g+3 (four 16-byte loads). One mma k-step takes
// fields 4j .. 4j+3 of word i from each of the four threads of a row
// group, so a thread's k slots are the logical rows
// (16u + 4i + t) * epp + 4j + {0..3}: four neighbouring x values (one
// 8-byte load a row) that share one group when group % 4 == 0. Word rows
// past K / epp read as zero, so K needs only to be a multiple of epp.
//
// Bound on the H100: bytes at decode (M <= 32: K*N*bits/8 bytes of codes
// plus the scales; 8.4 MB of NF4 codes and 1 MB of f32 absmax for
// 4096 x 4096), operations at a 512-row prefill chunk. The block and grid
// shapes are K1b's (mixed_gemm_planar.cu): 32 columns a warp, warps
// splitting K, reduced in shared memory. The dequantization costs about
// ten instructions a code (shift, mask, table lookup in shared memory,
// scale, convert), so at decode the kernel is likely bound by instruction
// throughput, not by HBM; a first kernel that is right.

#include "gemm_common.cuh"

namespace conch {
namespace {

template <int BITS, int MT, int WARPS_K, typename S, bool CODEBOOK, typename O>
__global__ void __launch_bounds__(32 * WARPS_K)
    rows_gemm_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ packed,
                     const S* __restrict__ scales, const float* __restrict__ zp, int zp_mode,
                     const float* __restrict__ codebook, O* __restrict__ out, int m, int n, int k,
                     int64_t ldx, int group, float bias) {
  constexpr int EPP = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  __shared__ float book[16];
  if (CODEBOOK && threadIdx.x < 16) book[threadIdx.x] = codebook[threadIdx.x];
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int m0 = blockIdx.x * 16 * MT;
  const int n0 = blockIdx.y * 32;
  const int kw = k / EPP;            // word rows
  const int units = (kw + 15) / 16;  // 16-word-row units

  float acc[MT][kTiles][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][t][e] = 0.0f;

  auto load_unit = [&](uint4 (&w)[4], int u) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int wr = 16 * u + 4 * i + tig;
      w[i] = wr < kw ? __ldg(reinterpret_cast<const uint4*>(packed + static_cast<int64_t>(wr) * n + n0 + 4 * g))
                     : make_uint4(0, 0, 0, 0);
    }
  };

  uint4 cur[4], nxt[4];
  if (warp < units) load_unit(cur, warp);
  for (int u = warp; u < units; u += WARPS_K) {
    if (u + WARPS_K < units) load_unit(nxt, u + WARPS_K);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int wr = 16 * u + 4 * i + tig;
      const bool valid = wr < kw;
#pragma unroll
      for (int j = 0; j < EPP / 4; ++j) {
        const int r0 = wr * EPP + 4 * j;  // logical row of this thread's first k slot
        float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (valid) {
          const int64_t meta = static_cast<int64_t>(r0 / group) * n + n0 + 4 * g;
          load4<S>(s, scales + meta);
          if (zp_mode == 2) {
            load4<float>(z, zp + meta);
          } else if (zp_mode == 1) {
            z[0] = z[1] = z[2] = z[3] = __ldg(zp);
          }
        }
        uint32_t b[kTiles][2];
#pragma unroll
        for (int t = 0; t < kTiles; ++t) {
          const uint32_t word = lane_of(cur[i], t);
          float v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint32_t c = (word >> (BITS * (4 * j + q))) & MASK;
            float w = CODEBOOK ? book[c] : static_cast<float>(c) - bias;
            if (zp_mode != 0) w = w - z[t];
            v[q] = __fmul_rn(w, s[t]);
          }
          b[t][0] = pack_bf16x2(v[0], v[1]);
          b[t][1] = pack_bf16x2(v[2], v[3]);
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const int row = m0 + 16 * mi + g;
          uint2 lo = make_uint2(0, 0);
          uint2 hi = make_uint2(0, 0);
          if (valid && row < m) lo = *reinterpret_cast<const uint2*>(x + row * ldx + r0);
          if (valid && row + 8 < m) hi = *reinterpret_cast<const uint2*>(x + (row + 8) * ldx + r0);
#pragma unroll
          for (int t = 0; t < kTiles; ++t) mma_bf16_16816(acc[mi][t], lo.x, hi.x, lo.y, hi.y, b[t][0], b[t][1]);
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

template <int BITS, typename S, bool CODEBOOK, typename O>
cudaError_t launch(const void* x, const void* packed, const void* scales, const void* zp, int zp_mode,
                   const void* codebook, void* out, int m, int n, int k, int64_t ldx, int group, int bias,
                   cudaStream_t stream) {
  auto run = [&](auto kernel, int rows, int warps) {
    const dim3 grid((m + rows - 1) / rows, n / 32);
    kernel<<<grid, 32 * warps, 0, stream>>>(static_cast<const __nv_bfloat16*>(x), static_cast<const int32_t*>(packed),
                                            static_cast<const S*>(scales), static_cast<const float*>(zp), zp_mode,
                                            static_cast<const float*>(codebook), static_cast<O*>(out), m,
                                            n, k, ldx, group, static_cast<float>(bias));
  };
  if (m <= 16) {
    run(rows_gemm_kernel<BITS, 1, 8, S, CODEBOOK, O>, 16, 8);
  } else {
    run(rows_gemm_kernel<BITS, 2, 4, S, CODEBOOK, O>, 32, 4);
  }
  return cudaGetLastError();
}

template <int BITS, typename O>
cudaError_t dispatch(bool f32_scales, bool codebook, const void* x, const void* packed, const void* scales,
                     const void* zp, int zp_mode, const void* book, void* out, int m, int n, int k, int64_t ldx,
                     int group, int bias, cudaStream_t s) {
  if (f32_scales) {
    return codebook ? launch<BITS, float, true, O>(x, packed, scales, zp, zp_mode, book, out, m, n, k, ldx, group,
                                                   bias, s)
                    : launch<BITS, float, false, O>(x, packed, scales, zp, zp_mode, book, out, m, n, k, ldx, group,
                                                    bias, s);
  }
  return codebook ? launch<BITS, __nv_bfloat16, true, O>(x, packed, scales, zp, zp_mode, book, out, m, n, k, ldx,
                                                         group, bias, s)
                  : launch<BITS, __nv_bfloat16, false, O>(x, packed, scales, zp, zp_mode, book, out, m, n, k, ldx,
                                                          group, bias, s);
}

}  // namespace
}  // namespace conch

// x (M, K) bf16 with row stride ldx (a multiple of 4, 8-byte aligned);
// packed (K / (32 / bits), N) int32, scales (ceil(K / group), N) bf16
// (scale_dtype 1) or f32 (0), per-group zero-points of the same shape in
// f32 (zp_mode 2), one f32 zero-point (1) or none (0), and codebook (16
// f32 on the device, 4-bit codes only) or null, of ONE layer (the wrapper
// offsets the stack's pointers); out (M, N) bf16 (out_dtype 1) or f32 (0),
// contiguous. N must be a multiple of 32 and group of 4.
extern "C" int conch_mixed_gemm_rows(const void* x, const void* packed, const void* scales, int scale_dtype,
                                     const void* zp, int zp_mode, const void* codebook, void* out, int out_dtype,
                                     int m, int n, int k, int64_t ldx, int bits, int group, int bias, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (m == 0) return static_cast<int>(cudaSuccess);
  if (n % 32 != 0 || ldx % 4 != 0 || group <= 0 || group % 4 != 0 || k % (32 / bits) != 0 ||
      (codebook != nullptr && bits != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool f32 = scale_dtype == conch::kFloat32;
  const bool book = codebook != nullptr;
  cudaError_t status = cudaErrorInvalidValue;
  conch::dispatch_out(out_dtype, [&](auto out_tag) {
    using O = typename decltype(out_tag)::type;
    switch (bits) {
      case 2:
        status = conch::dispatch<2, O>(f32, false, x, packed, scales, zp, zp_mode, codebook, out, m, n, k, ldx, group,
                                       bias, s);
        break;
      case 4:
        status = conch::dispatch<4, O>(f32, book, x, packed, scales, zp, zp_mode, codebook, out, m, n, k, ldx, group,
                                       bias, s);
        break;
      case 8:
        status = conch::dispatch<8, O>(f32, false, x, packed, scales, zp, zp_mode, codebook, out, m, n, k, ldx, group,
                                       bias, s);
        break;
      default:
        break;
    }
  });
  return static_cast<int>(status);
}
