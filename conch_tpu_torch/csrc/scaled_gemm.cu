// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Scaled GEMM of int8 (or float8_e4m3fn) operands with row and column
// scales (K8).
//
// Replaces conch_tpu/kernels/quantization/gemm.py:_scaled_gemm_kernel
// (launcher scaled_gemm_launcher). out[M, N] = float(a @ b) * sa[m] * sb[n],
// in that order, rounded to the output dtype; a scalar sa or sb broadcasts.
//
// int8: mma.sync m16n8k32 s8 x s8 -> s32, exact up to the epilogue (the
// largest served sum, 127 * 127 * 14336, fits in int32). Thread (g, t)
// loads k rows 4t .. 4t+3 and 16+4t .. 16+4t+3 of b (row-major (K, N))
// at the warp's 4 columns 4g .. 4g+3, one 4-byte load a row, and turns the
// 4 x 4 bytes around with byte permutes so that each register holds 4 k
// values of one column, the layout the s8 B fragment takes; a is row-major
// (M, K), so its fragments are 4-byte loads. The warps of a block split K
// and add their int32 sums in shared memory (exact, in any order).
// float8_e4m3fn: every value is converted to f32 (exact, as bf16 is) and
// the products summed in f32 by a plain loop, one thread an output; only
// small shapes take this path.
//
// Bound on the H100: bytes at decode (M <= 32: K*N bytes of b, 16.8 MB
// for 4096 x 4096), operations at a 512-row prefill chunk. Block and grid
// shapes as K1b (mixed_gemm_planar.cu). No shared-memory staging, TMA or
// wgmma yet: a first kernel that is right.

#include <cuda_fp8.h>

#include "gemm_common.cuh"

namespace conch {
namespace {

template <typename O>
__device__ __forceinline__ O cast_out(float v);
template <>
__device__ __forceinline__ float cast_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 cast_out<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// b's k rows k0 + 4t + {0..3} (lo) and k0 + 16 + 4t + {0..3} (hi) at the
// warp's columns 4g .. 4g+3, as 4-byte words (byte c = column 4g + c).
__device__ __forceinline__ void load_b(uint32_t (&w)[8], const int8_t* __restrict__ b, int n, int k0, int col,
                                       int tig) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = k0 + (i < 4 ? 4 * tig + i : 16 + 4 * tig + i - 4);
    w[i] = __ldg(reinterpret_cast<const uint32_t*>(b + static_cast<int64_t>(row) * n + col));
  }
}

// Transposes 4 words (rows) of 4 bytes (columns): out[c] byte r = in[r] byte c.
__device__ __forceinline__ void transpose4(uint32_t (&out)[4], uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3) {
  const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
  const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
  out[0] = __byte_perm(lo01, lo23, 0x5410);
  out[1] = __byte_perm(lo01, lo23, 0x7632);
  out[2] = __byte_perm(hi01, hi23, 0x5410);
  out[3] = __byte_perm(hi01, hi23, 0x7632);
}

template <int MT, int WARPS_K, typename O>
__global__ void __launch_bounds__(32 * WARPS_K)
    scaled_gemm_s8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b, const float* __restrict__ sa,
                          int sa_scalar, const float* __restrict__ sb, int sb_scalar, O* __restrict__ out, int m,
                          int n, int k, int64_t lda) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int m0 = blockIdx.x * 16 * MT;
  const int n0 = blockIdx.y * 32;
  const int steps = k / 32;

  int acc[MT][kTiles][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][t][e] = 0;

  uint32_t cur[8], nxt[8];
  if (warp < steps) load_b(cur, b, n, 32 * warp, n0 + 4 * g, tig);
  for (int st = warp; st < steps; st += WARPS_K) {
    if (st + WARPS_K < steps) load_b(nxt, b, n, 32 * (st + WARPS_K), n0 + 4 * g, tig);
    uint32_t blo[4], bhi[4];  // [tile]: k 4t..4t+3, and 16+4t..16+4t+3, of column 4g + tile
    transpose4(blo, cur[0], cur[1], cur[2], cur[3]);
    transpose4(bhi, cur[4], cur[5], cur[6], cur[7]);
    const int k0 = 32 * st + 4 * tig;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int row = m0 + 16 * mi + g;
      uint32_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
      if (row < m) {
        const int8_t* p = a + row * lda + k0;
        a0 = *reinterpret_cast<const uint32_t*>(p);
        a2 = *reinterpret_cast<const uint32_t*>(p + 16);
      }
      if (row + 8 < m) {
        const int8_t* p = a + (row + 8) * lda + k0;
        a1 = *reinterpret_cast<const uint32_t*>(p);
        a3 = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int t = 0; t < kTiles; ++t) mma_s8_16832(acc[mi][t], a0, a1, a2, a3, blo[t], bhi[t]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) cur[i] = nxt[i];
  }
  reduce_and_store<MT, WARPS_K>(acc, m, m0, [&](int row, int col, int v) {
    const float ra = sa_scalar ? __ldg(sa) : __ldg(sa + row);
    const float cb = sb_scalar ? __ldg(sb) : __ldg(sb + n0 + col);
    out[static_cast<int64_t>(row) * n + n0 + col] = cast_out<O>(__fmul_rn(__fmul_rn(static_cast<float>(v), ra), cb));
  });
}

template <typename O>
__global__ void scaled_gemm_fp8_kernel(const __nv_fp8_e4m3* __restrict__ a, const __nv_fp8_e4m3* __restrict__ b,
                                       const float* __restrict__ sa, int sa_scalar, const float* __restrict__ sb,
                                       int sb_scalar, O* __restrict__ out, int m, int n, int k, int64_t lda) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  if (col >= n) return;
  float acc = 0.0f;
  for (int kk = 0; kk < k; ++kk) {
    acc += static_cast<float>(a[row * lda + kk]) * static_cast<float>(b[static_cast<int64_t>(kk) * n + col]);
  }
  const float ra = sa_scalar ? sa[0] : sa[row];
  const float cb = sb_scalar ? sb[0] : sb[col];
  out[static_cast<int64_t>(row) * n + col] = cast_out<O>(__fmul_rn(__fmul_rn(acc, ra), cb));
}

template <typename O>
cudaError_t launch_s8(const void* a, const void* b, const void* sa, int sa_scalar, const void* sb, int sb_scalar,
                      void* out, int m, int n, int k, int64_t lda, cudaStream_t stream) {
  auto run = [&](auto kernel, int rows, int warps) {
    const dim3 grid((m + rows - 1) / rows, n / 32);
    kernel<<<grid, 32 * warps, 0, stream>>>(static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
                                            static_cast<const float*>(sa), sa_scalar, static_cast<const float*>(sb),
                                            sb_scalar, static_cast<O*>(out), m, n, k, lda);
  };
  if (m <= 16) {
    run(scaled_gemm_s8_kernel<1, 8, O>, 16, 8);
  } else {
    run(scaled_gemm_s8_kernel<2, 4, O>, 32, 4);
  }
  return cudaGetLastError();
}

template <typename O>
cudaError_t launch_fp8(const void* a, const void* b, const void* sa, int sa_scalar, const void* sb, int sb_scalar,
                       void* out, int m, int n, int k, int64_t lda, cudaStream_t stream) {
  const dim3 grid((n + 127) / 128, m);
  scaled_gemm_fp8_kernel<O><<<grid, 128, 0, stream>>>(
      static_cast<const __nv_fp8_e4m3*>(a), static_cast<const __nv_fp8_e4m3*>(b), static_cast<const float*>(sa),
      sa_scalar, static_cast<const float*>(sb), sb_scalar, static_cast<O*>(out), m, n, k, lda);
  return cudaGetLastError();
}

}  // namespace
}  // namespace conch

// a (M, K) with row stride lda, b (K, N) contiguous, both int8 (fp8 0) or
// both float8_e4m3fn (fp8 1); sa (M) or one value (sa_scalar 1), sb (N) or
// one value, f32; out (M, N) contiguous, f32 (out_dtype 0) or bf16 (1).
// int8 needs K a multiple of 32, N of 32 and lda of 4.
extern "C" int conch_scaled_gemm(const void* a, const void* b, const void* sa, int sa_scalar, const void* sb,
                                 int sb_scalar, void* out, int out_dtype, int m, int n, int k, int64_t lda, int fp8,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const bool bf16 = out_dtype == conch::kBFloat16;
  if (fp8) {
    return static_cast<int>(bf16 ? conch::launch_fp8<__nv_bfloat16>(a, b, sa, sa_scalar, sb, sb_scalar, out, m, n, k, lda, s)
                                 : conch::launch_fp8<float>(a, b, sa, sa_scalar, sb, sb_scalar, out, m, n, k, lda, s));
  }
  if (k % 32 != 0 || n % 32 != 0 || lda % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(bf16 ? conch::launch_s8<__nv_bfloat16>(a, b, sa, sa_scalar, sb, sb_scalar, out, m, n, k, lda, s)
                               : conch::launch_s8<float>(a, b, sa, sa_scalar, sb, sb_scalar, out, m, n, k, lda, s));
}
