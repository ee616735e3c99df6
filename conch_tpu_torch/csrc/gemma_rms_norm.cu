// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Gemma RMS norm over the last axis (K10a).
//
// Replaces conch_tpu/kernels/normalization/gemma_rms_norm.py:_gemma_rms_norm_kernel.
// out = x * rsqrt(mean(x^2) + eps) * (1 + w), the whole product in f32 and
// rounded to x's dtype once at the end (K4, Llama's norm, rounds the
// normalized value before the weight multiply; this kernel must not).
// Bound on the H100: bytes (x read, out written, w read; a few operations
// an element). Design: K4's, one block per row, so any number of rows and
// any hidden size (not only multiples of 128) work; each thread sums the
// squares of a strided slice, a warp-shuffle plus shared-memory reduction
// gives the row's sum, and a second pass over the row (from L1/L2) writes
// it.

#include "common.cuh"

namespace conch {
namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gemma_rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int hidden,
                          int64_t x_row_stride, float epsilon) {
  __shared__ float warp_sums[kThreads / 32];
  const T* xr = x + blockIdx.x * x_row_stride;
  T* outr = out + static_cast<int64_t>(blockIdx.x) * hidden;
  float sq = 0.0f;
  for (int i = threadIdx.x; i < hidden; i += kThreads) {
    const float v = to_float(xr[i]);
    sq += v * v;
  }
  sq = warp_sum(sq);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sq;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
  const float inv = rsqrtf(total / static_cast<float>(hidden) + epsilon);
  for (int i = threadIdx.x; i < hidden; i += kThreads) {
    outr[i] = from_float<T>(to_float(xr[i]) * inv * (1.0f + to_float(w[i])));
  }
}

}  // namespace
}  // namespace conch

// x (rows, hidden) with row stride x_row_stride, w (hidden,), out (rows,
// hidden) contiguous; all of one dtype.
extern "C" int conch_gemma_rms_norm(const void* x, const void* w, void* out, int rows, int hidden,
                                    int64_t x_row_stride, float epsilon, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  if (dtype == conch::kBFloat16) {
    conch::gemma_rms_norm_kernel<__nv_bfloat16><<<rows, conch::kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
        hidden, x_row_stride, epsilon);
  } else if (dtype == conch::kFloat32) {
    conch::gemma_rms_norm_kernel<float><<<rows, conch::kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out), hidden, x_row_stride,
        epsilon);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
