// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// RMS norm over the last axis (K4), and the fused residual add + RMS norm
// (K4b).
//
// K4 replaces conch_tpu/kernels/normalization/rms_norm.py:_rms_norm_kernel.
// out = round(x * rsqrt(mean(x^2) + eps)) * w, where the squares and the
// rsqrt are f32 and the normalized value is rounded to x's dtype BEFORE
// the weight multiply in that dtype, as the TPU kernel does. The squares
// are summed in f64 and the mean rounded once to f32, as the plain version
// does: the mean is then the same whatever the order of the sum, so the
// kernel equals its plain version bit for bit (an f32 sum in another order
// moved the rsqrt by an ulp, and the two roundings after it turned that
// into up to two ulps of an f16 output).
//
// K4b replaces conch_tpu/kernels/normalization/rms_norm.py:
// _fused_add_rms_norm_kernel. s = round(x + r) (an f32 add then one
// rounding, which equals the add in the dtype for f32, bf16 and f16) goes
// to res_out, and out is K4 of s. Both are new tensors: nothing is updated
// in place, as in the JAX package.
//
// Bound on the H100: bytes (K4: x read, out written, w read; K4b: x and r
// read, out and res_out written, w read; a few operations an element).
// Design: one block per row, so any number of rows and any hidden size
// (not only multiples of 128) work; each thread sums the squares of a
// strided slice, a warp-shuffle plus shared-memory reduction gives the
// row's sum, and a second pass over the row (from L1/L2) writes it. K4b's
// first pass writes s and its second pass reads s back. f32, bf16 and f16.

#include "common.cuh"

namespace conch {
namespace {

constexpr int kThreads = 256;

// The row's sum of squares, in every thread of the block.
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sums[kThreads / 32];
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  double total = 0.0;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
  return total;
}

// out[i] = round(s[i] * inv) * w[i], in T. s is not __restrict__: K4b
// reads back the row it wrote, which must not go through the read-only
// (non-coherent) path.
template <typename T>
__device__ __forceinline__ void write_normalized(const T* s, const T* __restrict__ w,
                                                 T* __restrict__ outr, int hidden, float inv) {
  for (int i = threadIdx.x; i < hidden; i += kThreads) {
    const T normalized = from_float<T>(to_float(s[i]) * inv);
    outr[i] = from_float<T>(to_float(normalized) * to_float(w[i]));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int hidden,
                    int64_t x_row_stride, float epsilon) {
  const T* xr = x + blockIdx.x * x_row_stride;
  double sq = 0.0;
  for (int i = threadIdx.x; i < hidden; i += kThreads) {
    const float v = to_float(xr[i]);
    sq += static_cast<double>(v * v);
  }
  const float inv = rsqrtf(static_cast<float>(block_sum(sq) / hidden) + epsilon);
  write_normalized(xr, w, out + static_cast<int64_t>(blockIdx.x) * hidden, hidden, inv);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_add_rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ w,
                              T* __restrict__ out, T* res_out, int hidden, int64_t x_row_stride,
                              int64_t r_row_stride, float epsilon) {
  const T* xr = x + blockIdx.x * x_row_stride;
  const T* rr = r + blockIdx.x * r_row_stride;
  T* sr = res_out + static_cast<int64_t>(blockIdx.x) * hidden;
  double sq = 0.0;
  for (int i = threadIdx.x; i < hidden; i += kThreads) {
    const T s = from_float<T>(to_float(xr[i]) + to_float(rr[i]));
    sr[i] = s;
    const float v = to_float(s);
    sq += static_cast<double>(v * v);
  }
  const float inv = rsqrtf(static_cast<float>(block_sum(sq) / hidden) + epsilon);
  // Each thread reads back only the elements it wrote: no barrier needed.
  write_normalized<T>(sr, w, out + static_cast<int64_t>(blockIdx.x) * hidden, hidden, inv);
}

// Calls launch(TypeTag<T>{}) for dtype codes f32, bf16 and f16; false for others.
template <typename Launch>
bool dispatch_float(int dtype, Launch&& launch) {
  switch (dtype) {
    case kFloat32: launch(TypeTag<float>{}); return true;
    case kBFloat16: launch(TypeTag<__nv_bfloat16>{}); return true;
    case kFloat16: launch(TypeTag<__half>{}); return true;
    default: return false;
  }
}

}  // namespace
}  // namespace conch

// x (rows, hidden) with row stride x_row_stride, w (hidden,), out (rows,
// hidden) contiguous; all of one dtype (f32, bf16 or f16).
extern "C" int conch_rms_norm(const void* x, const void* w, void* out, int rows, int hidden, int64_t x_row_stride,
                              float epsilon, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const bool ok = conch::dispatch_float(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    conch::rms_norm_kernel<T><<<rows, conch::kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), hidden, x_row_stride, epsilon);
  });
  return static_cast<int>(ok ? cudaGetLastError() : cudaErrorInvalidValue);
}

// x and r (rows, hidden) with row strides x_row_stride and r_row_stride, w
// (hidden,), out and res_out (rows, hidden) contiguous; all of one dtype.
extern "C" int conch_fused_add_rms_norm(const void* x, const void* r, const void* w, void* out, void* res_out,
                                        int rows, int hidden, int64_t x_row_stride, int64_t r_row_stride,
                                        float epsilon, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const bool ok = conch::dispatch_float(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    conch::fused_add_rms_norm_kernel<T><<<rows, conch::kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const T*>(w), static_cast<T*>(out),
        static_cast<T*>(res_out), hidden, x_row_stride, r_row_stride, epsilon);
  });
  return static_cast<int>(ok ? cudaGetLastError() : cudaErrorInvalidValue);
}
