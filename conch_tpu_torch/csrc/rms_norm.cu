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
// Llama-3-8B's decode step (8 x 4096 bf16) moves 0.14 MB, 42 ns at 3.35
// TB/s: the launch and one DRAM round trip set K4's time.
//
// K4's design: the register-held row kernel of row_norm.cuh (shared with
// K10a), with LlamaNorm's arithmetic, launched from the plan of
// kernels/normalization/row_norm.py:row_norm_plan as a programmatic
// dependent: a decode step's row is spread over 256 threads of 16-byte
// vectors and read from memory once.
// K4b's design: one block per row, so any number of rows and any hidden
// size work; each thread sums the squares of a strided slice, a
// warp-shuffle plus shared-memory reduction gives the row's sum, and a
// second pass over the row (from L1/L2) writes it; the first pass writes s
// and the second reads s back. f32, bf16 and f16.

#include "row_norm.cuh"

namespace conch {
namespace {

// K4's arithmetic in row_norm_kernel: squares summed in f64, the mean
// rounded once to f32; x * inv rounded to T, then times w, rounded again.
struct LlamaNorm {
  using Acc = double;
  static __device__ __forceinline__ void add(double& sq, float f) { sq += static_cast<double>(f * f); }
  static __device__ __forceinline__ float inv(double total, int hidden, float eps) {
    return rsqrtf(static_cast<float>(total / hidden) + eps);
  }
  template <typename T>
  static __device__ __forceinline__ float value(float x, float inv, float w) {
    return to_float(from_float<T>(x * inv)) * w;
  }
};

// K4b's block.
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
// hidden) contiguous; all of one dtype (f32, bf16 or f16). The plan:
// row_norm.cuh's launch_row_norm.
extern "C" int conch_rms_norm(const void* x, const void* w, void* out, int rows, int hidden, int64_t x_row_stride,
                              float epsilon, int dtype, int path, int threads_per_row, int rows_per_block, int items,
                              int grid_x, int pdl, void* stream) {
  const conch::NormParams p{x, w, out, x_row_stride, rows, hidden, items, epsilon};
  return conch::launch_row_norm<conch::LlamaNorm>(p, dtype, path, threads_per_row, rows_per_block, grid_x, pdl,
                                                  static_cast<cudaStream_t>(stream));
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
