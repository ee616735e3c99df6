// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Gemma RMS norm over the last axis (K10a).
//
// Replaces conch_tpu/kernels/normalization/gemma_rms_norm.py:_gemma_rms_norm_kernel.
// out = x * rsqrt(mean(x^2) + eps) * (1 + w), the whole product in f32 and
// rounded to x's dtype once at the end (K4, Llama's norm, rounds the
// normalized value before the weight multiply; this kernel must not). The
// squares are summed in f32.
//
// Bound on the H100: bytes (x read, out written, w read). Gemma-2-2B's
// decode step (16 x 2304 bf16) moves 0.15 MB, 44 ns at 3.35 TB/s, so the
// launch and one DRAM round trip set its time; a 512-row prefill chunk
// moves 4.72 MB (1.41 us).
//
// Design: the register-held row kernel of row_norm.cuh (shared with K4),
// with GemmaNorm's arithmetic, launched from the plan of
// kernels/normalization/row_norm.py:row_norm_plan.

#include "row_norm.cuh"

namespace conch {
namespace {

struct GemmaNorm {
  using Acc = float;
  static __device__ __forceinline__ void add(float& sq, float f) { sq += f * f; }
  static __device__ __forceinline__ float inv(float total, int hidden, float eps) {
    return rsqrtf(total / static_cast<float>(hidden) + eps);
  }
  template <typename T>
  static __device__ __forceinline__ float value(float x, float inv, float w) {
    return x * inv * (1.0f + w);
  }
};

}  // namespace
}  // namespace conch

// x (rows, hidden) with row stride x_row_stride, w (hidden,), out (rows,
// hidden) contiguous; all of one dtype. The plan: row_norm.cuh's
// launch_row_norm.
extern "C" int conch_gemma_rms_norm(const void* x, const void* w, void* out, int rows, int hidden,
                                    int64_t x_row_stride, float epsilon, int dtype, int path, int threads_per_row,
                                    int rows_per_block, int items, int grid_x, int pdl, void* stream) {
  const conch::NormParams p{x, w, out, x_row_stride, rows, hidden, items, epsilon};
  return conch::launch_row_norm<conch::GemmaNorm>(p, dtype, path, threads_per_row, rows_per_block, grid_x, pdl,
                                                  static_cast<cudaStream_t>(stream));
}
