// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// GeGLU gate: out = round(gelu_tanh(gate)) * up (K10b).
//
// Replaces conch_tpu/kernels/activation/gelu_tanh_and_mul.py:_gelu_tanh_and_mul_kernel,
// in both of its call forms: the fused halves of one (T, 2d) [gate|up] row
// (gelu_tanh_and_mul_launcher, through _fused_halves_launcher) and two
// separate (T, d) parts (gelu_tanh_and_mul_parts_launcher). The gate is
// x * sigmoid(2 beta (x + kappa x^3)), beta = sqrt(2/pi), kappa = 0.044715
// (equal to 0.5 x (1 + tanh(beta (x + kappa x^3)))), in f32, rounded to the
// dtype before the multiply by up in that dtype, as the TPU kernel does.
// Bound on the H100: bytes (gate and up read once, out written once).
// Design: K6's (csrc/silu_and_mul.cu): one kernel takes a gate pointer and
// an up pointer, each with its own row stride; the halves form passes the
// same row twice (up = gate + d), so the (T, 2d) input is read in place
// with no slice copies. A 2-D grid (column blocks x rows) keeps the card
// busy at decode's few rows.

#include "common.cuh"

namespace conch {
namespace {

constexpr int kThreads = 256;
constexpr float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kKappa = 0.044715f;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gelu_tanh_and_mul_kernel(const T* __restrict__ gate, const T* __restrict__ up, T* __restrict__ out, int d,
                             int64_t gate_row_stride, int64_t up_row_stride) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= d) return;
  const int64_t row = blockIdx.y;
  const float g = to_float(gate[row * gate_row_stride + col]);
  const float inner = kBeta * (g + kKappa * g * g * g);
  const T gelu = from_float<T>(g / (1.0f + expf(-2.0f * inner)));
  out[row * d + col] = from_float<T>(to_float(gelu) * to_float(up[row * up_row_stride + col]));
}

template <typename T>
void launch(const void* gate, const void* up, void* out, int rows, int d, int64_t gate_row_stride,
            int64_t up_row_stride, cudaStream_t stream) {
  const dim3 grid((d + kThreads - 1) / kThreads, rows);
  gelu_tanh_and_mul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(gate), static_cast<const T*>(up), static_cast<T*>(out), d, gate_row_stride,
      up_row_stride);
}

int dispatch(const void* gate, const void* up, void* out, int rows, int d, int64_t gate_row_stride,
             int64_t up_row_stride, int dtype, cudaStream_t stream) {
  if (rows == 0 || d == 0) return static_cast<int>(cudaSuccess);
  if (dtype == kBFloat16) {
    launch<__nv_bfloat16>(gate, up, out, rows, d, gate_row_stride, up_row_stride, stream);
  } else if (dtype == kFloat32) {
    launch<float>(gate, up, out, rows, d, gate_row_stride, up_row_stride, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace conch

// x (rows, 2d) with row stride x_row_stride: gate = x[:, :d], up = x[:, d:];
// out (rows, d) contiguous.
extern "C" int conch_gelu_tanh_and_mul(const void* x, void* out, int rows, int d, int64_t x_row_stride, int dtype,
                                       void* stream) {
  const size_t elem = dtype == conch::kBFloat16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const void* up = static_cast<const char*>(x) + static_cast<size_t>(d) * elem;
  return conch::dispatch(x, up, out, rows, d, x_row_stride, x_row_stride, dtype, static_cast<cudaStream_t>(stream));
}

// gate and up (rows, d) with their own row strides; out (rows, d) contiguous.
extern "C" int conch_gelu_tanh_and_mul_parts(const void* gate, const void* up, void* out, int rows, int d,
                                             int64_t gate_row_stride, int64_t up_row_stride, int dtype,
                                             void* stream) {
  return conch::dispatch(gate, up, out, rows, d, gate_row_stride, up_row_stride, dtype,
                         static_cast<cudaStream_t>(stream));
}
