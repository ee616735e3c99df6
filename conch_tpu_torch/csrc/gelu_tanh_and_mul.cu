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
// dtype (f32, bf16 or f16) before the multiply by up, as the TPU kernel
// does. The kernel is csrc/gated_act.cuh's, shared with K6; its design and
// bound are there.

#include "gated_act.cuh"

// x (rows, 2d) with row stride x_row_stride: gate = x[:, :d], up = x[:, d:];
// out (rows, d) contiguous. The plan's arguments: csrc/gated_act.cuh's gated_act.
extern "C" int conch_gelu_tanh_and_mul(const void* x, void* out, int rows, int d, int64_t x_row_stride, int dtype,
                                       int vec, int threads, int items, int grid, int pdl, void* stream) {
  return conch::gated_act_halves<conch::GeluTanhAct>(x, out, rows, d, x_row_stride, dtype, vec, threads, items,
                                                     grid, pdl, stream);
}

// gate and up (rows, d) with their own row strides; out (rows, d) contiguous.
extern "C" int conch_gelu_tanh_and_mul_parts(const void* gate, const void* up, void* out, int rows, int d,
                                             int64_t gate_row_stride, int64_t up_row_stride, int dtype, int vec,
                                             int threads, int items, int grid, int pdl, void* stream) {
  return conch::gated_act<conch::GeluTanhAct>(gate, up, out, rows, d, gate_row_stride, up_row_stride, dtype, vec,
                                              threads, items, grid, pdl, stream);
}
