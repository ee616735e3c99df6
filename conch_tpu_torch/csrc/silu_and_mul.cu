// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// SwiGLU gate: out = round(silu(gate)) * up (K6).
//
// Replaces conch_tpu/kernels/activation/silu_and_mul.py:_silu_and_mul_kernel,
// in both of its call forms: the fused halves of one (T, 2d) [gate|up] row
// (_fused_halves_launcher) and two separate (T, d) parts
// (silu_and_mul_parts_launcher). silu(g) = g / (1 + exp(-g)) is computed in
// f32 and rounded to the dtype (f32, bf16 or f16) before the multiply by
// up, as the TPU kernel does. The kernel is csrc/gated_act.cuh's, shared
// with K10b; its design and bound are there.

#include "gated_act.cuh"

// x (rows, 2d) with row stride x_row_stride: gate = x[:, :d], up = x[:, d:];
// out (rows, d) contiguous. The plan's arguments: csrc/gated_act.cuh's gated_act.
extern "C" int conch_silu_and_mul(const void* x, void* out, int rows, int d, int64_t x_row_stride, int dtype,
                                  int vec, int threads, int items, int grid, int pdl, void* stream) {
  return conch::gated_act_halves<conch::SiluAct>(x, out, rows, d, x_row_stride, dtype, vec, threads, items, grid,
                                                 pdl, stream);
}

// gate and up (rows, d) with their own row strides; out (rows, d) contiguous.
extern "C" int conch_silu_and_mul_parts(const void* gate, const void* up, void* out, int rows, int d,
                                        int64_t gate_row_stride, int64_t up_row_stride, int dtype, int vec,
                                        int threads, int items, int grid, int pdl, void* stream) {
  return conch::gated_act<conch::SiluAct>(gate, up, out, rows, d, gate_row_stride, up_row_stride, dtype, vec,
                                          threads, items, grid, pdl, stream);
}
