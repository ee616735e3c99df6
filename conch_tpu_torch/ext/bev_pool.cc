// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Native C++ baseline for BEVPool on the host: each interval's points summed
// serially into its grid cell (forward), each cell's gradient copied to its
// points (backward). A cross-check baseline for the vision ops, built by
// conch_tpu_torch/native.py with g++ at first use.
//
// Plain C ABI, loaded with ctypes.

#include <cstdint>
#include <cstring>

extern "C" {

// output: (B, Z, X, Y, C) zero-initialized by the caller.
void conch_bev_pool_forward(
    const float* image_feats,   // (n, c)
    const int32_t* geom_feats,  // (n, 4): x, y, z, b
    const int32_t* interval_starts,
    const int32_t* interval_lengths,
    int64_t num_intervals,
    int64_t channels,
    int64_t grid_z,
    int64_t grid_x,
    int64_t grid_y,
    float* output) {
  for (int64_t i = 0; i < num_intervals; ++i) {
    const int64_t start = interval_starts[i];
    const int64_t len = interval_lengths[i];
    const int32_t* g = geom_feats + start * 4;
    float* out_cell =
        output + (((static_cast<int64_t>(g[3]) * grid_z + g[2]) * grid_x + g[0]) * grid_y + g[1]) * channels;
    for (int64_t p = 0; p < len; ++p) {
      const float* feat = image_feats + (start + p) * channels;
      for (int64_t c = 0; c < channels; ++c) {
        out_cell[c] += feat[c];
      }
    }
  }
}

// x_grad: (n, c) zero-initialized by the caller.
void conch_bev_pool_backward(
    const float* grad_output,   // (B, Z, X, Y, C)
    const int32_t* geom_feats,  // (n, 4)
    const int32_t* interval_starts,
    const int32_t* interval_lengths,
    int64_t num_intervals,
    int64_t channels,
    int64_t grid_z,
    int64_t grid_x,
    int64_t grid_y,
    float* x_grad) {
  for (int64_t i = 0; i < num_intervals; ++i) {
    const int64_t start = interval_starts[i];
    const int64_t len = interval_lengths[i];
    const int32_t* g = geom_feats + start * 4;
    const float* grad_cell =
        grad_output + (((static_cast<int64_t>(g[3]) * grid_z + g[2]) * grid_x + g[0]) * grid_y + g[1]) * channels;
    for (int64_t p = 0; p < len; ++p) {
      std::memcpy(x_grad + (start + p) * channels, grad_cell, channels * sizeof(float));
    }
  }
}

}  // extern "C"
