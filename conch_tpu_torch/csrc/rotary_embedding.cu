// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// NeoX rotary embedding (K5).
//
// Replaces conch_tpu/kernels/embedding/rotary_embedding.py:_rope_kernel.
// Bound on the H100: bytes. Per token it reads q and k once, one f32
// [cos|sin] row and a position, and writes q and k once; about one
// multiply-add per byte, far below the card's ~295 operations per byte.
// Design: one block per token, so the token's cos/sin row is fetched
// once and stays in L1 for every head; each thread rotates (x1, x2)
// pairs of one head in f32 (as the TPU kernel does) and rounds once on
// store. q and k are read through a row stride, so the slices of the
// fused qkv projection need no copy; outputs are written contiguous.

#include "common.cuh"

namespace conch {

template <typename T>
__global__ void rope_kernel(const T* __restrict__ q, const T* __restrict__ k, T* __restrict__ q_out,
                            T* __restrict__ k_out, const float* __restrict__ cos_sin,
                            const int32_t* __restrict__ positions, int64_t q_row_stride, int64_t k_row_stride,
                            int num_q_heads, int num_k_heads, int head_size, int rot_dim, int max_position) {
  const int64_t t = blockIdx.x;
  int pos = positions[t];
  pos = pos < 0 ? 0 : (pos >= max_position ? max_position - 1 : pos);
  const int half = rot_dim / 2;
  const float* cs = cos_sin + static_cast<int64_t>(pos) * rot_dim;
  // Per head: `half` rotated pairs, then the untouched tail past rot_dim.
  const int per_head = half + (head_size - rot_dim);
  const int total = (num_q_heads + num_k_heads) * per_head;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int h = idx / per_head;
    const int i = idx - h * per_head;
    const T* src;
    T* dst;
    if (h < num_q_heads) {
      src = q + t * q_row_stride + static_cast<int64_t>(h) * head_size;
      dst = q_out + (t * num_q_heads + h) * head_size;
    } else {
      const int hk = h - num_q_heads;
      src = k + t * k_row_stride + static_cast<int64_t>(hk) * head_size;
      dst = k_out + (t * num_k_heads + hk) * head_size;
    }
    if (i < half) {
      const float c = cs[i];
      const float s = cs[half + i];
      const float x1 = to_float(src[i]);
      const float x2 = to_float(src[i + half]);
      dst[i] = from_float<T>(x1 * c - x2 * s);
      dst[i + half] = from_float<T>(x2 * c + x1 * s);
    } else {
      const int j = rot_dim + (i - half);
      dst[j] = src[j];
    }
  }
}

template <typename T>
void launch_rope(const void* q, const void* k, void* q_out, void* k_out, const void* cos_sin, const void* positions,
                 int num_tokens, int64_t q_row_stride, int64_t k_row_stride, int num_q_heads, int num_k_heads,
                 int head_size, int rot_dim, int max_position, cudaStream_t stream) {
  rope_kernel<T><<<num_tokens, 128, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<T*>(q_out), static_cast<T*>(k_out),
      static_cast<const float*>(cos_sin), static_cast<const int32_t*>(positions), q_row_stride, k_row_stride,
      num_q_heads, num_k_heads, head_size, rot_dim, max_position);
}

}  // namespace conch

extern "C" int conch_rotary_embedding(const void* q, const void* k, void* q_out, void* k_out, const void* cos_sin,
                                      const void* positions, int num_tokens, int64_t q_row_stride,
                                      int64_t k_row_stride, int num_q_heads, int num_k_heads, int head_size,
                                      int rot_dim, int max_position, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (num_tokens == 0) return static_cast<int>(cudaSuccess);
  if (dtype == conch::kBFloat16) {
    conch::launch_rope<__nv_bfloat16>(q, k, q_out, k_out, cos_sin, positions, num_tokens, q_row_stride,
                                      k_row_stride, num_q_heads, num_k_heads, head_size, rot_dim, max_position, s);
  } else if (dtype == conch::kFloat32) {
    conch::launch_rope<float>(q, k, q_out, k_out, cos_sin, positions, num_tokens, q_row_stride, k_row_stride,
                              num_q_heads, num_k_heads, head_size, rot_dim, max_position, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
