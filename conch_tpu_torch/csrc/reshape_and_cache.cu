// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// In-place token insertion into the stacked (L, P, KH, ps, D) KV pool (K2).
//
// Replaces conch_tpu/kernels/cache/reshape_and_cache.py:_stacked_write_kernel.
// Bound on the H100: bytes (each token's K and V row is read once and
// written once; no arithmetic). Design: one block per token; the block
// copies its KH*D values into cache[layer, slot // ps, :, slot % ps, :].
// The layer is a pointer offset computed by the wrapper, so one pool
// serves every layer with no copy. A negative slot (padding, idle decode
// row) writes nothing. Unlike the TPU kernel, which must read-modify-write
// an 8-entry window and so allows one token per window per call, each
// row store here is independent: any number of tokens may share a page.

#include "common.cuh"

namespace conch {

template <typename T>
__global__ void stacked_write_kernel(const T* __restrict__ key, const T* __restrict__ value, T* __restrict__ k_cache,
                                     T* __restrict__ v_cache, const int32_t* __restrict__ slots,
                                     int64_t k_row_stride, int64_t v_row_stride, int64_t layer_offset,
                                     int num_kv_heads, int page_size, int head_size) {
  const int64_t t = blockIdx.x;
  const int slot = slots[t];
  if (slot < 0) return;
  const int64_t page = slot / page_size;
  const int entry = slot - static_cast<int>(page) * page_size;
  const int width = num_kv_heads * head_size;
  for (int idx = threadIdx.x; idx < width; idx += blockDim.x) {
    const int h = idx / head_size;
    const int d = idx - h * head_size;
    const int64_t dst =
        layer_offset + ((page * num_kv_heads + h) * page_size + entry) * static_cast<int64_t>(head_size) + d;
    k_cache[dst] = key[t * k_row_stride + idx];
    v_cache[dst] = value[t * v_row_stride + idx];
  }
}

template <typename T>
void launch_stacked_write(const void* key, const void* value, void* k_cache, void* v_cache, const void* slots,
                          int num_tokens, int64_t k_row_stride, int64_t v_row_stride, int64_t layer_offset,
                          int num_kv_heads, int page_size, int head_size, cudaStream_t stream) {
  stacked_write_kernel<T><<<num_tokens, 128, 0, stream>>>(
      static_cast<const T*>(key), static_cast<const T*>(value), static_cast<T*>(k_cache), static_cast<T*>(v_cache),
      static_cast<const int32_t*>(slots), k_row_stride, v_row_stride, layer_offset, num_kv_heads, page_size,
      head_size);
}

}  // namespace conch

extern "C" int conch_reshape_and_cache_stacked(const void* key, const void* value, void* k_cache, void* v_cache,
                                               const void* slots, int num_tokens, int64_t k_row_stride,
                                               int64_t v_row_stride, int64_t layer_offset, int num_kv_heads,
                                               int page_size, int head_size, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (num_tokens == 0) return static_cast<int>(cudaSuccess);
  if (dtype == conch::kBFloat16) {
    conch::launch_stacked_write<__nv_bfloat16>(key, value, k_cache, v_cache, slots, num_tokens, k_row_stride,
                                               v_row_stride, layer_offset, num_kv_heads, page_size, head_size, s);
  } else if (dtype == conch::kFloat32) {
    conch::launch_stacked_write<float>(key, value, k_cache, v_cache, slots, num_tokens, k_row_stride, v_row_stride,
                                       layer_offset, num_kv_heads, page_size, head_size, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
