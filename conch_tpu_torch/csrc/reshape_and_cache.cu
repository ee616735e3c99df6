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
//
// Quantized caches (int8, e4m3) store what
// conch_tpu/kernels/cache/reshape_and_cache.py:_quantize_store stores,
// fused into the copy: x times the f32
// reciprocal of the scale, then for int8 round half to even (rintf) and
// clip to [-128, 127], for e4m3 clip to +-448 and convert by round to
// nearest even. The row then moves half the bytes of a bf16 one.

#include "common.cuh"

namespace conch {

__device__ __forceinline__ int8_t quantize_store(float x, TypeTag<int8_t>) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(x), -128.0f), 127.0f));
}

__device__ __forceinline__ __nv_fp8_e4m3 quantize_store(float x, TypeTag<__nv_fp8_e4m3>) {
  // Comparisons, not fminf/fmaxf, so that a NaN stays NaN as in the TPU package.
  const float v = x < -448.0f ? -448.0f : (x > 448.0f ? 448.0f : x);
  __nv_fp8_e4m3 out;
  out.__x = __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
  return out;
}

// T: the key/value type; C: the cache element type (T's own, bf16 under
// f32 keys, or a quantized type).
template <typename T, typename C>
__device__ __forceinline__ C store_value(T x, float inv_scale) {
  if constexpr (kQuantizedCache<C>) {
    return quantize_store(to_float(x) * inv_scale, TypeTag<C>{});
  } else if constexpr (std::is_same_v<T, C>) {
    return x;
  } else {
    return from_float<C>(to_float(x));
  }
}

template <typename T, typename C>
__global__ void stacked_write_kernel(const T* __restrict__ key, const T* __restrict__ value, C* __restrict__ k_cache,
                                     C* __restrict__ v_cache, const int32_t* __restrict__ slots,
                                     int64_t k_row_stride, int64_t v_row_stride, int64_t layer_offset,
                                     int num_kv_heads, int page_size, int head_size, float k_scale, float v_scale) {
  const int64_t t = blockIdx.x;
  const int slot = slots[t];
  if (slot < 0) return;
  const float inv_k = 1.0f / k_scale;  // the f32 reciprocal, as the TPU package takes it
  const float inv_v = 1.0f / v_scale;
  const int64_t page = slot / page_size;
  const int entry = slot - static_cast<int>(page) * page_size;
  const int width = num_kv_heads * head_size;
  for (int idx = threadIdx.x; idx < width; idx += blockDim.x) {
    const int h = idx / head_size;
    const int d = idx - h * head_size;
    const int64_t dst =
        layer_offset + ((page * num_kv_heads + h) * page_size + entry) * static_cast<int64_t>(head_size) + d;
    k_cache[dst] = store_value<T, C>(key[t * k_row_stride + idx], inv_k);
    v_cache[dst] = store_value<T, C>(value[t * v_row_stride + idx], inv_v);
  }
}

}  // namespace conch

// k_scale / v_scale are read for int8 and e4m3 caches only.
extern "C" int conch_reshape_and_cache_stacked(const void* key, const void* value, void* k_cache, void* v_cache,
                                               const void* slots, int num_tokens, int64_t k_row_stride,
                                               int64_t v_row_stride, int64_t layer_offset, int num_kv_heads,
                                               int page_size, int head_size, float k_scale, float v_scale,
                                               int dtype, int cache_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (num_tokens == 0) return static_cast<int>(cudaSuccess);
  const bool known = conch::dispatch_act_cache(dtype, cache_dtype, [&](auto t_tag, auto c_tag) {
    using T = typename decltype(t_tag)::type;
    using C = typename decltype(c_tag)::type;
    conch::stacked_write_kernel<T, C><<<num_tokens, 128, 0, s>>>(
        static_cast<const T*>(key), static_cast<const T*>(value), static_cast<C*>(k_cache), static_cast<C*>(v_cache),
        static_cast<const int32_t*>(slots), k_row_stride, v_row_stride, layer_offset, num_kv_heads, page_size,
        head_size, k_scale, v_scale);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
