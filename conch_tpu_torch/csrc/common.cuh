// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Shared device helpers for the hand-written Hopper kernels. Every entry
// point has a plain C interface (loaded with ctypes), launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError()
// so the Python wrapper can raise on a refused launch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace conch {

// dtype codes shared with conch_tpu_torch/kernels/common.py (STORAGE_CODES).
enum DType : int { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2, kInt8 = 3, kFloat8E4M3 = 4 };

// Exact conversions to f32 (int8 and e4m3 hold values that f32, and bf16,
// represent exactly; e4m3's NaN code 0x7F / 0xFF converts to NaN).
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

// The int8 and e4m3 KV-cache element types, quantized on store (K2).
template <typename C>
inline constexpr bool kQuantizedCache = std::is_same_v<C, int8_t> || std::is_same_v<C, __nv_fp8_e4m3>;

template <typename T>
struct TypeTag {
  using type = T;
};

// Calls launch(TypeTag<T>{}, TypeTag<C>{}) for the (activation, cache)
// dtype codes the KV kernels take: bf16 or f32 activations over bf16,
// int8 or e4m3 caches, and f32 activations over f32 caches. Returns false
// for any other pair.
template <typename Launch>
bool dispatch_act_cache(int act_dtype, int cache_dtype, Launch&& launch) {
  auto with_cache = [&](auto act_tag) {
    switch (cache_dtype) {
      case kBFloat16: launch(act_tag, TypeTag<__nv_bfloat16>{}); return true;
      case kInt8: launch(act_tag, TypeTag<int8_t>{}); return true;
      case kFloat8E4M3: launch(act_tag, TypeTag<__nv_fp8_e4m3>{}); return true;
      default: return false;
    }
  };
  if (act_dtype == kBFloat16) return with_cache(TypeTag<__nv_bfloat16>{});
  if (act_dtype == kFloat32) {
    if (cache_dtype == kFloat32) {
      launch(TypeTag<float>{}, TypeTag<float>{});
      return true;
    }
    return with_cache(TypeTag<float>{});
  }
  return false;
}

// Calls launch(TypeTag<O>{}) for the output dtype codes the GEMMs store
// (bf16, f32); returns false for any other.
template <typename Launch>
bool dispatch_out(int out_dtype, Launch&& launch) {
  switch (out_dtype) {
    case kBFloat16: launch(TypeTag<__nv_bfloat16>{}); return true;
    case kFloat32: launch(TypeTag<float>{}); return true;
    default: return false;
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <>
__device__ __forceinline__ __half from_float<__half>(float x) { return __float2half_rn(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) x += __shfl_xor_sync(0xffffffffu, x, offset);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, offset));
  return x;
}

}  // namespace conch
