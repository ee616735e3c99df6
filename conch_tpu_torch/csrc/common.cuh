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
#include <utility>

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
// int8 or e4m3 caches, f32 activations over f32 caches, and f16
// activations over f16, int8 or e4m3 caches. Returns false for any other
// pair (kernels/common.py: KV_DTYPE_PAIRS).
template <typename Launch>
bool dispatch_act_cache(int act_dtype, int cache_dtype, Launch&& launch) {
  // The 1-byte caches, or the 16-bit one of wide_tag's type (code `wide`).
  auto with_cache = [&](auto act_tag, auto wide_tag, int wide) {
    switch (cache_dtype) {
      case kInt8: launch(act_tag, TypeTag<int8_t>{}); return true;
      case kFloat8E4M3: launch(act_tag, TypeTag<__nv_fp8_e4m3>{}); return true;
      default:
        if (cache_dtype != wide) return false;
        launch(act_tag, wide_tag);
        return true;
    }
  };
  switch (act_dtype) {
    case kBFloat16: return with_cache(TypeTag<__nv_bfloat16>{}, TypeTag<__nv_bfloat16>{}, kBFloat16);
    case kFloat16: return with_cache(TypeTag<__half>{}, TypeTag<__half>{}, kFloat16);
    case kFloat32:
      if (cache_dtype == kFloat32) {
        launch(TypeTag<float>{}, TypeTag<float>{});
        return true;
      }
      return with_cache(TypeTag<float>{}, TypeTag<__nv_bfloat16>{}, kBFloat16);
    default: return false;
  }
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

// 16 bytes of T (8 bf16 or f16, 4 f32) widened to f32 and back; the
// narrowing rounds each value to nearest even, as from_float does.
template <typename T>
inline constexpr int kVec16 = 16 / static_cast<int>(sizeof(T));

template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw, float (&f)[kVec16<T>]) {
  if constexpr (std::is_same_v<T, float>) {
    f[0] = __uint_as_float(raw.x), f[1] = __uint_as_float(raw.y);
    f[2] = __uint_as_float(raw.z), f[3] = __uint_as_float(raw.w);
  } else {
    using T2 = std::conditional_t<std::is_same_v<T, __half>, __half2, __nv_bfloat162>;
    const T2* h = reinterpret_cast<const T2*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 v;
      if constexpr (std::is_same_v<T, __half>) v = __half22float2(h[i]);
      else v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x, f[2 * i + 1] = v.y;
    }
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack16(const float (&f)[kVec16<T>]) {
  uint4 raw;
  if constexpr (std::is_same_v<T, float>) {
    raw = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]), __float_as_uint(f[3]));
  } else {
    using T2 = std::conditional_t<std::is_same_v<T, __half>, __half2, __nv_bfloat162>;
    T2* h = reinterpret_cast<T2*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (std::is_same_v<T, __half>) h[i] = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
      else h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    }
  }
  return raw;
}

// Programmatic dependent launch (a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization): griddep_wait()
// returns once the kernel before it in the stream has finished and its
// stores are visible (at once without the attribute); griddep_launch()
// lets the next such kernel start launching.
__device__ __forceinline__ void griddep_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }
__device__ __forceinline__ void griddep_launch() { asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory"); }

// cudaLaunchKernelEx of kernel<<<grid, block, 0, stream>>>(args...), as a
// programmatic dependent of the kernel before it when pdl is set.
template <typename... Params, typename... Args>
cudaError_t launch_maybe_pdl(void (*kernel)(Params...), dim3 grid, dim3 block, cudaStream_t stream, bool pdl,
                             Args&&... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = block;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = pdl ? 1 : 0;
  return cudaLaunchKernelEx(&config, kernel, std::forward<Args>(args)...);
}

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
