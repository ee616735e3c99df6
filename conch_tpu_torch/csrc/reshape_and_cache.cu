// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// In-place token insertion into the stacked (L, P, KH, ps, D) KV pool (K2).
//
// Replaces conch_tpu/kernels/cache/reshape_and_cache.py:_stacked_write_kernel.
// Token t's K and V rows go to cache[layer, slot // ps, :, slot % ps, :].
// The layer is a pointer offset computed by the wrapper, so one pool
// serves every layer with no copy. A negative slot (padding, idle decode
// row) writes nothing. Unlike the TPU kernel, which must read-modify-write
// an 8-entry window and so allows one token per window per call, each
// row store here is independent: any number of tokens may share a page.
//
// Quantized caches (int8, e4m3) store what
// conch_tpu/kernels/cache/reshape_and_cache.py:_quantize_store stores,
// fused into the copy: x times the f32 reciprocal of the scale, then for
// int8 round half to even (rintf) and clip to [-128, 127], for e4m3 clip
// to +-448 and convert by round to nearest even. The row then moves half
// the bytes of a bf16 one.
//
// Bound on the H100: bytes (each live token's K and V rows read once and
// written once, its slot read; no arithmetic). Llama-3-8B's decode step (8
// tokens, KH 8, D 128, bf16) moves 64 KB, 0.02 us at 3.35 TB/s: the
// launch and two dependent DRAM round trips (the slot, then the rows) set
// its time.
//
// Design (the launch plan is Python's: kernels/cache/reshape_and_cache.py:
// cache_write_plan, passed through the entry point). A row is one (token,
// KV head) half of K or of V: row r is token r / (2 KH), head (r / 2) % KH,
// V when r is odd. It belongs to threads_per_row threads (blockDim.x) and a
// block holds rows_per_block rows (blockDim.y), so a decode step of 8
// tokens spreads over 64 blocks. A thread reads its row's slot once (the
// lanes of a row read one address) and forms the row's source and
// destination once: no divide per element. Vector path: a thread moves
// chunks of V = 16 / sizeof(T) elements (8 bf16 or f16, 4 f32): one
// 16-byte load, and one store of V cache elements (16 bytes into a cache
// of T's type, 8 into bf16 under f32 keys or into a 1-byte cache of bf16
// or f16 keys, 4 into a 1-byte cache of f32 keys); a cache of T's type
// gets the raw bytes, so f16 keys into an f16 cache are copied bit for
// bit. The (key, cache) pairs are common.cuh's dispatch_act_cache's. The
// plan takes it only when every row start of k, v and the caches is
// 16-byte aligned and D is a multiple of V; else V = 1 (the scalar path).
// The kernel is launched as a programmatic dependent when pdl is set (K5,
// which writes k, comes before it): every load, the slot's too, comes
// after griddepcontrol.wait, and it lets the next kernel launch once it
// has its slot. An idle row returns after its slot's load.

#include "common.cuh"

namespace conch {
namespace {

struct CacheWriteParams {
  const void* key;
  const void* value;
  void* k_cache;
  void* v_cache;
  const int32_t* slots;
  int64_t k_row_stride;
  int64_t v_row_stride;
  int64_t layer_offset;
  int rows;  // 2 * tokens * num_kv_heads
  int num_kv_heads;
  int page_size;
  int head_size;
  float k_scale;
  float v_scale;
};

constexpr int kMaxThreads = 256;

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

// The cache element for f32 value x (T's own type is copied, not converted).
template <typename C>
__device__ __forceinline__ C store_value(float x, float inv_scale) {
  if constexpr (kQuantizedCache<C>) return quantize_store(x * inv_scale, TypeTag<C>{});
  else return from_float<C>(x);
}

// A cache element's bits (the types stored by conversion).
template <typename C>
using Bits = std::conditional_t<sizeof(C) == 1, uint8_t, uint16_t>;
__device__ __forceinline__ uint8_t bits_of(int8_t c) { return static_cast<uint8_t>(c); }
__device__ __forceinline__ uint8_t bits_of(__nv_fp8_e4m3 c) { return c.__x; }
__device__ __forceinline__ uint16_t bits_of(__nv_bfloat16 c) { return __bfloat16_as_ushort(c); }

// V cache elements stored at once (V * sizeof(C) bytes: 4, 8 or 16).
template <typename C, int V>
union Packed {
  using Raw = std::conditional_t<sizeof(C) * V == 16, uint4,
                                 std::conditional_t<sizeof(C) * V == 8, uint2, uint32_t>>;
  Raw raw;
  Bits<C> bits[V];
};

// Move one row's chunks: vector j (V elements) from src to dst.
template <typename T, typename C, int V>
__device__ __forceinline__ void copy_row(const T* src, C* dst, int chunks, float inv_scale) {
  for (int j = threadIdx.x; j < chunks; j += blockDim.x) {
    if constexpr (V == 1) {
      if constexpr (std::is_same_v<T, C>) dst[j] = src[j];
      else dst[j] = store_value<C>(to_float(src[j]), inv_scale);
    } else if constexpr (std::is_same_v<T, C>) {
      reinterpret_cast<uint4*>(dst)[j] = reinterpret_cast<const uint4*>(src)[j];
    } else {
      float f[V];
      unpack16<T>(reinterpret_cast<const uint4*>(src)[j], f);
      Packed<C, V> out;
#pragma unroll
      for (int e = 0; e < V; ++e) out.bits[e] = bits_of(store_value<C>(f[e], inv_scale));
      reinterpret_cast<typename Packed<C, V>::Raw*>(dst)[j] = out.raw;
    }
  }
}

template <typename T, typename C, int V>
__global__ void __launch_bounds__(kMaxThreads) cache_write_kernel(const __grid_constant__ CacheWriteParams p) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= p.rows) return;
  const int pair = row >> 1;
  const bool is_v = row & 1;
  const int t = pair / p.num_kv_heads;
  const int h = pair - t * p.num_kv_heads;
  griddep_wait();  // k, v and the slots may be the previous kernel's output
  const int slot = p.slots[t];
  if (slot < 0) return;
  const int page = slot / p.page_size;
  const int entry = slot - page * p.page_size;
  const T* src = static_cast<const T*>(is_v ? p.value : p.key) + t * (is_v ? p.v_row_stride : p.k_row_stride) +
                 static_cast<int64_t>(h) * p.head_size;
  C* dst = static_cast<C*>(is_v ? p.v_cache : p.k_cache) + p.layer_offset +
           ((static_cast<int64_t>(page) * p.num_kv_heads + h) * p.page_size + entry) * p.head_size;
  // The f32 reciprocal, as the TPU package takes it; read for 1-byte caches only.
  const float inv_scale = 1.0f / (is_v ? p.v_scale : p.k_scale);
  griddep_launch();
  copy_row<T, C, V>(src, dst, p.head_size / V, inv_scale);
}

template <typename T, typename C>
cudaError_t launch(const CacheWriteParams& p, int path, dim3 grid, dim3 block, bool pdl, cudaStream_t stream) {
  switch (path) {
    case 0: return launch_maybe_pdl(cache_write_kernel<T, C, kVec16<T>>, grid, block, stream, pdl, p);
    case 1: return launch_maybe_pdl(cache_write_kernel<T, C, 1>, grid, block, stream, pdl, p);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace conch

// key and value (T, KH, D) with row strides (each token's KH*D contiguous),
// caches (L, P, KH, ps, D) contiguous, slots (T,) int32; layer_offset =
// layer * P * KH * ps * D. k_scale / v_scale are read for int8 and e4m3
// caches only. The plan (cache_write_plan): path 0 vector, 1 scalar, block
// (threads_per_row, rows_per_block), grid_x blocks; pdl launches the kernel
// as a programmatic dependent.
extern "C" int conch_reshape_and_cache_stacked(const void* key, const void* value, void* k_cache, void* v_cache,
                                               const void* slots, int num_tokens, int64_t k_row_stride,
                                               int64_t v_row_stride, int64_t layer_offset, int num_kv_heads,
                                               int page_size, int head_size, float k_scale, float v_scale,
                                               int dtype, int cache_dtype, int path, int threads_per_row,
                                               int rows_per_block, int grid_x, int pdl, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (num_tokens == 0) return static_cast<int>(cudaSuccess);
  if (threads_per_row * rows_per_block > conch::kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const conch::CacheWriteParams p{key,          value,         k_cache,      v_cache,
                                  static_cast<const int32_t*>(slots), k_row_stride, v_row_stride, layer_offset,
                                  2 * num_tokens * num_kv_heads, num_kv_heads, page_size, head_size,
                                  k_scale,      v_scale};
  const dim3 grid(grid_x), block(threads_per_row, rows_per_block);
  cudaError_t status = cudaErrorInvalidValue;
  const bool known = conch::dispatch_act_cache(dtype, cache_dtype, [&](auto t_tag, auto c_tag) {
    using T = typename decltype(t_tag)::type;
    using C = typename decltype(c_tag)::type;
    status = conch::launch<T, C>(p, path, grid, block, pdl != 0, s);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  if (status != cudaSuccess) return static_cast<int>(status);
  return static_cast<int>(cudaGetLastError());
}
