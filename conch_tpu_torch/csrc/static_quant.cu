// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Static-scale quantization to int8 or e4m3 (K9).
//
// Replaces conch_tpu/kernels/quantization/int8.py:_static_scaled_int8_quant_kernel
// and conch_tpu/kernels/quantization/fp8.py:_static_scaled_fp8_quant_kernel
// (with the e4m3 cast that follows that kernel). Both compute, for every
// element of a (tokens, hidden) f32, bf16 or f16 tensor, y = x * (1 /
// scale[0]), the reciprocal taken in f32 from the one-element f32 scale on
// the card, then
//   int8: clip to [-128, 127] and truncate toward zero (torch's .to(int8),
//         not a rounding; the KV store K2 rounds);
//   e4m3: clip to +-448 and convert by round to nearest even.
// Bound on the H100: bytes (one read of the input, one byte written per
// element, a multiply and a clip between). Design: a flat grid-stride loop
// over the elements, each thread taking 8 neighbours per step when the
// element count allows one 16-byte (f32: two) load, so loads and stores
// are wide and coalesced; any hidden size works, the TPU kernel's padding
// to 128 lanes is not needed.

#include <algorithm>

#include "common.cuh"

namespace conch {

constexpr int kQuantThreads = 256;
constexpr int kQuantVec = 8;

__device__ __forceinline__ int8_t quantize_static(float x, TypeTag<int8_t>) {
  // Comparisons keep a NaN; the cast truncates toward zero.
  const float v = x < -128.0f ? -128.0f : (x > 127.0f ? 127.0f : x);
  return static_cast<int8_t>(v);
}

__device__ __forceinline__ __nv_fp8_e4m3 quantize_static(float x, TypeTag<__nv_fp8_e4m3>) {
  const float v = x < -448.0f ? -448.0f : (x > 448.0f ? 448.0f : x);
  __nv_fp8_e4m3 out;
  out.__x = __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
  return out;
}

template <typename T, typename Q>
__global__ void __launch_bounds__(kQuantThreads) static_quant_kernel(const T* __restrict__ x, Q* __restrict__ out,
                                                                     const float* __restrict__ scale, int64_t n) {
  const float inv = 1.0f / scale[0];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kQuantThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kQuantThreads + threadIdx.x;
  const int64_t vecs = n / kQuantVec;
  for (int64_t v = first; v < vecs; v += stride) {
    alignas(16) T in[kQuantVec];
    alignas(8) Q q[kQuantVec];
    // 8 elements: 16 bytes of bf16/f16, 32 of f32 (two 16-byte loads); 8 bytes out.
#pragma unroll
    for (int w = 0; w < static_cast<int>(sizeof(T)) * kQuantVec / 16; ++w)
      reinterpret_cast<uint4*>(in)[w] = reinterpret_cast<const uint4*>(x + v * kQuantVec)[w];
#pragma unroll
    for (int i = 0; i < kQuantVec; ++i) q[i] = quantize_static(to_float(in[i]) * inv, TypeTag<Q>{});
    *reinterpret_cast<uint2*>(out + v * kQuantVec) = *reinterpret_cast<const uint2*>(q);
  }
  for (int64_t i = vecs * kQuantVec + first; i < n; i += stride) {
    out[i] = quantize_static(to_float(x[i]) * inv, TypeTag<Q>{});
  }
}

template <typename T, typename Q>
void launch_static_quant(const void* x, void* out, const void* scale, int64_t n, int sms, cudaStream_t stream) {
  const int64_t vec_blocks = (n / kQuantVec + kQuantThreads - 1) / kQuantThreads;
  const int blocks = static_cast<int>(std::max<int64_t>(1, std::min<int64_t>(vec_blocks, 8LL * sms)));
  static_quant_kernel<T, Q><<<blocks, kQuantThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<Q*>(out), static_cast<const float*>(scale), n);
}

template <typename Q>
bool dispatch_input(int dtype, const void* x, void* out, const void* scale, int64_t n, int sms, cudaStream_t s) {
  switch (dtype) {
    case kFloat32: launch_static_quant<float, Q>(x, out, scale, n, sms, s); return true;
    case kBFloat16: launch_static_quant<__nv_bfloat16, Q>(x, out, scale, n, sms, s); return true;
    case kFloat16: launch_static_quant<__half, Q>(x, out, scale, n, sms, s); return true;
    default: return false;
  }
}

}  // namespace conch

// x: n contiguous f32 / bf16 / f16 elements, 16-byte aligned; out: n
// int8 or e4m3 elements, 8-byte aligned; scale: one f32 on the card.
extern "C" int conch_static_scaled_quant(const void* x, void* out, const void* scale, int64_t n, int dtype,
                                         int out_dtype, int sms, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (n == 0) return static_cast<int>(cudaSuccess);
  bool known = false;
  if (out_dtype == conch::kInt8) known = conch::dispatch_input<int8_t>(dtype, x, out, scale, n, sms, s);
  if (out_dtype == conch::kFloat8E4M3) known = conch::dispatch_input<__nv_fp8_e4m3>(dtype, x, out, scale, n, sms, s);
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
