// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Tensor-core helpers shared by K7 (varlen_attention.cu, in bf16 and f16)
// and K11 (mla_attention.cu), and the bf16 and f16 packing that the GEMM
// mainloop (quant_gemm_mainloop.cuh) uses.

#pragma once

#include "common.cuh"

namespace conch {

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_f16_16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// mma.sync m16n8k16 with f32 sums over operands of T (bf16 or f16).
template <typename T>
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                          uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same_v<T, __half>) mma_f16_16816(d, a0, a1, a2, a3, b0, b1);
  else mma_bf16_16816(d, a0, a1, a2, a3, b0, b1);
}

// Two floats rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The same into f16.
__device__ __forceinline__ uint32_t pack_f16x2(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ uint32_t pack_x2(float lo, float hi) {
  if constexpr (std::is_same_v<T, __half>) return pack_f16x2(lo, hi);
  else return pack_bf16x2(lo, hi);
}

// The two bf16 of a 32-bit word as floats (exact).
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// Four 8x8 b16 matrices from shared memory (lanes 8i .. 8i+7 give matrix
// i's row addresses), as mma.sync's fragments; .trans transposes each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(ptr)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(ptr)));
}

// Eight one-byte cache elements (int8 or e4m3) as eight bf16, exactly (both
// types fit bf16's 8-bit mantissa and its exponent range), without the
// conversion unit's slow path. int8: q + 128 in the low byte of 2^23 makes
// the float 2^23 + 128 + q, and one subtraction leaves q; its bf16 is the
// float's upper half (|q| <= 128 needs 8 significant bits). e4m3: pairs
// through f16 (which holds every e4m3 value) and f32 into bf16.
template <typename C>
__device__ __forceinline__ uint4 widen8_bf16(uint2 raw) {
  const uint32_t in[2] = {raw.x, raw.y};
  uint32_t out[4];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    if constexpr (std::is_same_v<C, int8_t>) {
      const uint32_t biased = in[w] ^ 0x80808080u;
      float f[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        f[k] = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 + k)) - 8388736.0f;  // 2^23 + 128
      }
      out[2 * w] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
      out[2 * w + 1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
    } else {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const auto pair = static_cast<__nv_fp8x2_storage_t>(in[w] >> (16 * k));
        const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(pair, __NV_E4M3);
        const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
        out[2 * w + k] = pack_bf16x2(f.x, f.y);
      }
    }
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// The same as eight f16, exactly (f16 holds every int8 and e4m3 value).
// int8: q + 128 in the low byte of f16's 1024 (0x6400) is 1024 + 128 + q,
// and one HSUB2 of 1152 leaves q. e4m3: the conversion unit's pairs.
template <typename C>
__device__ __forceinline__ uint4 widen8_f16(uint2 raw) {
  const uint32_t in[2] = {raw.x, raw.y};
  uint32_t out[4];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if constexpr (std::is_same_v<C, int8_t>) {
        const uint32_t biased = __byte_perm(in[w] ^ 0x80808080u, 0x64646464u, k == 0 ? 0x4140 : 0x4342);
        const __half2 v = __hsub2(*reinterpret_cast<const __half2*>(&biased), __float2half2_rn(1152.0f));
        out[2 * w + k] = *reinterpret_cast<const uint32_t*>(&v);
      } else {
        const auto pair = static_cast<__nv_fp8x2_storage_t>(in[w] >> (16 * k));
        const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(pair, __NV_E4M3);
        out[2 * w + k] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// Eight one-byte cache elements widened to T (bf16 or f16).
template <typename T, typename C>
__device__ __forceinline__ uint4 widen8(uint2 raw) {
  if constexpr (std::is_same_v<T, __half>) return widen8_f16<C>(raw);
  else return widen8_bf16<C>(raw);
}

}  // namespace conch
