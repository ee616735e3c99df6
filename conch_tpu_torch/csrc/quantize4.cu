// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Blockwise NF4 / FP4 encoder (K12q).
//
// Replaces conch_tpu/kernels/quantization/bitsandbytes/blockwise.py:
// _quantize4_kernel (launcher quantize_blockwise_launcher, "nf4" and
// "fp4"). For each block of `blocksize` elements of the flat input:
// absmax = max |x| in f32; recip = absmax > 0 ? 1 / absmax : 0 (an IEEE f32
// division: this file must not be built with fast math); scaled = x * recip;
// the NF4 code is the number of NF4 thresholds that scaled strictly
// exceeds, the FP4 code a sign bit (scaled < 0) plus the level-to-code
// table at the rank of |scaled| among the FP4 thresholds; two codes go in
// one byte, the even element in the high nibble. Bytes and absmax are bit
// for bit the TPU kernel's.
//
// Bound on the H100: bytes (the input read once, half a byte a code and
// 4 bytes a block written). One warp a block: each lane takes pairs of
// neighbouring elements (one 8- or 4-byte load), the warp reduces the
// absmax by shuffles, then encodes the pairs it still holds in registers
// (PPL pairs a lane, the least power of two that covers the block) and
// writes one byte a pair. A block above 2048 elements (4096, the largest
// bitsandbytes blocksize) does not fit in one warp's registers: the warp
// loops over it twice, once for the absmax and once, reading it again
// (from L1/L2), to encode. Inputs f32, bf16 or f16 (each exact in f32).

#include "common.cuh"

namespace conch {
namespace {

constexpr int kMaxPairsPerLane = 32;  // blocksize up to 2048, held in registers
constexpr int kMaxBlocksize = 4096;   // above 2048: quantize4_wide_kernel

// Midpoints of consecutive NF4 code values, as the f32 numbers the JAX
// package computes ((NF4_CODE[:-1] + NF4_CODE[1:]) / 2 in f32).
__device__ __forceinline__ int nf4_code(float v) {
  constexpr float kT[15] = {
      -0x1.b239bp-1f, -0x1.38a4ep-1f, -0x1.d709p-2f, -0x1.5bd4ecp-2f, -0x1.e079d8p-3f,
      -0x1.1a7178p-3f, -0x1.74f0e2p-5f, 0x1.45f5fep-5f, 0x1.ec90c4p-4f, 0x1.a0cfcp-3f,
      0x1.2b05a8p-2f, 0x1.8ea7f2p-2f, 0x1.00da08p-1f, 0x1.491b5ep-1f, 0x1.b913b4p-1f,
  };
  int code = 0;
#pragma unroll
  for (int i = 0; i < 15; ++i) code += v > kT[i];
  return code;
}

// FP4: sign bit 8 plus the 3-bit code of the magnitude's level.
__device__ __forceinline__ int fp4_code(float v) {
  constexpr float kT[7] = {0x1.555572p-9f, 0x1.6p-4f,     0x1.aaaaaap-3f, 0x1.2aaaaap-2f,
                           0x1.aaaaacp-2f, 0x1.2aaaacp-1f, 0x1.aaaaaap-1f};
  constexpr int kLevelToCode[8] = {0, 1, 6, 7, 4, 5, 2, 3};
  const float mag = fabsf(v);
  int level = 0;
#pragma unroll
  for (int i = 0; i < 7; ++i) level += mag > kT[i];
  int code = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) code = level == i ? kLevelToCode[i] : code;
  return (v < 0.0f ? 8 : 0) + code;
}

__device__ __forceinline__ void load_pair(const float* x, int64_t e, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(x + e);
  a = v.x, b = v.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* x, int64_t e, float& a, float& b) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(x + e);
  a = __uint_as_float(v << 16), b = __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ void load_pair(const __half* x, int64_t e, float& a, float& b) {
  const __half2 v = *reinterpret_cast<const __half2*>(x + e);
  a = __low2float(v), b = __high2float(v);
}

template <bool NF4>
__device__ __forceinline__ uint8_t encode_pair(float a, float b, float recip) {
  const float sa = __fmul_rn(a, recip);
  const float sb = __fmul_rn(b, recip);
  const int hi = NF4 ? nf4_code(sa) : fp4_code(sa);
  const int lo = NF4 ? nf4_code(sb) : fp4_code(sb);
  return static_cast<uint8_t>((hi << 4) | lo);
}

template <typename T, bool NF4, int PPL>
__global__ void __launch_bounds__(256) quantize4_kernel(const T* __restrict__ x, uint8_t* __restrict__ packed,
                                                        float* __restrict__ absmax, int64_t size, int blocksize,
                                                        int64_t num_blocks) {
  const int64_t block = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (block >= num_blocks) return;
  const int pairs = blocksize / 2;
  const int64_t start = block * blocksize;
  float va[PPL], vb[PPL];
  float am = 0.0f;
#pragma unroll
  for (int i = 0; i < PPL; ++i) {
    const int p = lane + 32 * i;
    const int64_t e = start + 2 * p;
    va[i] = vb[i] = 0.0f;
    if (p < pairs && e < size) load_pair(x, e, va[i], vb[i]);  // size is even: e < size covers e + 1
    am = fmaxf(am, fmaxf(fabsf(va[i]), fabsf(vb[i])));
  }
  am = warp_max(am);
  const float recip = am > 0.0f ? __frcp_rn(am) : 0.0f;
#pragma unroll
  for (int i = 0; i < PPL; ++i) {
    const int p = lane + 32 * i;
    const int64_t e = start + 2 * p;
    if (p < pairs && e < size) packed[e / 2] = encode_pair<NF4>(va[i], vb[i], recip);
  }
  if (lane == 0) absmax[block] = am;
}

// Blocks too large for registers: one pass for the absmax, a second one
// that reads the block again and encodes it.
template <typename T, bool NF4>
__global__ void __launch_bounds__(256) quantize4_wide_kernel(const T* __restrict__ x, uint8_t* __restrict__ packed,
                                                             float* __restrict__ absmax, int64_t size, int blocksize,
                                                             int64_t num_blocks) {
  const int64_t block = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (block >= num_blocks) return;
  const int64_t start = block * blocksize;
  const int64_t end = start + blocksize < size ? start + blocksize : size;  // size is even: pairs are whole
  float am = 0.0f;
  for (int64_t e = start + 2 * lane; e < end; e += 64) {
    float a, b;
    load_pair(x, e, a, b);
    am = fmaxf(am, fmaxf(fabsf(a), fabsf(b)));
  }
  am = warp_max(am);
  const float recip = am > 0.0f ? __frcp_rn(am) : 0.0f;
  for (int64_t e = start + 2 * lane; e < end; e += 64) {
    float a, b;
    load_pair(x, e, a, b);
    packed[e / 2] = encode_pair<NF4>(a, b, recip);
  }
  if (lane == 0) absmax[block] = am;
}

template <typename T, int PPL>
void launch_ppl(const void* x, void* packed, void* absmax, int64_t size, int blocksize, int nf4,
                cudaStream_t stream) {
  const int64_t num_blocks = (size + blocksize - 1) / blocksize;
  const dim3 grid(static_cast<unsigned>((num_blocks + 7) / 8));
  auto run = [&](auto kernel) {
    kernel<<<grid, 256, 0, stream>>>(static_cast<const T*>(x), static_cast<uint8_t*>(packed),
                                     static_cast<float*>(absmax), size, blocksize, num_blocks);
  };
  if (nf4) {
    run(quantize4_kernel<T, true, PPL>);
  } else {
    run(quantize4_kernel<T, false, PPL>);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* packed, void* absmax, int64_t size, int blocksize, int nf4,
                   cudaStream_t stream) {
  const int ppl = (blocksize / 2 + 31) / 32;
  if (ppl > kMaxPairsPerLane) {
    const int64_t num_blocks = (size + blocksize - 1) / blocksize;
    const dim3 grid(static_cast<unsigned>((num_blocks + 7) / 8));
    auto run = [&](auto kernel) {
      kernel<<<grid, 256, 0, stream>>>(static_cast<const T*>(x), static_cast<uint8_t*>(packed),
                                       static_cast<float*>(absmax), size, blocksize, num_blocks);
    };
    if (nf4) {
      run(quantize4_wide_kernel<T, true>);
    } else {
      run(quantize4_wide_kernel<T, false>);
    }
  } else if (ppl <= 1) {
    launch_ppl<T, 1>(x, packed, absmax, size, blocksize, nf4, stream);
  } else if (ppl <= 2) {
    launch_ppl<T, 2>(x, packed, absmax, size, blocksize, nf4, stream);
  } else if (ppl <= 4) {
    launch_ppl<T, 4>(x, packed, absmax, size, blocksize, nf4, stream);
  } else if (ppl <= 8) {
    launch_ppl<T, 8>(x, packed, absmax, size, blocksize, nf4, stream);
  } else if (ppl <= 16) {
    launch_ppl<T, 16>(x, packed, absmax, size, blocksize, nf4, stream);
  } else {
    launch_ppl<T, kMaxPairsPerLane>(x, packed, absmax, size, blocksize, nf4, stream);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace conch

// x: `size` contiguous f32 (dtype 0), bf16 (1) or f16 (2) values, size
// even and 8-byte (f32) or 4-byte (bf16, f16) aligned; packed: size / 2
// bytes; absmax: ceil(size / blocksize) f32. blocksize even and at most
// kMaxBlocksize.
extern "C" int conch_quantize4(const void* x, int dtype, void* packed, void* absmax, int64_t size, int blocksize,
                               int nf4, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (size == 0) return static_cast<int>(cudaSuccess);
  if (size % 2 != 0 || blocksize % 2 != 0 || blocksize <= 0 || blocksize > conch::kMaxBlocksize) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (dtype) {
    case conch::kFloat32: return static_cast<int>(conch::launch<float>(x, packed, absmax, size, blocksize, nf4, s));
    case conch::kBFloat16:
      return static_cast<int>(conch::launch<__nv_bfloat16>(x, packed, absmax, size, blocksize, nf4, s));
    case conch::kFloat16: return static_cast<int>(conch::launch<__half>(x, packed, absmax, size, blocksize, nf4, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
