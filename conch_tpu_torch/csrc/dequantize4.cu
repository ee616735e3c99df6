// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Blockwise NF4 / FP4 decoder (K12d).
//
// Replaces conch_tpu/kernels/quantization/bitsandbytes/blockwise.py:
// _dequantize4_kernel (launcher dequantize_blockwise_launcher, "nf4" and
// "fp4"; at blocksizes above 512 the JAX package computes the same
// function in XLA). Byte i of the packed codes holds element 2i in its
// high nibble and element 2i + 1 in its low nibble (as K12q packs them);
// element e decodes to table[code] * absmax[e / blocksize] in f32, cast
// once to the output type (f32, bf16 or f16, round to nearest even). The
// NF4 table is the 16 NF4 values; the FP4 table is the 3-bit magnitude
// table for codes 0..7 and its negation for codes 8..15 (the JAX
// package's -1.0 * magnitude, exact). A lookup and one f32 product: the
// result is bit for bit the plain version's.
//
// Bound on the H100: bytes (half a byte a code and 4 bytes a block read,
// the output written: 2.25 bytes an element into bf16). The TPU kernel's
// one-hot matrix products for the nibble interleave and the absmax
// expansion exist only because Mosaic lacks lane shuffles; here each
// thread reads 4 packed bytes (one 32-bit load), decodes 8 elements from a
// 16-entry table in shared memory (a broadcast read, no bank conflicts),
// and writes them with 16-byte stores. The blocksize is a multiple of 8,
// so the 8 elements share one absmax. A grid-stride loop covers any size;
// the last 1 to 3 bytes (a size that is not a multiple of 8) are decoded
// one at a time.

#include "common.cuh"

namespace conch {
namespace {

constexpr int kThreads = 256;

// The f32 tables as hex literals, bit for bit the numpy float32 arrays of
// the port's (and the JAX package's) Python tables.
__constant__ float kNF4[16] = {
    -0x1p+0f,         -0x1.647362p-1f, -0x1.0cd66p-1f,  -0x1.94654p-2f,  -0x1.23449ap-2f, -0x1.7a6a7ep-3f,
    -0x1.74f0e2p-4f,  0x0p+0f,         0x1.45f5fep-4f,  0x1.4995c6p-3f,  0x1.f809bap-3f,  0x1.5a0674p-2f,
    0x1.c3497p-2f,    0x1.200f56p-1f,  0x1.722766p-1f,  0x1p+0f,
};
__constant__ float kFP4[16] = {
    0x0p+0f,   0x1.555556p-8f,  0x1.555554p-1f,  0x1p+0f,  0x1.55553ep-2f,  0x1p-1f,  0x1.5554fcp-3f,  0x1p-2f,
    -0x0p+0f,  -0x1.555556p-8f, -0x1.555554p-1f, -0x1p+0f, -0x1.55553ep-2f, -0x1p-1f, -0x1.5554fcp-3f, -0x1p-2f,
};

// 8 consecutive outputs at `out` (16-byte aligned for bf16 / f16, 32 for f32).
__device__ __forceinline__ void store8(float* out, const float (&v)[8]) {
  reinterpret_cast<float4*>(out)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(out)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* out, const float (&v)[8]) {
  __nv_bfloat162 p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void store8(__half* out, const float (&v)[8]) {
  __half2 p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(p);
}

template <typename T, bool NF4>
__global__ void __launch_bounds__(kThreads)
    dequantize4_kernel(const uint8_t* __restrict__ packed, const float* __restrict__ absmax, T* __restrict__ out,
                       int64_t num_bytes, int blocksize) {
  __shared__ float table[16];
  if (threadIdx.x < 16) table[threadIdx.x] = NF4 ? kNF4[threadIdx.x] : kFP4[threadIdx.x];
  __syncthreads();
  const int64_t words = num_bytes / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const uint32_t* words_in = reinterpret_cast<const uint32_t*>(packed);
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; w < words; w += stride) {
    const uint32_t v = __ldg(words_in + w);
    const float am = __ldg(absmax + (8 * w) / blocksize);
    float vals[8];
#pragma unroll
    for (int b = 0; b < 4; ++b) {  // little-endian: byte b of the word is packed byte 4w + b
      vals[2 * b] = table[(v >> (8 * b + 4)) & 0xF] * am;
      vals[2 * b + 1] = table[(v >> (8 * b)) & 0xF] * am;
    }
    store8(out + 8 * w, vals);
  }
  const int64_t tail = 4 * words + static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (tail < num_bytes) {
    const uint8_t byte = packed[tail];
    const float am = __ldg(absmax + (2 * tail) / blocksize);
    out[2 * tail] = from_float<T>(table[byte >> 4] * am);
    out[2 * tail + 1] = from_float<T>(table[byte & 0xF] * am);
  }
}

template <typename T>
void launch(const void* packed, const void* absmax, void* out, int64_t num_bytes, int blocksize, int nf4,
            int num_sms, cudaStream_t stream) {
  const int64_t words = num_bytes / 4;
  const int64_t needed = (words + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(num_sms) * 8;  // 8 blocks an SM, then the grid-stride loop
  const dim3 grid(static_cast<unsigned>(needed < 1 ? 1 : needed < cap ? needed : cap));
  auto run = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, stream>>>(static_cast<const uint8_t*>(packed), static_cast<const float*>(absmax),
                                          static_cast<T*>(out), num_bytes, blocksize);
  };
  if (nf4) {
    run(dequantize4_kernel<T, true>);
  } else {
    run(dequantize4_kernel<T, false>);
  }
}

}  // namespace
}  // namespace conch

// packed: num_bytes codes, 4-byte aligned; absmax: ceil(2 * num_bytes /
// blocksize) f32; out: 2 * num_bytes elements of dtype f32 (0), bf16 (1)
// or f16 (2), 32-byte aligned. blocksize a positive multiple of 8.
extern "C" int conch_dequantize4(const void* packed, const void* absmax, void* out, int dtype, int64_t num_bytes,
                                 int blocksize, int nf4, int num_sms, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (num_bytes == 0) return static_cast<int>(cudaSuccess);
  if (blocksize <= 0 || blocksize % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case conch::kFloat32: conch::launch<float>(packed, absmax, out, num_bytes, blocksize, nf4, num_sms, s); break;
    case conch::kBFloat16:
      conch::launch<__nv_bfloat16>(packed, absmax, out, num_bytes, blocksize, nf4, num_sms, s);
      break;
    case conch::kFloat16: conch::launch<__half>(packed, absmax, out, num_bytes, blocksize, nf4, num_sms, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
