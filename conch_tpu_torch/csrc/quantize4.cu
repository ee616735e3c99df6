// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Blockwise NF4 / FP4 encoder (K12q).
//
// Replaces conch_tpu/kernels/quantization/bitsandbytes/blockwise.py:
// _quantize4_kernel (launcher quantize_blockwise_launcher, "nf4" and
// "fp4"). For each block of `blocksize` elements of the flat input:
// absmax = max |x| in f32; recip = absmax > 0 ? 1 / absmax : 0 (an IEEE f32
// reciprocal: this file must not be built with fast math); scaled = x *
// recip; the NF4 code is the number of NF4 thresholds that scaled strictly
// exceeds, the FP4 code a sign bit (scaled < 0) plus the level-to-code
// table at the rank of |scaled| among the FP4 thresholds; two codes go in
// one byte, the even element in the high nibble. Bytes and absmax are bit
// for bit the TPU kernel's.
//
// Bound on the H100: bytes (the input read once, half a byte a code and
// 4 bytes a block written); at 2 bytes an element in and half a byte out,
// the arithmetic of a code must stay within a few instructions to keep
// pace. Design (the vector path: a power-of-two blocksize from 8 to 4096
// and a 16-byte aligned input):
//  - a thread takes chunks of 8 neighbouring elements (one 16-byte load of
//    bf16 or f16, two of f32), four chunks a thread (two at blocksize
//    4096), every load issued before any arithmetic; a chunk that crosses
//    the end of the input loads its elements one by one;
//  - a block's absmax is reduced over the B / 8 threads that hold it: by
//    shuffles up to 32 (at blocksize 64, 8 lanes a block and 4 blocks a
//    warp), then across the block's warps in shared memory up to 256
//    threads; at blocksize 4096 one CTA holds a block in registers (two
//    chunks a thread), so it is read once;
//  - each code by bisection of the sorted thresholds: 4 compares for NF4's
//    15, each threshold after the first read from the CTA's shared-memory
//    copy at the code so far, kept in bytes (the loads go to another pipe
//    than the compares and selects, which bound the encoder while selects
//    picked every threshold), and 3 for FP4's 7, each picked by selects;
//    both give the rank that counting gives (NaN included: it exceeds
//    nothing);
//  - 8 codes a thread go out as one 4-byte store.
// Other even blocksizes, and inputs only 4- or 8-byte aligned, take the
// scalar path in this file: a warp a block, elements loaded one by one,
// one pass for the absmax and one that reads the block again to encode.
// Inputs f32, bf16 or f16 (each exact in f32).

#include "gemm_common.cuh"

namespace conch {
namespace {

constexpr int kThreads = 256;
// Chunks of 8 elements a thread of the vector path takes: four independent
// ones below blocksize 4096, the two halves of one block at 4096.
template <int MODE>
inline constexpr int kRoundsOf = MODE == 2 ? 2 : 4;
constexpr int kMaxBlocksize = 4096;

constexpr uint32_t kFp4LevelToCode = 0x6acf88;  // 3 bits a level: codes 0, 1, 6, 7, 4, 5, 2, 3

// Midpoints of consecutive NF4 code values, as the f32 numbers the JAX
// package computes ((NF4_CODE[:-1] + NF4_CODE[1:]) / 2 in f32); each CTA
// copies them to shared memory.
__constant__ float kNf4[16] = {
    -0x1.b239bp-1f, -0x1.38a4ep-1f, -0x1.d709p-2f, -0x1.5bd4ecp-2f, -0x1.e079d8p-3f, -0x1.1a7178p-3f,
    -0x1.74f0e2p-5f, 0x1.45f5fep-5f, 0x1.ec90c4p-4f, 0x1.a0cfcp-3f, 0x1.2b05a8p-2f, 0x1.8ea7f2p-2f,
    0x1.00da08p-1f, 0x1.491b5ep-1f, 0x1.b913b4p-1f, 0.0f,
};

// The rank of v among the 15 NF4 thresholds by bisection: bit 3 from T7,
// then T[c + 3], T[c + 1] and T[c] of the code c so far, read from the
// CTA's copy `t_s` (shared-memory loads, off the compare-and-select
// pipe). The code is kept in bytes (4 c), the loads' own offsets.
__device__ __forceinline__ uint32_t nf4_code(float v, const float* t_s) {
  const char* tb = reinterpret_cast<const char*>(t_s);
  uint32_t c4 = v > kNf4[7] ? 32u : 0u;
  c4 += v > *reinterpret_cast<const float*>(tb + c4 + 12) ? 16u : 0u;
  c4 += v > *reinterpret_cast<const float*>(tb + c4 + 4) ? 8u : 0u;
  c4 += v > *reinterpret_cast<const float*>(tb + c4) ? 4u : 0u;
  return c4 >> 2;
}

// FP4: sign bit 8 plus the 3-bit code of the magnitude's level, the level
// the rank of |v| among the 7 FP4 thresholds.
__device__ __forceinline__ uint32_t fp4_code(float v) {
  constexpr float kFp4[7] = {0x1.555572p-9f, 0x1.6p-4f,      0x1.aaaaaap-3f, 0x1.2aaaaap-2f,
                             0x1.aaaaacp-2f, 0x1.2aaaacp-1f, 0x1.aaaaaap-1f};
  const float a = fabsf(v);
  const bool b2 = a > kFp4[3];
  const bool b1 = a > (b2 ? kFp4[5] : kFp4[1]);
  const bool b0 = a > (b2 ? (b1 ? kFp4[6] : kFp4[4]) : (b1 ? kFp4[2] : kFp4[0]));
  const uint32_t level =
      (static_cast<uint32_t>(b2) << 2) | (static_cast<uint32_t>(b1) << 1) | static_cast<uint32_t>(b0);
  return ((kFp4LevelToCode >> (3 * level)) & 7u) | (v < 0.0f ? 8u : 0u);
}

template <bool NF4>
__device__ __forceinline__ uint32_t encode_pair(float a, float b, float recip, const float* t_s) {
  const float sa = __fmul_rn(a, recip);
  const float sb = __fmul_rn(b, recip);
  return NF4 ? (nf4_code(sa, t_s) << 4) | nf4_code(sb, t_s) : (fp4_code(sa) << 4) | fp4_code(sb);
}

// The CTA's copy of the NF4 thresholds; visible after the next barrier.
__device__ __forceinline__ void load_thresholds(float* t_s) {
  if (threadIdx.x < 16) t_s[threadIdx.x] = kNf4[threadIdx.x];
}

// Eight elements from a 16-byte aligned address.
__device__ __forceinline__ void load8(const float* x, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(x);
  const float4 b = *reinterpret_cast<const float4*>(x + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* x, float (&v)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(x);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) v[2 * k] = bf16_lo(u[k]), v[2 * k + 1] = bf16_hi(u[k]);
}
__device__ __forceinline__ void load8(const __half* x, float (&v)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(x);
  const __half2* h = reinterpret_cast<const __half2*>(&w);
#pragma unroll
  for (int k = 0; k < 4; ++k) v[2 * k] = __low2float(h[k]), v[2 * k + 1] = __high2float(h[k]);
}

// The vector path. A CTA takes chunks base .. base + 256 R - 1 (8 elements
// each, R = kRounds), thread t chunks base + t, base + 256 + t, ...;
// `lanes` = blocksize / 8 = 2^shift threads hold a block. MODE 0: lanes
// <= 32 (shuffles), 1: 32 < lanes <= 256 (shuffles, then the block's warps
// in shared memory), 2: lanes 512 (the CTA's two rounds are one block).
template <typename T, bool NF4, int MODE>
__global__ void __launch_bounds__(kThreads) quantize4_vec_kernel(const T* __restrict__ x, uint8_t* __restrict__ packed,
                                                                 float* __restrict__ absmax, int64_t size, int shift) {
  constexpr int kRounds = kRoundsOf<MODE>;
  const int lanes = 1 << shift;
  __shared__ float red_s[kRounds][kThreads / 32];
  __shared__ float t_s[16];
  load_thresholds(t_s);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kRounds * kThreads;
  float v[kRounds][8], am[kRounds];
#pragma unroll
  for (int u = 0; u < kRounds; ++u) {
    const int64_t e = (base + u * kThreads + tid) * 8;
    if (e + 8 <= size) {
      load8(x + e, v[u]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[u][k] = e + k < size ? to_float(x[e + k]) : 0.0f;  // size is even
    }
  }
#pragma unroll
  for (int u = 0; u < kRounds; ++u) {
    am[u] = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) am[u] = fmaxf(am[u], fabsf(v[u][k]));
  }
  if constexpr (MODE == 0) {
#pragma unroll
    for (int u = 0; u < kRounds; ++u)
      for (int off = 1; off < lanes; off <<= 1) am[u] = fmaxf(am[u], __shfl_xor_sync(0xffffffffu, am[u], off));
    __syncthreads();  // the thresholds
  } else if constexpr (MODE == 1) {
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      const float w = warp_max(am[u]);
      if (lane == 0) red_s[u][warp] = w;
    }
    __syncthreads();
    const int per = lanes / 32;  // warps a block
    const int w0 = warp & ~(per - 1);
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      am[u] = 0.0f;
      for (int w = w0; w < w0 + per; ++w) am[u] = fmaxf(am[u], red_s[u][w]);
    }
  } else {
    const float w = warp_max(fmaxf(am[0], am[1]));
    if (lane == 0) red_s[0][warp] = w;
    __syncthreads();
    float all = 0.0f;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) all = fmaxf(all, red_s[0][k]);
#pragma unroll
    for (int u = 0; u < kRounds; ++u) am[u] = all;
  }
#pragma unroll
  for (int u = 0; u < kRounds; ++u) {
    const int64_t c = base + u * kThreads + tid;
    const int64_t e = c * 8;
    if (e >= size) continue;
    const float recip = am[u] > 0.0f ? __frcp_rn(am[u]) : 0.0f;
    if ((c & (lanes - 1)) == 0) absmax[c >> shift] = am[u];
    if (e + 8 <= size) {
      uint32_t word = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) word |= encode_pair<NF4>(v[u][2 * k], v[u][2 * k + 1], recip, t_s) << (8 * k);
      *reinterpret_cast<uint32_t*>(packed + 4 * c) = word;
    } else {
      for (int k = 0; k < 4 && e + 2 * k < size; ++k) {
        packed[4 * c + k] = static_cast<uint8_t>(encode_pair<NF4>(v[u][2 * k], v[u][2 * k + 1], recip, t_s));
      }
    }
  }
}

// The scalar path: a warp a block, its elements loaded one by one (any
// element-aligned input), one pass for the absmax and one that encodes.
template <typename T, bool NF4>
__global__ void __launch_bounds__(kThreads)
    quantize4_scalar_kernel(const T* __restrict__ x, uint8_t* __restrict__ packed, float* __restrict__ absmax,
                            int64_t size, int blocksize, int64_t num_blocks) {
  __shared__ float t_s[16];
  load_thresholds(t_s);
  __syncthreads();
  const int64_t block = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (block >= num_blocks) return;
  const int64_t start = block * blocksize;
  const int64_t end = start + blocksize < size ? start + blocksize : size;  // size is even: pairs are whole
  float am = 0.0f;
  for (int64_t e = start + 2 * lane; e < end; e += 64) {
    am = fmaxf(am, fmaxf(fabsf(to_float(x[e])), fabsf(to_float(x[e + 1]))));
  }
  am = warp_max(am);
  const float recip = am > 0.0f ? __frcp_rn(am) : 0.0f;
  for (int64_t e = start + 2 * lane; e < end; e += 64) {
    packed[e / 2] = static_cast<uint8_t>(encode_pair<NF4>(to_float(x[e]), to_float(x[e + 1]), recip, t_s));
  }
  if (lane == 0) absmax[block] = am;
}

template <typename T, bool NF4>
void launch_type(const T* x, uint8_t* packed, float* absmax, int64_t size, int blocksize, cudaStream_t stream) {
  const bool pow2 = blocksize >= 8 && (blocksize & (blocksize - 1)) == 0;
  if (!pow2 || reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    const int64_t num_blocks = (size + blocksize - 1) / blocksize;
    const dim3 grid(static_cast<unsigned>((num_blocks + kThreads / 32 - 1) / (kThreads / 32)));
    quantize4_scalar_kernel<T, NF4><<<grid, kThreads, 0, stream>>>(x, packed, absmax, size, blocksize, num_blocks);
    return;
  }
  const int lanes = blocksize / 8;
  const int shift = __builtin_ctz(static_cast<unsigned>(lanes));
  const int64_t chunks = (size + 7) / 8;
  auto run = [&](auto kernel, int rounds) {
    const dim3 grid(static_cast<unsigned>((chunks + rounds * kThreads - 1) / (rounds * kThreads)));
    kernel<<<grid, kThreads, 0, stream>>>(x, packed, absmax, size, shift);
  };
  if (lanes <= 32) {
    run(quantize4_vec_kernel<T, NF4, 0>, kRoundsOf<0>);
  } else if (lanes <= kThreads) {
    run(quantize4_vec_kernel<T, NF4, 1>, kRoundsOf<1>);
  } else {
    run(quantize4_vec_kernel<T, NF4, 2>, kRoundsOf<2>);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* packed, void* absmax, int64_t size, int blocksize, int nf4,
                   cudaStream_t stream) {
  auto args = [&](auto run) {
    run(static_cast<const T*>(x), static_cast<uint8_t*>(packed), static_cast<float*>(absmax), size, blocksize, stream);
  };
  if (nf4) {
    args(launch_type<T, true>);
  } else {
    args(launch_type<T, false>);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace conch

// x: `size` contiguous f32 (dtype 0), bf16 (1) or f16 (2) values, size
// even, aligned to its element; packed: size / 2 bytes (4-byte aligned);
// absmax: ceil(size / blocksize) f32. blocksize even and at most
// kMaxBlocksize.
extern "C" int conch_quantize4(const void* x, int dtype, void* packed, void* absmax, int64_t size, int blocksize,
                               int nf4, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (size == 0) return static_cast<int>(cudaSuccess);
  if (size % 2 != 0 || blocksize % 2 != 0 || blocksize <= 0 || blocksize > conch::kMaxBlocksize ||
      reinterpret_cast<uintptr_t>(packed) % 4 != 0) {
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
