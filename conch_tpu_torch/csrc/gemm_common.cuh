// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Tensor-core helpers shared by K8 (scaled_gemm.cu) and K11
// (mla_attention.cu), and the bf16 packing that K1b and K1c
// (quant_gemm_mainloop.cuh) use.
//
// K8 uses mma.sync with one warp per 16-row x 32-column output tile and
// the same two tricks as K1 (mixed_gemm_magic.cu):
//  - the k order inside one mma is free as long as A and B agree, so each
//    kernel maps the four k slots a thread holds (2t, 2t+1, 2t+8, 2t+9 for
//    bf16 m16n8k16; 4t..4t+3 and 16+4t..16+4t+3 for s8 m16n8k32) to the
//    logical rows its weight layout makes cheap to load;
//  - column c of n8 tile q is warp column 4c + q, so a thread's B values
//    for the four tiles are 4 neighbouring columns (one vector load) and
//    its outputs are the 8 neighbouring columns 8t .. 8t+7 of a row.

#pragma once

#include "common.cuh"

namespace conch {

constexpr int kTiles = 4;  // n8 tiles per warp: 32 columns

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8_16832(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The two bf16 of a 32-bit word as floats (exact).
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// Output element e (0..3) of n8 tile t for the thread with lane-in-group
// tig: row g + 8 * (e >> 1), warp column 8 * tig + 4 * (e & 1) + t.
__device__ __forceinline__ int out_col(int tig, int t, int e) { return 8 * tig + 4 * (e & 1) + t; }

// Adds the WARPS_K warps' accumulators of one 16*MT x 32 tile (each warp
// summed its share of K) in shared memory and writes the tile's rows below
// m through store(row, column, value); every thread of the block calls it.
template <int MT, int WARPS_K, typename Acc, typename Store>
__device__ __forceinline__ void reduce_and_store(const Acc (&acc)[MT][kTiles][4], int m, int m0, Store store) {
  __shared__ Acc red[WARPS_K][16 * MT][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[warp][16 * mi + g + 8 * (e >> 1)][out_col(tig, t, e)] = acc[mi][t][e];
  __syncthreads();
  for (int idx = threadIdx.x; idx < 16 * MT * 32; idx += blockDim.x) {
    const int r = idx >> 5;
    const int c = idx & 31;
    if (m0 + r >= m) continue;
    Acc sum = red[0][r][c];
#pragma unroll
    for (int w = 1; w < WARPS_K; ++w) sum += red[w][r][c];
    store(m0 + r, c, sum);
  }
}

}  // namespace conch
