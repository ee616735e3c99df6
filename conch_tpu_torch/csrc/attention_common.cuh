// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// One block's share of K7's f32-query kernel (varlen_attention.cu:
// varlen_rows_f32_kernel; bf16 queries take the tiled tensor-core kernel
// there): the G query heads of one GQA group, all at one query position,
// attend to the tokens kv_start..kv_len-1 of one KV head, found through the
// block table, walked by the one block alone. Online softmax over tiles of
// TILE tokens, f32 throughout.
//
//   1. the block resolves the tile's cache rows from the block table,
//      reading only entries in [kv_start, kv_len) (never the table's
//      padding, never a page wholly before a sliding window); under a
//      rolling-KV ring (ring_pages > 0) true page i is entry i % ring_pages;
//   2. one warp per token computes the G scores q_g . k (lanes split D),
//      times the scale, then softcap * tanh(s / softcap) when SOFTCAP (a
//      template flag, so the loop without softcap compiles as before it);
//   3. one warp per head rescales the running max and sum;
//   4. each thread owns D / NTHREADS output columns for all G heads and
//      accumulates p . V in registers;
//   5. the normalized f32 output is multiplied by v_scale before the cast.
//
// The cache element type C is a template parameter apart from the query
// type T: bf16 or f32 as the query, or an int8 / e4m3 cache quantized on
// store (K2). Its elements convert to f32 exactly as they are read; the
// dequantization scales fold into two scalars, as in the TPU kernels:
// the caller passes scale * q_scale * k_scale as `scale`, and v_scale
// multiplies the output. An e4m3 NaN code (0x7F, 0xFF) reads as NaN; the
// store never writes one (it clips to +-448).
//
// The caller turns causality and a sliding window into the range: every
// key in it is visible, so each tile holds at least one visible key, the
// running max is finite after the first tile, and no mask is needed.
// kv_start >= kv_len leaves the sum at 0 and writes zeros: no division by
// an empty softmax.

#pragma once

#include "common.cuh"

namespace conch {

constexpr int kAttnThreads = 128;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kAttnTile = 64;
constexpr int kMaxGroup = 8;
constexpr int kMaxHeadSize = 256;
constexpr int kMaxColsPerThread = kMaxHeadSize / kAttnThreads;

struct PagedKV {
  const void* k_layer;  // cache base advanced to the layer: (P, KH, ps, D)
  const void* v_layer;
  const int32_t* block_table_row;
  int num_kv_heads;
  int page_size;
  int head_size;
  int ring_pages;  // > 0: rolling KV, true page i at block-table entry i % ring_pages
};

template <typename T, typename C, bool SOFTCAP>
__device__ void attend_group(const T* __restrict__ q_rows, int64_t q_head_stride, T* __restrict__ out_rows,
                             int64_t out_head_stride, const PagedKV& kv, int kv_head, int kv_start, int kv_len,
                             int group, float scale, float softcap, float v_scale) {
  __shared__ float q_s[kMaxGroup * kMaxHeadSize];
  __shared__ float p_s[kMaxGroup * kAttnTile];
  __shared__ int64_t row_s[kAttnTile];
  __shared__ float m_s[kMaxGroup];
  __shared__ float l_s[kMaxGroup];
  __shared__ float alpha_s[kMaxGroup];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int d_size = kv.head_size;
  const C* k_layer = static_cast<const C*>(kv.k_layer);
  const C* v_layer = static_cast<const C*>(kv.v_layer);

  for (int i = tid; i < group * d_size; i += kAttnThreads) {
    const int g = i / d_size;
    q_s[i] = to_float(q_rows[g * q_head_stride + (i - g * d_size)]);
  }
  if (tid < group) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  float acc[kMaxGroup][kMaxColsPerThread];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
#pragma unroll
    for (int c = 0; c < kMaxColsPerThread; ++c) acc[g][c] = 0.0f;
  __syncthreads();

  for (int start = kv_start; start < kv_len; start += kAttnTile) {
    const int n = min(kAttnTile, kv_len - start);
    for (int j = tid; j < n; j += kAttnThreads) {
      const int pos = start + j;
      const int entry = pos / kv.page_size;
      const int64_t page = kv.block_table_row[kv.ring_pages > 0 ? entry % kv.ring_pages : entry];
      row_s[j] = ((page * kv.num_kv_heads + kv_head) * kv.page_size + pos % kv.page_size) *
                 static_cast<int64_t>(d_size);
    }
    __syncthreads();

    for (int j = warp; j < n; j += kAttnWarps) {
      const C* k_row = k_layer + row_s[j];
      float part[kMaxGroup];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) part[g] = 0.0f;
      for (int d = lane; d < d_size; d += 32) {
        const float kd = to_float(k_row[d]);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
          if (g < group) part[g] += q_s[g * d_size + d] * kd;
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group) {
          float s = warp_sum(part[g]) * scale;
          if constexpr (SOFTCAP) s = softcap * tanhf(s / softcap);
          if (lane == 0) p_s[g * kAttnTile + j] = s;
        }
      }
    }
    __syncthreads();

    for (int g = warp; g < group; g += kAttnWarps) {
      float mx = -INFINITY;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, p_s[g * kAttnTile + j]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int j = lane; j < n; j += 32) {
        const float p = __expf(p_s[g * kAttnTile + j] - m_new);
        p_s[g * kAttnTile + j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);  // exp(-inf) = 0 on the first tile
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < kMaxColsPerThread; ++c) {
      const int d = tid + c * kAttnThreads;
      if (d < d_size) {
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
          if (g < group) acc[g][c] *= alpha_s[g];
        for (int j = 0; j < n; ++j) {
          const float vd = to_float(v_layer[row_s[j] + d]);
#pragma unroll
          for (int g = 0; g < kMaxGroup; ++g)
            if (g < group) acc[g][c] += p_s[g * kAttnTile + j] * vd;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < kMaxColsPerThread; ++c) {
    const int d = tid + c * kAttnThreads;
    if (d < d_size) {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group) {
          const float l = l_s[g];
          out_rows[g * out_head_stride + d] = from_float<T>(l > 0.0f ? acc[g][c] / l * v_scale : 0.0f);
        }
      }
    }
  }
}

}  // namespace conch
