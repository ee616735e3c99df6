// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Paged decode attention over the stacked KV pool (K3).
//
// Replaces conch_tpu/kernels/attention/paged_attention.py:_paged_allheads_kernel
// (and its per-head variant _paged_attention_kernel, which computes the
// same function). Bound on the H100: bytes. Each sequence's K and V rows
// are read once (2 * seq_len * KH * D elements); the arithmetic is about
// 2 * G multiply-adds per K or V element, a few operations per byte.
// Design: one block per (sequence, KV head), so each cached row is read
// once for the whole GQA group of G query heads; online softmax in f32
// (attention_common.cuh). The TPU kernel's chunked page DMAs become a
// loop over 64-token tiles inside the block. Idle rows (seq_len 0) write
// zeros. Softcap (> 0) caps the scaled logits; a sliding window (> 0)
// starts the walk at seq_len - window, the first key the query sees, so
// the pages before it are never read (the TPU kernel skips those chunks).
// Quantized caches (int8, e4m3) are read one byte an element and
// converted exactly to f32; `scale` carries scale * k_scale and v_scale
// multiplies the output, as the TPU kernel folds them (:114, :247). They
// halve the bytes of the K and V reads.

#include "attention_common.cuh"

namespace conch {

template <typename T, typename C, bool SOFTCAP>
__global__ void paged_decode_kernel(const T* __restrict__ query, T* __restrict__ out, const void* k_layer,
                                    const void* v_layer, const int32_t* __restrict__ block_table,
                                    const int32_t* __restrict__ seq_lens, int max_pages, int num_q_heads,
                                    int num_kv_heads, int page_size, int head_size, float scale, float softcap,
                                    int window, float v_scale) {
  const int b = blockIdx.x;
  const int kv_head = blockIdx.y;
  const int group = num_q_heads / num_kv_heads;
  const PagedKV kv{k_layer, v_layer, block_table + static_cast<int64_t>(b) * max_pages, num_kv_heads, page_size,
                   head_size};
  const int64_t row = (static_cast<int64_t>(b) * num_q_heads + kv_head * group) * head_size;
  const int seq_len = seq_lens[b];
  const int kv_start = window > 0 ? max(seq_len - window, 0) : 0;
  attend_group<T, C, SOFTCAP>(query + row, head_size, out + row, head_size, kv, kv_head, kv_start, seq_len, group,
                              scale, softcap, v_scale);
}

}  // namespace conch

extern "C" int conch_paged_attention(const void* query, void* out, const void* k_layer, const void* v_layer,
                                     const void* block_table, const void* seq_lens, int batch, int max_pages,
                                     int num_q_heads, int num_kv_heads, int page_size, int head_size, float scale,
                                     float softcap, int window, float v_scale, int dtype, int cache_dtype,
                                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  if (num_q_heads % num_kv_heads != 0 || num_q_heads / num_kv_heads > conch::kMaxGroup ||
      head_size > conch::kMaxHeadSize) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(batch, num_kv_heads);
  const bool known = conch::dispatch_act_cache(dtype, cache_dtype, [&](auto q_tag, auto c_tag) {
    using T = typename decltype(q_tag)::type;
    using C = typename decltype(c_tag)::type;
    auto kernel = softcap > 0.0f ? conch::paged_decode_kernel<T, C, true> : conch::paged_decode_kernel<T, C, false>;
    kernel<<<grid, conch::kAttnThreads, 0, s>>>(
        static_cast<const T*>(query), static_cast<T*>(out), k_layer, v_layer,
        static_cast<const int32_t*>(block_table), static_cast<const int32_t*>(seq_lens), max_pages, num_q_heads,
        num_kv_heads, page_size, head_size, scale, softcap, window, v_scale);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
