// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Variable-length paged prefill attention (K7).
//
// Replaces conch_tpu/kernels/attention/varlen_attention.py:_varlen_dma_allheads_kernel
// (and its variants _varlen_dma_kernel and _varlen_attention_kernel,
// which compute the same function). Queries are packed by cu_seqlens_q;
// query j of sequence b sits at KV position seq_lens[b] - q_len[b] + j
// and, when causal, sees positions 0..itself.
// Bound on the H100: bytes. The function must read each sequence's K and
// V rows once; its arithmetic, 2 * q_len * G multiply-adds per cached
// element, is far below the card's ~295 operations per byte at the
// engine's chunk of 128 tokens.
// Design (simple first): one block per (query row, KV head) runs the
// decode block of attention_common.cuh over that row's causal prefix.
// Rows of one sequence reread the same pages, which L2 mostly serves;
// tiling several query rows per block to share each K/V load is the
// obvious next step. Rows past cu_seqlens_q[batch] (padding, slot -1)
// write zeros and read no cache; zero-length sequences own no rows.
// Softcap (> 0) caps the scaled logits. A sliding window (> 0) anchors at
// the row's own position q_pos, causal or not: the row sees keys from
// q_pos - window + 1, and its walk starts there. Quantized caches (int8,
// e4m3) convert exactly as they are read; `scale` carries scale * q_scale
// * k_scale and v_scale multiplies the output, as the TPU kernel folds
// them (:750-753).

#include "attention_common.cuh"

namespace conch {

template <typename T, typename C, bool SOFTCAP>
__global__ void varlen_prefill_kernel(const T* __restrict__ query, T* __restrict__ out, const void* k_layer,
                                      const void* v_layer, const int32_t* __restrict__ cu_seqlens_q,
                                      const int32_t* __restrict__ seq_lens, const int32_t* __restrict__ block_table,
                                      int batch, int max_pages, int num_q_heads, int num_kv_heads, int page_size,
                                      int head_size, float scale, float softcap, int window, int causal,
                                      float v_scale) {
  const int t = blockIdx.x;
  const int kv_head = blockIdx.y;
  const int group = num_q_heads / num_kv_heads;
  const int64_t row = (static_cast<int64_t>(t) * num_q_heads + kv_head * group) * head_size;

  // The sequence owning row t: the last b with cu_seqlens_q[b] <= t (and
  // a non-empty query range). Rows past the packed total are padding.
  int b = -1;
  if (t < cu_seqlens_q[batch]) {
    for (int i = 0; i < batch; ++i) {
      if (cu_seqlens_q[i] <= t && t < cu_seqlens_q[i + 1]) {
        b = i;
        break;
      }
    }
  }
  int kv_start = 0, kv_len = 0;
  const int32_t* bt_row = block_table;
  if (b >= 0) {
    const int q_len = cu_seqlens_q[b + 1] - cu_seqlens_q[b];
    const int q_pos = seq_lens[b] - q_len + (t - cu_seqlens_q[b]);
    kv_len = causal ? q_pos + 1 : seq_lens[b];
    if (window > 0) kv_start = max(q_pos - window + 1, 0);
    bt_row = block_table + static_cast<int64_t>(b) * max_pages;
  }
  const PagedKV kv{k_layer, v_layer, bt_row, num_kv_heads, page_size, head_size};
  attend_group<T, C, SOFTCAP>(query + row, head_size, out + row, head_size, kv, kv_head, kv_start, kv_len, group,
                              scale, softcap, v_scale);
}

}  // namespace conch

extern "C" int conch_varlen_attention(const void* query, void* out, const void* k_layer, const void* v_layer,
                                      const void* cu_seqlens_q, const void* seq_lens, const void* block_table,
                                      int total_q, int batch, int max_pages, int num_q_heads, int num_kv_heads,
                                      int page_size, int head_size, float scale, float softcap, int window,
                                      int causal, float v_scale, int dtype, int cache_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (total_q == 0) return static_cast<int>(cudaSuccess);
  if (num_q_heads % num_kv_heads != 0 || num_q_heads / num_kv_heads > conch::kMaxGroup ||
      head_size > conch::kMaxHeadSize) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(total_q, num_kv_heads);
  const bool known = conch::dispatch_act_cache(dtype, cache_dtype, [&](auto q_tag, auto c_tag) {
    using T = typename decltype(q_tag)::type;
    using C = typename decltype(c_tag)::type;
    auto kernel =
        softcap > 0.0f ? conch::varlen_prefill_kernel<T, C, true> : conch::varlen_prefill_kernel<T, C, false>;
    kernel<<<grid, conch::kAttnThreads, 0, s>>>(
        static_cast<const T*>(query), static_cast<T*>(out), k_layer, v_layer,
        static_cast<const int32_t*>(cu_seqlens_q), static_cast<const int32_t*>(seq_lens),
        static_cast<const int32_t*>(block_table), batch, max_pages, num_q_heads, num_kv_heads, page_size, head_size,
        scale, softcap, window, causal, v_scale);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
