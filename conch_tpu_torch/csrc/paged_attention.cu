// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Paged decode attention over the stacked KV pool (K3): the entry point and
// the bf16 queries' kernels. The design and the kernels are in
// paged_attention.cuh; f32 and f16 queries' kernels are compiled in
// paged_attention_f32.cu and paged_attention_f16.cu.

#include "paged_attention.cuh"

template cudaError_t conch::paged::launch_type<__nv_bfloat16>(const conch::paged::PagedParams&, int, int,
                                                              cudaStream_t);

// query and out (B, QH, D) in `dtype` (f32, bf16 or f16); the caches'
// layer (P, KH, ps, D) in `cache_dtype` (the query's, int8, e4m3, or bf16
// under f32 queries: common.cuh's dispatch_act_cache);
// block_table (B, max_pages) and seq_lens (B,) int32; ring_pages > 0 reads
// each row as a ring of its first ring_pages entries. split_len and splits
// from the wrapper's plan (paged_split_plan): splits of split_len visible
// tokens, 1 <= splits <= 256; with splits > 1, part_acc (splits, B, QH, D)
// and part_ml (splits, B, QH, 2) f32. copy_bytes: 16 or 4 when D times the
// cache element size and both layer pointers are multiples of it, else 0.
extern "C" int conch_paged_attention(const void* query, void* out, const void* k_layer, const void* v_layer,
                                     const void* block_table, const void* seq_lens, int batch, int max_pages,
                                     int num_q_heads, int num_kv_heads, int page_size, int head_size, float scale,
                                     float softcap, int window, int ring_pages, float v_scale, int dtype,
                                     int cache_dtype,
                                     int split_len, int splits, void* part_acc, void* part_ml, int copy_bytes,
                                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  if (num_q_heads % num_kv_heads != 0 || num_q_heads / num_kv_heads > conch::paged::kMaxGroup ||
      head_size > conch::paged::kMaxHeadSize || split_len < 1 || splits < 1 || splits > conch::paged::kMaxSplits ||
      (splits > 1 && (part_acc == nullptr || part_ml == nullptr)) ||
      (copy_bytes != 0 && copy_bytes != 4 && copy_bytes != 16) || ring_pages < 0 || ring_pages > max_pages ||
      (ring_pages > 0 && (window <= 0 || ring_pages * page_size < window))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  conch::paged::PagedParams p{};
  p.query = query;
  p.out = out;
  p.k_layer = k_layer;
  p.v_layer = v_layer;
  p.block_table = static_cast<const int32_t*>(block_table);
  p.seq_lens = static_cast<const int32_t*>(seq_lens);
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.batch = batch;
  p.max_pages = max_pages;
  p.num_q_heads = num_q_heads;
  p.num_kv_heads = num_kv_heads;
  p.page_size = page_size;
  p.head_size = head_size;
  p.scale = scale;
  p.softcap = softcap;
  p.v_scale = v_scale;
  p.window = window;
  p.ring_pages = ring_pages;
  p.split_len = split_len;
  p.splits = splits;
  p.copy_bytes = copy_bytes;
  using conch::paged::launch_type;
  switch (dtype) {
    case conch::kFloat32: return static_cast<int>(launch_type<float>(p, dtype, cache_dtype, s));
    case conch::kBFloat16: return static_cast<int>(launch_type<__nv_bfloat16>(p, dtype, cache_dtype, s));
    case conch::kFloat16: return static_cast<int>(launch_type<__half>(p, dtype, cache_dtype, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
