// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Paged decode attention over the stacked KV pool (K3), split over the KV
// walk.
//
// Replaces conch_tpu/kernels/attention/paged_attention.py:_paged_allheads_kernel
// (and its per-head variant _paged_attention_kernel, which computes the
// same function). Bound on the H100: bytes. Each sequence's visible K and
// V rows are read once (2 * visible * KH * D elements); the arithmetic is
// about 2 * G multiply-adds per K or V element, a few operations per byte.
//
// Design. A decode step has one query token per sequence, so one block per
// (sequence, KV head) fills 64 of 132 SMs at Llama-3-8B's batch 8 and
// walks up to thousands of tokens alone. Here the grid is (sequence, KV
// head, split): split z walks the visible tokens kv_start + z * split_len
// .. + split_len - 1 (kv_start = seq_len - window with a sliding window,
// else 0), so a split that starts past seq_len exits at once and no split
// lies before the window; the pages before it are never read. The split
// count and length come from shapes only (kernels/attention/
// paged_attention.py: paged_split_plan), never from seq_lens' values, so
// the wrapper never syncs. A block of 256 threads:
//  - stages tiles of 32 tokens of K and V (each token's row of the KV head
//    is D contiguous elements in the (P, KH, ps, D) pool, found through
//    the block table) into a ring of 3 stages in shared memory with
//    cp.async, 16 bytes a thread, two tiles in flight while one is used;
//    one barrier a tile;
//  - each warp takes 4 tokens of the tile with an online softmax of its
//    own (no barrier between its steps): the G query heads' scores, lanes
//    splitting D (q in registers), in f32: q . k times `scale`, then
//    softcap * tanh(s / softcap) when SOFTCAP (a template flag); the
//    rescale of its running max and sum; p . V in f32 registers, each lane
//    the same columns d = lane + 32 c. G is a template parameter (1, 2, 4
//    or 8, the smallest that holds the group);
//  - at the end the block merges its 8 warps in shared memory, in warp
//    order.
// Tried on the card and dropped (PERF.md, tools/k3_split_sweep.py,
// tools/parent_compare.py): one block-wide online softmax a tile (three
// barriers a tile, one warp a token: 1.5x to 2.7x slower), 4 stages,
// 64-token tiles, 128 threads, and the warp's 4 x G scores summed by one
// reduce-scatter and broadcast back (fewer shuffles, more registers:
// faster at the served Llama step, 5% slower elsewhere).
// With one split the block writes the normalized output, times v_scale.
// Otherwise it writes its unnormalized accumulator and (max, sum) to an
// f32 workspace, and a second kernel, launched as a programmatic dependent
// (its launch overlaps this grid's end), merges the live splits by
// log-sum-exp in a fixed order and rounds once: two calls on the same
// inputs give the same bits. The merge finds the live splits from seq_len
// with the same formula, so a split that exited is never read. Idle rows
// (seq_len 0) write exact zeros. The query and output type T (f32, bf16
// or f16) is a template parameter: queries, staged 16-bit tiles and
// partial sums are read as f32, and only the final store rounds to T.
// Quantized caches (int8, e4m3) are staged
// as bytes and converted exactly to f32 as they are read; `scale` carries
// scale * k_scale and v_scale multiplies the output, as the TPU kernel
// folds them (:114, :247); they halve the bytes of the K and V reads.
// Rolling KV (ring_pages > 0, a run-time argument): each block-table row is
// a ring of ring_pages entries, and true page i of a sequence is entry
// i % ring_pages, as the TPU kernel's jax.lax.rem (:127-130, :309-311). The
// walk already starts at the window (visible_start), so the split count
// comes from the window and never from the ring or the table's width; a
// tile takes one integer remainder, and its rows step from that entry and
// wrap at the ring by a compare.
//
// The kernels and their launch templates live here; each query type's
// instantiations are compiled in a source of its own (paged_attention.cu:
// bf16 and the entry point; paged_attention_f32.cu; paged_attention_f16.cu),
// so that the three build in parallel: in one source they took 93 s, the
// build's slowest by 50 s.

#pragma once

#include <climits>

#include "common.cuh"

namespace conch {
namespace paged {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                      // tokens a stage
constexpr int kWarpTokens = kTile / kWarps;    // tokens of a stage a warp takes
constexpr int kStages = 3;                     // the ring: tiles i + 1, i + 2 in flight while tile i is used
constexpr int kMaxGroup = 8;
constexpr int kMaxHeadSize = 256;
constexpr int kLaneCols = kMaxHeadSize / 32;   // columns d = lane + 32 c a lane owns
constexpr int kMaxSplits = 256;
constexpr int kMergeThreads = 128;

struct PagedParams {
  const void* query;  // (B, QH, D) T
  void* out;          // (B, QH, D) T
  const void* k_layer;  // one layer of the pool: (P, KH, ps, D) C
  const void* v_layer;
  const int32_t* block_table;  // (B, max_pages)
  const int32_t* seq_lens;     // (B,)
  float* part_acc;  // (splits, B, QH, D) f32, splits > 1
  float* part_ml;   // (splits, B, QH, 2) f32: running max, softmax sum
  int batch, max_pages, num_q_heads, num_kv_heads, page_size, head_size;
  float scale, softcap, v_scale;
  int window;
  int ring_pages;  // > 0: rolling KV, true page i at block-table entry i % ring_pages
  int split_len, splits;
  int copy_bytes;  // 16 or 4: cp.async size of the row copies; 0: element by element
};

// The first key a decode query sees.
__device__ __forceinline__ int visible_start(const PagedParams& p, int seq_len) {
  const int window = p.window;
  const int kv_start = window > 0 ? max(seq_len - window, 0) : 0;
  return kv_start;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// Copies the K and V rows of tokens pos0 .. pos0 + n - 1 of KV head kvh
// into k_dst, v_dst (n rows of D), in chunks of p.copy_bytes.
template <typename C>
__device__ void stage_tile(const PagedParams& p, C* k_dst, C* v_dst, const int32_t* bt_row, int kvh, int pos0,
                           int n) {
  const C* k_layer = static_cast<const C*>(p.k_layer);
  const C* v_layer = static_cast<const C*>(p.v_layer);
  const int d_size = p.head_size;
  // The tile's first table entry, one remainder a tile under a ring; row r
  // steps from it and wraps at the ring by a compare.
  const int first = pos0 / p.page_size;
  const int entry0 = p.ring_pages > 0 ? first % p.ring_pages : first;
  const int wrap = p.ring_pages > 0 ? p.ring_pages : INT_MAX;
  const int in_page0 = pos0 - first * p.page_size;
  auto row_of = [&](int r) {
    const int t = in_page0 + r;
    const int step = t / p.page_size;
    int entry = entry0 + step;
    if (entry >= wrap) entry -= wrap;  // once: the ring covers the window, so a tile spans at most the ring
    const int64_t page = bt_row[entry];
    return ((page * p.num_kv_heads + kvh) * p.page_size + (t - step * p.page_size)) * static_cast<int64_t>(d_size);
  };
  if (p.copy_bytes == 0) {
    for (int i = threadIdx.x; i < n * d_size; i += kThreads) {
      const int r = i / d_size;
      const int64_t src = row_of(r) + (i - r * d_size);
      k_dst[i] = k_layer[src];
      v_dst[i] = v_layer[src];
    }
    return;
  }
  const int per_row = d_size * static_cast<int>(sizeof(C)) / p.copy_bytes;
  for (int i = threadIdx.x; i < n * per_row; i += kThreads) {
    const int r = i / per_row;
    const int off = (i - r * per_row) * p.copy_bytes;
    const int64_t src = row_of(r);
    cp_async(reinterpret_cast<uint8_t*>(k_dst + r * d_size) + off, reinterpret_cast<const uint8_t*>(k_layer + src) + off,
             p.copy_bytes);
    cp_async(reinterpret_cast<uint8_t*>(v_dst + r * d_size) + off, reinterpret_cast<const uint8_t*>(v_layer + src) + off,
             p.copy_bytes);
  }
}

// Shared memory of a split block: the ring of K and V tiles, then, once
// the walk is done, each warp's (acc, max, sum) for the block's merge.
__host__ __device__ constexpr int64_t split_smem_bytes(int head_size, int elem_bytes, int group) {
  const int64_t ring = 2LL * kStages * kTile * head_size * elem_bytes;
  const int64_t warps = 4LL * kWarps * group * (head_size + 2);
  return ring > warps ? ring : warps;
}

template <typename T, typename C, int G, bool SOFTCAP>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(const __grid_constant__ PagedParams p) {
  __shared__ float wgt_s[kWarps][G];  // each warp's weight in the block's merge
  __shared__ float m_s[G], l_s[G];    // the block's max and softmax sum
  extern __shared__ __align__(16) uint8_t smem[];

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int group = p.num_q_heads / p.num_kv_heads;  // <= G
  const int d_size = p.head_size;
  const int seq_len = p.seq_lens[b];
  const int start = visible_start(p, seq_len) + split * p.split_len;
  const int end = min(start + p.split_len, seq_len);
  const int64_t head0 = static_cast<int64_t>(b) * p.num_q_heads + kvh * group;  // the group's first query head
  T* out = static_cast<T*>(p.out);
  if (start >= end) {
    // Nothing visible. With one split this is an idle row: exact zeros (the
    // merge writes them otherwise).
    if (p.splits == 1) {
      for (int i = tid; i < group * d_size; i += kThreads) out[head0 * d_size + i] = from_float<T>(0.0f);
    }
    return;
  }
  const int32_t* bt_row = p.block_table + static_cast<int64_t>(b) * p.max_pages;
  C* k_ring = reinterpret_cast<C*>(smem);
  C* v_ring = k_ring + kStages * kTile * d_size;
  const int tiles = (end - start + kTile - 1) / kTile;
  auto issue = [&](int i) {
    if (i < tiles) {
      const int s = i % kStages;
      stage_tile<C>(p, k_ring + s * kTile * d_size, v_ring + s * kTile * d_size, bt_row, kvh, start + i * kTile,
                    min(kTile, end - start - i * kTile));
    }
    cp_async_commit();  // an empty group past the last tile keeps the counts aligned
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  // Lane `lane` holds q[g][lane + 32 c] as f32, and its warp's running
  // max, sum and p . V for the same columns.
  const T* query = static_cast<const T*>(p.query);
  float q[G][kLaneCols], acc[G][kLaneCols], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) {
      const int d = lane + 32 * c;
      q[g][c] = g < group && d < d_size ? to_float(query[(head0 + g) * d_size + d]) : 0.0f;
      acc[g][c] = 0.0f;
    }
  }

  for (int i = 0; i < tiles; ++i) {
    const int n = min(kTile, end - start - i * kTile);
    cp_async_wait<kStages - 2>();  // this thread's copies of tile i have landed
    __syncthreads();               // everyone's; and tile i - 1 is done with, so its stage may be refilled
    issue(i + kStages - 1);
    // Warp w takes tokens kWarpTokens * w .. + kWarpTokens - 1 of the tile,
    // with an online softmax of its own; the block merges the warps at the end.
    const int r0 = warp * kWarpTokens;
    const int count = min(kWarpTokens, n - r0);
    if (count <= 0) continue;
    const C* k_s = k_ring + (i % kStages) * kTile * d_size + r0 * d_size;
    const C* v_s = v_ring + (i % kStages) * kTile * d_size + r0 * d_size;
    float s[kWarpTokens][G];
#pragma unroll
    for (int u = 0; u < kWarpTokens; ++u) {
      if (u < count) {
        float part[G];
#pragma unroll
        for (int g = 0; g < G; ++g) part[g] = 0.0f;
#pragma unroll
        for (int c = 0; c < kLaneCols; ++c) {
          const int d = lane + 32 * c;
          if (d < d_size) {
            const float kd = to_float(k_s[u * d_size + d]);
#pragma unroll
            for (int g = 0; g < G; ++g) part[g] += q[g][c] * kd;
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float x = warp_sum(part[g]) * p.scale;
          if constexpr (SOFTCAP) x = p.softcap * tanhf(x / p.softcap);
          s[u][g] = x;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float tile_max = s[0][g];  // count >= 1
#pragma unroll
      for (int u = 1; u < kWarpTokens; ++u)
        if (u < count) tile_max = fmaxf(tile_max, s[u][g]);
      const float m_new = fmaxf(m[g], tile_max);
      const float alpha = __expf(m[g] - m_new);  // exp(-inf) = 0 on the warp's first tokens
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < kWarpTokens; ++u) {
        s[u][g] = u < count ? __expf(s[u][g] - m_new) : 0.0f;
        sum += s[u][g];
      }
      l[g] = l[g] * alpha + sum;
      m[g] = m_new;
#pragma unroll
      for (int c = 0; c < kLaneCols; ++c) acc[g][c] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < kWarpTokens; ++u) {
      if (u < count) {
#pragma unroll
        for (int c = 0; c < kLaneCols; ++c) {
          const int d = lane + 32 * c;
          if (d < d_size) {
            const float vd = to_float(v_s[u * d_size + d]);
#pragma unroll
            for (int g = 0; g < G; ++g) acc[g][c] += s[u][g] * vd;
          }
        }
      }
    }
  }

  // The block's merge of its warps, in warp order: weight exp(m_w - M),
  // M the largest of the warps' maxima (a warp that saw no token has m_w
  // = -inf and weight 0).
  __syncthreads();  // the ring is free
  float* acc_s = reinterpret_cast<float*>(smem);   // [kWarps][G][D]
  float* ml_s = acc_s + kWarps * G * d_size;       // [kWarps][G][2]
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) {
      const int d = lane + 32 * c;
      if (d < d_size) acc_s[(warp * G + g) * d_size + d] = acc[g][c];
    }
    if (lane == 0) {
      ml_s[(warp * G + g) * 2] = m[g];
      ml_s[(warp * G + g) * 2 + 1] = l[g];
    }
  }
  __syncthreads();
  if (tid < group) {
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ml_s[(w * G + tid) * 2]);
    float sum = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float wt = __expf(ml_s[(w * G + tid) * 2] - mx);
      wgt_s[w][tid] = wt;
      sum += ml_s[(w * G + tid) * 2 + 1] * wt;
    }
    m_s[tid] = mx;
    l_s[tid] = sum;
  }
  __syncthreads();
  // The merge may start launching (it waits for this grid to finish before
  // it reads the workspace).
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int64_t split_head0 = (static_cast<int64_t>(split) * p.batch * p.num_q_heads) + head0;
  for (int idx = tid; idx < group * d_size; idx += kThreads) {
    const int g = idx / d_size;
    const int d = idx - g * d_size;
    float a = 0.0f;
    for (int w = 0; w < kWarps; ++w) a += acc_s[(w * G + g) * d_size + d] * wgt_s[w][g];
    if (p.splits == 1) {
      out[(head0 + g) * d_size + d] = from_float<T>(a / l_s[g] * p.v_scale);
    } else {
      p.part_acc[(split_head0 + g) * d_size + d] = a;
    }
  }
  if (p.splits > 1 && tid < group) {
    p.part_ml[(split_head0 + tid) * 2] = m_s[tid];
    p.part_ml[(split_head0 + tid) * 2 + 1] = l_s[tid];
  }
}

// Merges the live splits of one (sequence, query head): split z carries
// weight w_z = exp(m_z - m) with m the largest of their maxima; the output
// is sum_z w_z acc_z / sum_z w_z l_z, times v_scale, the splits taken in
// order. An idle row has no live split and writes zeros.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads) paged_merge_kernel(const __grid_constant__ PagedParams p) {
  __shared__ float w_s[kMaxSplits];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the split grid has finished and its stores are visible
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int seq_len = p.seq_lens[b];
  const int visible = seq_len - visible_start(p, seq_len);
  const int live = visible > 0 ? min((visible + p.split_len - 1) / p.split_len, p.splits) : 0;
  const int64_t head = static_cast<int64_t>(b) * p.num_q_heads + h;
  const int64_t split_stride = static_cast<int64_t>(p.batch) * p.num_q_heads;
  float m = -INFINITY;
  for (int z = 0; z < live; ++z) m = fmaxf(m, p.part_ml[(z * split_stride + head) * 2]);
  for (int z = threadIdx.x; z < live; z += kMergeThreads) w_s[z] = __expf(p.part_ml[(z * split_stride + head) * 2] - m);
  __syncthreads();
  float l = 0.0f;
  for (int z = 0; z < live; ++z) l += p.part_ml[(z * split_stride + head) * 2 + 1] * w_s[z];
  T* out = static_cast<T*>(p.out);
  for (int d = threadIdx.x; d < p.head_size; d += kMergeThreads) {
    float a = 0.0f;
    for (int z = 0; z < live; ++z) a += p.part_acc[(z * split_stride + head) * p.head_size + d] * w_s[z];
    out[head * p.head_size + d] = from_float<T>(live > 0 ? a / l * p.v_scale : 0.0f);
  }
}

template <typename T, typename C, int G, bool SOFTCAP>
cudaError_t launch(const PagedParams& p, cudaStream_t stream) {
  auto kernel = paged_split_kernel<T, C, G, SOFTCAP>;
  const int smem = static_cast<int>(split_smem_bytes(p.head_size, static_cast<int>(sizeof(C)), G));
  cudaError_t status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (status != cudaSuccess) return status;
  kernel<<<dim3(p.batch, p.num_kv_heads, p.splits), kThreads, smem, stream>>>(p);
  if (p.splits > 1) {
    // Launched as a programmatic dependent of the split grid, so that its
    // launch overlaps the split grid's last blocks.
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(p.batch, p.num_q_heads);
    config.blockDim = dim3(kMergeThreads);
    config.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    status = cudaLaunchKernelEx(&config, paged_merge_kernel<T>, p);
    if (status != cudaSuccess) return status;
  }
  return cudaGetLastError();
}

// The split kernel's template for the GQA group: G the smallest of 1, 2,
// 4, 8 that holds it (rows past the group compute nothing that is kept).
template <typename T, typename C, bool SOFTCAP>
cudaError_t launch_group(const PagedParams& p, cudaStream_t stream) {
  const int group = p.num_q_heads / p.num_kv_heads;
  if (group <= 1) return launch<T, C, 1, SOFTCAP>(p, stream);
  if (group <= 2) return launch<T, C, 2, SOFTCAP>(p, stream);
  if (group <= 4) return launch<T, C, 4, SOFTCAP>(p, stream);
  return launch<T, C, 8, SOFTCAP>(p, stream);
}


// The launch for queries of type T over a cache of dtype code cache_dtype
// (common.cuh's dispatch_act_cache pairs), softcap on or off. Explicitly
// instantiated once for each T, in that T's source.
template <typename T>
cudaError_t launch_type(const PagedParams& p, int dtype, int cache_dtype, cudaStream_t stream) {
  cudaError_t status = cudaErrorInvalidValue;
  dispatch_act_cache(dtype, cache_dtype, [&](auto q_tag, auto c_tag) {
    using Q = typename decltype(q_tag)::type;
    using C = typename decltype(c_tag)::type;
    if constexpr (std::is_same_v<Q, T>) {
      status = p.softcap > 0.0f ? launch_group<T, C, true>(p, stream) : launch_group<T, C, false>(p, stream);
    }
  });
  return status;
}

extern template cudaError_t launch_type<float>(const PagedParams&, int, int, cudaStream_t);
extern template cudaError_t launch_type<__nv_bfloat16>(const PagedParams&, int, int, cudaStream_t);
extern template cudaError_t launch_type<__half>(const PagedParams&, int, int, cudaStream_t);

}  // namespace paged
}  // namespace conch
