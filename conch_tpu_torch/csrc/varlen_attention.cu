// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Variable-length paged prefill attention (K7): tiles of query rows on the
// tensor cores, split over the KV walk.
//
// Replaces conch_tpu/kernels/attention/varlen_attention.py:_varlen_dma_allheads_kernel
// (and its variants _varlen_dma_kernel and _varlen_attention_kernel,
// which compute the same function). Queries are packed by cu_seqlens_q;
// query j of sequence b sits at KV position seq_lens[b] - q_len[b] + j
// and, when causal, sees positions 0..itself. A sliding window (> 0)
// anchors at the row's own position, causal or not: the row sees keys from
// q_pos - window + 1. Softcap (> 0) caps the scaled logits.
//
// Bound on the H100: operations at a long chunk (Gemma-2-2B's 400 rows at
// 4600 tokens: 2 * 2 * G * D multiply-adds per query row and visible key),
// bytes at a short one (each sequence's visible K and V rows read once).
//
// Design (bf16 or f16 queries, the element type T a template parameter;
// the TPU kernel's step at :383-434):
//  - a block of 4 warps owns one (sequence, tile of BM query rows) pair,
//    one KV head and one split of the tile's KV range. Its 64 MMA rows are
//    the tile's rows times the G query heads of the group (row r = query
//    r / G, head r % G; BM = 64 / G), so each staged K/V tile serves every
//    row and head of the block. Two blocks share an SM, so that one
//    block's barrier waits hide behind the other's arithmetic. The pairs come from shapes alone: the grid has
//    cdiv(total_q, BM) + batch tile slots, more than any step has pairs,
//    and a block finds its pair from cu_seqlens_q on the device (slots past
//    the last pair exit), so the wrapper never reads a value on the host;
//  - the tile's keys [lo, hi) run from the first row's window start (0
//    without a window) to the last row's position (causal; seq_len
//    otherwise); split z takes [lo + z * split_len, ..) of them (the plan:
//    kernels/attention/varlen_attention.py:varlen_tile_plan). Keys before
//    lo, the block table past hi and pages wholly before every row's
//    window are never read;
//  - K and V tiles of KT tokens (64, or 32 at head 256) go through a ring
//    of 2 stages in shared memory by cp.async (16 bytes a thread, zero-
//    filled past the split), their rows found through the block table (one
//    lookup a thread and tile, loaded a tile ahead);
//    int8 and e4m3 caches are staged as bytes and widened to T in
//    shared memory (exactly: both hold every int8 and e4m3 value) before
//    use; a 16-bit cache is the queries' own type. Heads below HD (64, 128, 256, the
//    template) are zero-padded there;
//  - warp w takes MMA rows 16w .. 16w + 15 alone (no barrier between its
//    steps): S = Q . K^T with mma.sync m16n8k16 in T (ldmatrix for both
//    operands, f32 sums), times scale * log2(e) (or softcap * log2(e) *
//    tanh(s * scale / softcap)), an online softmax in base 2 in registers, P rounded to
//    T as the A operand of O += P . V (ldmatrix.trans for V). Only the
//    tiles that cross a row's diagonal or window start are masked, and a
//    warp skips a tile that none of its rows sees;
//  - with one split the block writes (O / l) * v_scale in T; otherwise
//    its unnormalized O and (max, sum) go to an f32 workspace and a second
//    kernel, launched as a programmatic dependent (its launch overlaps this
//    grid's end), merges the live splits by log-sum-exp in a fixed order.
// Rows past cu_seqlens_q[batch] (padding) come out as zeros (the blocks of
// split 0 write them); zero-length sequences own no tile. Rolling KV
// (ring_pages > 0, a run-time argument): each block-table row is a ring,
// true page i at entry i % ring_pages, as the TPU kernel's jax.lax.rem
// (:159-163, :356-358). The walk starts at the window's low bound (lo), as
// the TPU kernel's band addressing does (:510-516), so a tile's true pages
// may outnumber both the table and the ring; the plan takes the split
// count from the window, never from the ring. Quantized caches:
// `scale` carries scale * q_scale * k_scale and v_scale multiplies the
// output, as the TPU kernel folds them (:750-753).
//
// f32 queries (no served model uses them) take the per-row CUDA-core
// kernel of attention_common.cuh, f32 throughout, one block per (query
// row, KV head).

#include "attention_common.cuh"
#include "gemm_common.cuh"

namespace conch {
namespace varlen {

constexpr int kThreads = 128;
constexpr int kRows = 64;  // MMA rows a block: BM query rows x the group's G heads
constexpr int kStages = 2;
constexpr int kBlocksPerSm = 2;  // two blocks an SM: one block's barrier waits hide behind the other's arithmetic
constexpr int kMaxSplits = 64;
constexpr int kMergeThreads = kMaxGroup * 32;  // a warp per head of the group
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* query;  // (total_q, QH, D)
  void* out;
  const void* k_layer;  // one layer of the pool: (P, KH, ps, D)
  const void* v_layer;
  const int32_t* cu_seqlens_q;  // (batch + 1,)
  const int32_t* seq_lens;      // (batch,)
  const int32_t* block_table;   // (batch, max_pages)
  float* part_acc;              // (splits, total_q, QH, D) f32, splits > 1
  float* part_ml;               // (splits, total_q, QH, 2) f32: running max (base 2), softmax sum
  int total_q, batch, max_pages, num_q_heads, num_kv_heads, page_size, head_size;
  int block_rows;  // BM: query rows a tile
  int split_len, splits;
  int causal, window;
  int ring_pages;  // > 0: rolling KV, true page i at block-table entry i % ring_pages
  float scale, softcap, v_scale;
  int q_copy, kv_copy;  // cp.async bytes of the query and cache rows: 16 or 4, or 0 (element by element)
};

// One tile of a sequence's query rows and the keys its rows see: [lo, hi).
struct Tile {
  int q0;     // packed row of the tile's first query
  int rows;   // query rows in the tile (<= BM)
  int first;  // KV position of the tile's first query
  int seq_len;
  int lo, hi;
};

// Tile slot `slot`'s (sequence, tile) pair: the tiles in sequence order,
// cdiv(q_len, BM) a sequence. False past the last pair.
__device__ __forceinline__ bool find_tile(const Params& p, int slot, int& b, int& tile) {
  int rem = slot;
  for (int s = 0; s < p.batch; ++s) {
    const int tiles = (p.cu_seqlens_q[s + 1] - p.cu_seqlens_q[s] + p.block_rows - 1) / p.block_rows;
    if (rem < tiles) {
      b = s;
      tile = rem;
      return true;
    }
    rem -= tiles;
  }
  return false;
}

__device__ __forceinline__ Tile tile_of(const Params& p, int b, int tile) {
  Tile t;
  const int cu0 = p.cu_seqlens_q[b];
  const int q_len = p.cu_seqlens_q[b + 1] - cu0;
  t.seq_len = p.seq_lens[b];
  t.q0 = cu0 + tile * p.block_rows;
  t.rows = min(p.block_rows, q_len - tile * p.block_rows);
  t.first = t.seq_len - q_len + tile * p.block_rows;
  const int last = t.first + t.rows - 1;
  t.hi = max(min(p.causal ? last + 1 : t.seq_len, t.seq_len), 0);
  t.lo = p.window > 0 ? max(t.first - p.window + 1, 0) : 0;
  return t;
}

// The first and last key that query i of the tile sees.
__device__ __forceinline__ int row_start(const Params& p, const Tile& t, int i) {
  return p.window > 0 ? max(t.first + i - p.window + 1, 0) : 0;
}
__device__ __forceinline__ int row_limit(const Params& p, const Tile& t, int i) {
  return p.causal ? t.first + i : t.seq_len - 1;
}

// Splits of the tile with keys to walk (the merge reads these).
__device__ __forceinline__ int live_splits(const Params& p, const Tile& t) {
  return t.hi > t.lo ? min((t.hi - t.lo + p.split_len - 1) / p.split_len, p.splits) : 0;
}

// `bytes` (16 or 4) from src, of which the first src_bytes (bytes or 0) are
// read and the rest zero-filled.
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, int src_bytes) {
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies this thread's share of a tile of ROWS rows of `row_elems`
// elements of type E: row threadIdx.x / TPR (TPR = kThreads / ROWS threads
// a row, so that each thread finds its row once), from `src` (or zeros
// when src is null) to dst + row * dst_stride bytes; by cp.async of `copy`
// bytes, or element by element when copy is 0. `base` is any global
// address (the zero-filling copies name it and read nothing).
template <typename E, int ROWS>
__device__ __forceinline__ void copy_row(uint8_t* dst, int dst_stride, int row_elems, int copy, const void* base,
                                         const E* src) {
  constexpr int TPR = kThreads / ROWS;
  uint8_t* d = dst + (threadIdx.x / TPR) * dst_stride;
  if (copy == 0) {
    for (int e = threadIdx.x % TPR; e < row_elems; e += TPR) {
      E v{};
      if (src != nullptr) v = src[e];
      reinterpret_cast<E*>(d)[e] = v;
    }
    return;
  }
  const int chunks = row_elems * static_cast<int>(sizeof(E)) / copy;
  const uint8_t* from = src != nullptr ? reinterpret_cast<const uint8_t*>(src) : static_cast<const uint8_t*>(base);
  for (int c = threadIdx.x % TPR; c < chunks; c += TPR) {
    cp_async(d + c * copy, src != nullptr ? from + c * copy : from, copy, src != nullptr ? copy : 0);
  }
}

// Shared memory of the tile kernel (bytes): the Q tile (kRows rows of HD
// T, bf16 or f16), the ring (kStages x a K tile and a V tile of KT rows in
// the cache's type), and for one-byte caches the K and V tiles widened to
// T. 16-bit rows are padded by 8 values, so that the 8 rows an ldmatrix
// reads fall on distinct banks.
template <typename C, int HD>
struct Smem {
  static constexpr bool kWiden = kQuantizedCache<C>;
  static constexpr int KT = HD == 256 ? 32 : 64;         // tokens a K/V tile
  static constexpr int QS = HD + 8;                      // 16-bit row stride (values)
  static constexpr int RS = kWiden ? HD + 16 : QS * 2;   // ring row stride (bytes)
  static constexpr int kRingTile = KT * RS;
  static constexpr int kRingOff = kRows * QS * 2;
  static constexpr int kWideOff = kRingOff + kStages * 2 * kRingTile;
  static constexpr int kBytes = kWideOff + (kWiden ? 2 * KT * QS * 2 : 0);
};

template <typename T, typename C, int HD>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) varlen_tile_kernel(const __grid_constant__ Params p) {
  using S = Smem<C, HD>;
  constexpr int KT = S::KT;
  constexpr int QS = S::QS;
  extern __shared__ __align__(16) uint8_t smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  uint8_t* ring = smem + S::kRingOff;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int kvh = blockIdx.y;
  const int z = blockIdx.z;
  const int group = p.num_q_heads / p.num_kv_heads;
  const int d_size = p.head_size;
  T* out = static_cast<T*>(p.out);
  auto out_row = [&](int64_t row) { return out + (row * p.num_q_heads + kvh * group) * d_size; };
  const T zero = from_float<T>(0.0f);

  // Padding rows: zeros, shared out among the blocks of split 0.
  if (z == 0) {
    for (int row = p.cu_seqlens_q[p.batch] + blockIdx.x; row < p.total_q; row += gridDim.x) {
      for (int idx = tid; idx < group * d_size; idx += kThreads) out_row(row)[idx] = zero;
    }
  }
  int b, tile;
  if (!find_tile(p, blockIdx.x, b, tile)) return;
  const Tile t = tile_of(p, b, tile);
  const int s_lo = t.lo + z * p.split_len;
  const int s_hi = min(s_lo + p.split_len, t.hi);
  if (s_lo >= s_hi) {
    // Nothing to walk. With one split the tile's rows are zeros (the merge
    // writes them otherwise).
    if (p.splits == 1) {
      for (int idx = tid; idx < t.rows * group * d_size; idx += kThreads) {
        const int i = idx / (group * d_size);
        out_row(t.q0 + i)[idx - i * group * d_size] = zero;
      }
    }
    return;
  }

  // The pad columns [D, HD) that the MMAs read: zeros (the copies below
  // write columns [0, D) only).
  T* k_wide = reinterpret_cast<T*>(smem + S::kWideOff);
  if (d_size < HD) {
    const int pad = HD - d_size;
    for (int idx = tid; idx < kRows * pad; idx += kThreads) q_s[(idx / pad) * QS + d_size + idx % pad] = zero;
    if constexpr (S::kWiden) {
      for (int idx = tid; idx < 2 * KT * pad; idx += kThreads) k_wide[(idx / pad) * QS + d_size + idx % pad] = zero;
    } else {
      T* r = reinterpret_cast<T*>(ring);
      for (int idx = tid; idx < kStages * 2 * KT * pad; idx += kThreads) r[(idx / pad) * QS + d_size + idx % pad] = zero;
    }
  }
  // The Q tile: row r is query r / G, head r % G; rows past the tile are zeros.
  const T* query = static_cast<const T*>(p.query);
  {
    const int r = tid / (kThreads / kRows);
    const int i = r / group;
    const T* src =
        i < t.rows ? query + ((static_cast<int64_t>(t.q0) + i) * p.num_q_heads + kvh * group + r % group) * d_size
                   : nullptr;
    copy_row<T, kRows>(reinterpret_cast<uint8_t*>(q_s), QS * 2, d_size, p.q_copy, query, src);
  }
  // K/V tiles: thread tid copies token tid / (kThreads / KT) of each tile,
  // its row found once through the block table.
  const C* k_layer = static_cast<const C*>(p.k_layer);
  const C* v_layer = static_cast<const C*>(p.v_layer);
  const int32_t* bt_row = p.block_table + static_cast<int64_t>(b) * p.max_pages;
  const int tiles = (s_hi - s_lo + KT - 1) / KT;
  const int my_token = tid / (kThreads / KT);
  // The page holding this thread's token of tile i (-1 past the split),
  // loaded one tile ahead of its copies so that the load's latency hides
  // behind a tile's arithmetic.
  auto page_of = [&](int i) -> int {
    const int pos = s_lo + i * KT + my_token;
    if (i >= tiles || pos >= s_hi) return -1;
    const int entry = pos / p.page_size;
    return bt_row[p.ring_pages > 0 ? entry % p.ring_pages : entry];
  };
  auto issue = [&](int i, int page) {
    if (i < tiles) {
      const int pos = s_lo + i * KT + my_token;
      const int64_t row = page < 0 ? -1 : ((static_cast<int64_t>(page) * p.num_kv_heads + kvh) * p.page_size +
                                           pos % p.page_size) * static_cast<int64_t>(d_size);
      uint8_t* dst = ring + (i % kStages) * 2 * S::kRingTile;
      copy_row<C, KT>(dst, S::RS, d_size, p.kv_copy, k_layer, row >= 0 ? k_layer + row : nullptr);
      copy_row<C, KT>(dst + S::kRingTile, S::RS, d_size, p.kv_copy, v_layer, row >= 0 ? v_layer + row : nullptr);
    }
    cp_async_commit();  // an empty group past the last tile keeps the counts aligned
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i, page_of(i));  // the Q tile lands with tile 0
  int next_page = page_of(kStages - 1);

  // This thread's two rows (g and g + 8 of the warp's 16) and the warp's
  // extent: the first and last key any of its rows sees (rows are in
  // query order, so the first and last live query bound them).
  const int i_first = warp * 16 / group;
  const int i_last = min((warp * 16 + 15) / group, t.rows - 1);
  const bool warp_live = i_first < t.rows;
  const int w_min_limit = row_limit(p, t, i_first), w_max_limit = row_limit(p, t, i_last);
  const int w_min_start = row_start(p, t, i_first), w_max_start = row_start(p, t, i_last);
  int lim[2], beg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = (warp * 16 + g + 8 * h) / group;
    lim[h] = i < t.rows ? row_limit(p, t, i) : -1;  // a row past the tile sees nothing
    beg[h] = row_start(p, t, min(i, t.rows - 1));
  }
  const float scale_log2 = p.scale * kLog2e;
  const float scale_cap = p.softcap > 0.0f ? p.scale / p.softcap : 0.0f;
  const float cap_log2 = p.softcap * kLog2e;
  float o[HD / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.0f;

  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile i have landed
    __syncthreads();               // everyone's; and tile i - 1 is done with, so its stage may be refilled
    issue(i + kStages - 1, next_page);
    next_page = page_of(i + kStages);
    const uint8_t* k_stage = ring + (i % kStages) * 2 * S::kRingTile;
    const T* kb;
    const T* vb;
    if constexpr (S::kWiden) {
      // Widen the tile's bytes to T (rows past the split were zero-filled).
      const C* raw = reinterpret_cast<const C*>(k_stage);
      if (d_size % 8 == 0) {
        const int per_row = d_size / 8;
        for (int idx = tid; idx < 2 * KT * per_row; idx += kThreads) {
          const int r = idx / per_row;
          const int c = idx - r * per_row;
          const uint2 v = *reinterpret_cast<const uint2*>(reinterpret_cast<const uint8_t*>(raw) + r * S::RS + 8 * c);
          *reinterpret_cast<uint4*>(k_wide + r * QS + 8 * c) = widen8<T, C>(v);
        }
      } else {
        for (int idx = tid; idx < 2 * KT * d_size; idx += kThreads) {
          const int r = idx / d_size;
          const int c = idx - r * d_size;
          k_wide[r * QS + c] = from_float<T>(to_float(raw[r * S::RS + c]));
        }
      }
      __syncthreads();
      kb = k_wide;
      vb = k_wide + KT * QS;
    } else {
      kb = reinterpret_cast<const T*>(k_stage);
      vb = reinterpret_cast<const T*>(k_stage + S::kRingTile);
    }
    const int k0 = s_lo + i * KT;
    const int n = min(KT, s_hi - k0);
    // A warp skips a tile none of its rows sees.
    if (!warp_live || k0 > w_max_limit || k0 + n - 1 < w_min_start) continue;

    // S = Q . K^T over the warp's 16 rows and the tile's KT keys.
    float s[KT / 8][4];
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, q_s + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * QS + 16 * ks + 8 * (lane >> 4));
#pragma unroll
      for (int np = 0; np < KT / 16; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, kb + (16 * np + 8 * (lane >> 4) + (lane & 7)) * QS + 16 * ks + 8 * ((lane >> 3) & 1));
        mma_16816<T>(s[2 * np], a[0], a[1], a[2], a[3], bk[0], bk[1]);
        mma_16816<T>(s[2 * np + 1], a[0], a[1], a[2], a[3], bk[2], bk[3]);
      }
    }
    // Logits in base 2; the mask only where a row's diagonal or window
    // start crosses the tile, or the tile ends early.
    const bool full = n == KT && k0 + KT - 1 <= w_min_limit && k0 >= w_max_start;
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e];
        x = p.softcap > 0.0f ? cap_log2 * tanhf(x * scale_cap) : x * scale_log2;
        if (!full) {
          const int j = 8 * nt + 2 * tig + (e & 1);
          const int key = k0 + j;
          if (j >= n || key > lim[e >> 1] || key < beg[e >> 1]) x = -INFINITY;
        }
        s[nt][e] = x;
      }
    }
    // Online softmax of rows g (h 0) and g + 8 (h 1); a quad of lanes holds a row.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;  // a row that has seen no key yet
      const float alpha = exp2f(m[h] - m_use);
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt) {
        s[nt][2 * h] = exp2f(s[nt][2 * h] - m_use);
        s[nt][2 * h + 1] = exp2f(s[nt][2 * h + 1] - m_use);
        sum += s[nt][2 * h] + s[nt][2 * h + 1];
      }
      l[h] = l[h] * alpha + sum;
      m[h] = m_new;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        o[dt][2 * h] *= alpha;
        o[dt][2 * h + 1] *= alpha;
      }
    }
    // O += P . V, P rounded to T as the A operand.
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint32_t a0 = pack_x2<T>(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_x2<T>(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_x2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_x2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vb + (16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7)) * QS + 16 * dp + 8 * (lane >> 4));
        mma_16816<T>(o[2 * dp], a0, a1, a2, a3, bv[0], bv[1]);
        mma_16816<T>(o[2 * dp + 1], a0, a1, a2, a3, bv[2], bv[3]);
      }
    }
  }
  // The merge may start launching (it waits for this grid to finish before
  // it reads the workspace).
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = warp * 16 + g + 8 * h;
    const int i = r / group;
    if (i >= t.rows) continue;
    const int64_t row = t.q0 + i;
    const int64_t head = row * p.num_q_heads + kvh * group + r % group;
    if (p.splits == 1) {
      T* dst = out + head * d_size;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        const int d = 8 * dt + 2 * tig;
        if (d < d_size) dst[d] = from_float<T>(l[h] > 0.0f ? o[dt][2 * h] / l[h] * p.v_scale : 0.0f);
        if (d + 1 < d_size) dst[d + 1] = from_float<T>(l[h] > 0.0f ? o[dt][2 * h + 1] / l[h] * p.v_scale : 0.0f);
      }
    } else {
      const int64_t at = static_cast<int64_t>(z) * p.total_q * p.num_q_heads + head;
      float* dst = p.part_acc + at * d_size;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        const int d = 8 * dt + 2 * tig;
        if (d < d_size) dst[d] = o[dt][2 * h];
        if (d + 1 < d_size) dst[d + 1] = o[dt][2 * h + 1];
      }
      if (tig == 0) {
        p.part_ml[at * 2] = m[h];
        p.part_ml[at * 2 + 1] = l[h];
      }
    }
  }
}

// Merges the live splits of one (query row, KV head): split z carries
// weight w_z = 2^(m_z - m), m the largest of their maxima; the output is
// (sum_z w_z acc_z / sum_z w_z l_z) * v_scale, the splits taken in order.
// A split in which the row saw no key has m_z = -inf and weight 0.
// Padding rows were zeroed by the split kernel.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads) varlen_merge_kernel(const __grid_constant__ Params p) {
  __shared__ float w_s[kMaxGroup][kMaxSplits];
  __shared__ float l_s[kMaxGroup];
  // The row's tile and live splits come from the inputs, read while the
  // split grid finishes; the workspace only after it has.
  const int row = blockIdx.x;
  if (row >= p.cu_seqlens_q[p.batch]) return;
  int b = 0;
  while (p.cu_seqlens_q[b + 1] <= row) ++b;  // the row's sequence (zero-length ones own no row)
  const Tile t = tile_of(p, b, (row - p.cu_seqlens_q[b]) / p.block_rows);
  const int live = live_splits(p, t);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the split grid has finished and its stores are visible
  const int group = p.num_q_heads / p.num_kv_heads;
  const int64_t head0 = static_cast<int64_t>(row) * p.num_q_heads + blockIdx.y * group;
  const int64_t split_stride = static_cast<int64_t>(p.total_q) * p.num_q_heads;
  // Warp g weighs head g's splits, lane z taking splits z and z + 32.
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < group) {
    const float* ml = p.part_ml + (head0 + warp) * 2;
    float m_z[2], mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int z = lane + 32 * u;
      m_z[u] = z < live ? ml[z * split_stride * 2] : -INFINITY;
      mx = fmaxf(mx, m_z[u]);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int z = lane + 32 * u;
      if (z < live) {
        const float w = mx == -INFINITY ? 0.0f : exp2f(m_z[u] - mx);
        w_s[warp][z] = w;
        sum += ml[z * split_stride * 2 + 1] * w;
      }
    }
    sum = warp_sum(sum);
    if (lane == 0) l_s[warp] = sum;
  }
  __syncthreads();
  T* out = static_cast<T*>(p.out);
  for (int idx = threadIdx.x; idx < group * p.head_size; idx += kMergeThreads) {
    const int gh = idx / p.head_size;
    const int64_t at = (head0 + gh) * p.head_size + (idx - gh * p.head_size);
    float a = 0.0f;
    for (int z = 0; z < live; ++z) a += p.part_acc[z * split_stride * p.head_size + at] * w_s[gh][z];
    const float l = l_s[gh];
    out[at] = from_float<T>(l > 0.0f ? a / l * p.v_scale : 0.0f);
  }
}

template <typename T, typename C, int HD>
cudaError_t launch(const Params& p, int tile_slots, cudaStream_t stream) {
  using S = Smem<C, HD>;
  auto kernel = varlen_tile_kernel<T, C, HD>;
  cudaError_t status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
  if (status != cudaSuccess) return status;
  kernel<<<dim3(tile_slots, p.num_kv_heads, p.splits), kThreads, S::kBytes, stream>>>(p);
  if (p.splits > 1) {
    // Launched as a programmatic dependent of the split grid, so that its
    // launch overlaps the split grid's last blocks.
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(p.total_q, p.num_kv_heads);
    config.blockDim = dim3(kMergeThreads);
    config.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    status = cudaLaunchKernelEx(&config, varlen_merge_kernel<T>, p);
    if (status != cudaSuccess) return status;
  }
  return cudaGetLastError();
}

// The tile kernel's template for the head size: HD the smallest of 64,
// 128, 256 that holds it.
template <typename T, typename C>
cudaError_t launch_head(const Params& p, int tile_slots, cudaStream_t stream) {
  if (p.head_size <= 64) return launch<T, C, 64>(p, tile_slots, stream);
  if (p.head_size <= 128) return launch<T, C, 128>(p, tile_slots, stream);
  return launch<T, C, 256>(p, tile_slots, stream);
}

}  // namespace varlen

// f32 queries: one block per (query row, KV head) walks the row's keys with
// attend_group (attention_common.cuh), f32 throughout.
template <typename C, bool SOFTCAP>
__global__ void varlen_rows_f32_kernel(const float* __restrict__ query, float* __restrict__ out, const void* k_layer,
                                       const void* v_layer, const int32_t* __restrict__ cu_seqlens_q,
                                       const int32_t* __restrict__ seq_lens, const int32_t* __restrict__ block_table,
                                       int batch, int max_pages, int num_q_heads, int num_kv_heads, int page_size,
                                       int head_size, float scale, float softcap, int window, int ring_pages,
                                       int causal, float v_scale) {
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
  const PagedKV kv{k_layer, v_layer, bt_row, num_kv_heads, page_size, head_size, ring_pages};
  attend_group<float, C, SOFTCAP>(query + row, head_size, out + row, head_size, kv, kv_head, kv_start, kv_len,
                                  group, scale, softcap, v_scale);
}

}  // namespace conch

// query and out (total_q, QH, D) in `dtype` (f32, bf16 or f16); the
// caches' layer (P, KH, ps, D) in `cache_dtype` (int8, e4m3, the queries'
// own type, or bf16 under f32 queries); cu_seqlens_q (batch + 1,),
// seq_lens (batch,), block_table (batch, max_pages) int32; ring_pages > 0
// reads each row as a ring of its first ring_pages entries. The plan
// (varlen_tile_plan; bf16 and f16 queries): block_rows (BM = 128 / G query rows a tile), tile_slots (the
// grid's tile slots, at least the step's (sequence, tile) pairs),
// split_len and splits (1 <= splits <= 64); with splits > 1, part_acc
// (splits, total_q, QH, D) and part_ml (splits, total_q, QH, 2) f32.
// q_copy, kv_copy: 16 or 4 when D times the element size and the pointers
// are multiples of it, else 0.
extern "C" int conch_varlen_attention(const void* query, void* out, const void* k_layer, const void* v_layer,
                                      const void* cu_seqlens_q, const void* seq_lens, const void* block_table,
                                      int total_q, int batch, int max_pages, int num_q_heads, int num_kv_heads,
                                      int page_size, int head_size, float scale, float softcap, int window,
                                      int ring_pages, int causal, float v_scale, int dtype, int cache_dtype,
                                      int block_rows, int tile_slots, int split_len, int splits, void* part_acc, void* part_ml,
                                      int q_copy, int kv_copy, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (total_q == 0) return static_cast<int>(cudaSuccess);
  const int group = num_kv_heads > 0 ? num_q_heads / num_kv_heads : 0;
  if (group < 1 || num_q_heads % num_kv_heads != 0 || group > conch::kMaxGroup || head_size < 1 ||
      head_size > conch::kMaxHeadSize || ring_pages < 0 || ring_pages > max_pages ||
      (ring_pages > 0 && (window <= 0 || ring_pages * page_size < window))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == conch::kFloat32) {
    const dim3 grid(total_q, num_kv_heads);
    const bool known = conch::dispatch_act_cache(dtype, cache_dtype, [&](auto q_tag, auto c_tag) {
      using T = typename decltype(q_tag)::type;
      using C = typename decltype(c_tag)::type;
      if constexpr (std::is_same_v<T, float>) {
        auto kernel = softcap > 0.0f ? conch::varlen_rows_f32_kernel<C, true> : conch::varlen_rows_f32_kernel<C, false>;
        kernel<<<grid, conch::kAttnThreads, 0, s>>>(
            static_cast<const float*>(query), static_cast<float*>(out), k_layer, v_layer,
            static_cast<const int32_t*>(cu_seqlens_q), static_cast<const int32_t*>(seq_lens),
            static_cast<const int32_t*>(block_table), batch, max_pages, num_q_heads, num_kv_heads, page_size,
            head_size, scale, softcap, window, ring_pages, causal, v_scale);
      }
    });
    if (!known) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
  }
  if (block_rows < 1 || block_rows * group > conch::varlen::kRows || tile_slots < 1 ||
      split_len < 1 || splits < 1 || splits > conch::varlen::kMaxSplits ||
      (splits > 1 && (part_acc == nullptr || part_ml == nullptr)) || (q_copy != 0 && q_copy != 4 && q_copy != 16) ||
      (kv_copy != 0 && kv_copy != 4 && kv_copy != 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  conch::varlen::Params p{};
  p.query = query;
  p.out = out;
  p.k_layer = k_layer;
  p.v_layer = v_layer;
  p.cu_seqlens_q = static_cast<const int32_t*>(cu_seqlens_q);
  p.seq_lens = static_cast<const int32_t*>(seq_lens);
  p.block_table = static_cast<const int32_t*>(block_table);
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.total_q = total_q;
  p.batch = batch;
  p.max_pages = max_pages;
  p.num_q_heads = num_q_heads;
  p.num_kv_heads = num_kv_heads;
  p.page_size = page_size;
  p.head_size = head_size;
  p.block_rows = block_rows;
  p.split_len = split_len;
  p.splits = splits;
  p.causal = causal;
  p.window = window;
  p.ring_pages = ring_pages;
  p.scale = scale;
  p.softcap = softcap;
  p.v_scale = v_scale;
  p.q_copy = q_copy;
  p.kv_copy = kv_copy;
  cudaError_t status = cudaErrorInvalidValue;
  conch::dispatch_act_cache(dtype, cache_dtype, [&](auto q_tag, auto c_tag) {
    using T = typename decltype(q_tag)::type;
    using C = typename decltype(c_tag)::type;
    if constexpr (!std::is_same_v<T, float>) status = conch::varlen::launch_head<T, C>(p, tile_slots, s);
  });
  return static_cast<int>(status);
}
