// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Absorbed multi-head latent attention over the packed latent cache (K11).
//
// Replaces conch_tpu/kernels/attention/mla_attention.py:_mla_dma_kernel and
// its launcher mla_attention_launcher. Varlen, paged, causal MQA: every
// query head of a sequence reads one shared stream of packed cache rows
// [c_kv | k_pe | 0-pad] (packed 640 for DeepSeek-V2-Lite). The score is
// q_cat . row over the whole packed row, at scale * kv_scale; the value is
// the row's first `latent` (512) columns; the output (total_q, heads,
// latent) is the f32 accumulator over the softmax sum, times kv_scale.
//
// Bound on the H100: bytes at decode (16 heads x (640 + 512) x 2
// operations per 1280-byte row, 29 per byte, far below the card's ~295),
// operations at prefill (a 512-row step multiplies that by the query
// tokens of a sequence). MLA's whole saving is that one cached row serves
// every head, so the design keeps that property: one block per (sequence,
// tile of packed (token, head) rows, KV split). The tile's rows form the
// M dimension of mma.sync m16n8k16 tiles (16 rows = the 16 heads of one
// token at V2-Lite) against a shared-memory tile of 64 packed rows that
// the block reads once: S = Q . K^T over 640 columns, an online softmax in
// f32 (base 2), then O += P . V over the 512 latent columns of the same
// shared-memory rows (ldmatrix.trans gives the B fragments). Decode has one
// token per sequence, so a block per sequence would fill 8 of 132 SMs at
// batch 8: when the (sequence, tile) blocks are fewer than two waves the
// wrapper splits each KV range into equal pieces, one block each, and a
// second kernel merges the pieces' (max, sum, accumulator) by
// log-sum-exp. Rounding follows the TPU kernel on a bf16 cache: bf16 q
// and rows into the tensor cores, f32 scores, p rounded to bf16 for the
// PV product, f32 accumulation; the f32 cache (the tests' dtype) takes a
// CUDA-core path with the same blocks, f32 throughout. int8 and e4m3
// latent caches (quantized on store, with bf16 queries) go through the
// bf16 kernel: their rows convert to bf16 as they enter shared memory,
// exactly (both types fit bf16's 8-bit mantissa and its exponent range),
// and kv_scale folds into the score scale and the output as in the TPU
// kernel; the tensor-core stages are those of the bf16 cache.
//
// Rows past cu_seqlens_q[batch] are padding. They come out as the TPU
// launcher leaves them: its clamped gather gives padding row t the output
// of token min(t - cu_seqlens_q[batch], max_seqlen_q - 1) of the last
// sequence, or zeros where that sequence has no such token. A MoE layer
// after the attention routes the padding rows too, and their first
// choices take capacity from later choices, so the served tokens depend on
// it.

#include "gemm_common.cuh"

namespace conch {

constexpr int kMlaThreads = 256;
constexpr int kMlaWarps = kMlaThreads / 32;
constexpr int kMlaKeysBf16 = 64;  // cached rows per shared-memory tile
constexpr int kMlaKeysF32 = 32;
constexpr int kMlaMaxLatentTiles = 8;  // n8 tiles of latent a warp owns: latent <= 512
constexpr int kMlaMaxSplits = 256;
constexpr float kLog2e = 1.4426950408889634f;

struct MlaParams {
  const void* query;  // (total_q, heads, packed)
  void* out;          // (total_q, heads, latent)
  const void* cache;  // (pages, page_size, packed): one layer
  const int32_t* cu_seqlens_q;
  const int32_t* seq_lens;
  const int32_t* block_table;  // (batch, max_pages)
  float* part_acc;             // (nsplit, total_q, heads, latent) when nsplit > 1
  float* part_ml;              // (nsplit, total_q, heads, 2)
  int total_q, batch, max_pages, heads, page_size, packed, latent, max_seqlen_q, causal;
  int split_len, nsplit;
  float score_scale;  // scale * kv_scale * log2(e)
  float v_scale;
};

// What one block needs of its sequence: the query rows, the KV range of its
// split, and each row's last visible position.
struct MlaTile {
  int b, q0, q_len, seq_k, row0, kv_lo, kv_hi;
};

__device__ __forceinline__ MlaTile mla_tile(const MlaParams& p, int rows) {
  MlaTile t;
  t.b = blockIdx.y;
  t.q0 = p.cu_seqlens_q[t.b];
  t.q_len = p.cu_seqlens_q[t.b + 1] - t.q0;
  t.seq_k = p.seq_lens[t.b];
  t.row0 = blockIdx.x * rows;
  const int last = min((t.row0 + rows - 1) / p.heads, t.q_len - 1);
  int kv_limit = p.causal ? t.seq_k - t.q_len + last + 1 : t.seq_k;
  kv_limit = max(min(kv_limit, t.seq_k), 0);
  t.kv_lo = blockIdx.z * p.split_len;
  t.kv_hi = min(t.kv_lo + p.split_len, kv_limit);
  return t;
}

// Last visible key position of tile row r, or -1 for a row of no token.
__device__ __forceinline__ int mla_row_limit(const MlaParams& p, const MlaTile& t, int r) {
  const int i = (t.row0 + r) / p.heads;
  if (i >= t.q_len) return -1;
  return p.causal ? t.seq_k - t.q_len + i : t.seq_k - 1;
}

// Writes two neighbouring output columns (col, col + 1) of token i, head h
// of the tile's sequence: its own row when the token exists, and the
// padding rows that the TPU launcher's clamped gather maps to it when the
// sequence is the last one (zeros for a token the sequence does not have).
template <typename T>
__device__ __forceinline__ void mla_store2(const MlaParams& p, const MlaTile& t, int i, int h, int col, float v0,
                                           float v1) {
  T* out = static_cast<T*>(p.out);
  auto put = [&](int row) {
    T* dst = out + (static_cast<int64_t>(row) * p.heads + h) * p.latent + col;
    dst[0] = from_float<T>(v0);
    dst[1] = from_float<T>(v1);
  };
  if (i < t.q_len) put(t.q0 + i);
  if (t.b == p.batch - 1 && i < p.max_seqlen_q) {
    const int total = p.cu_seqlens_q[p.batch];
    if (i < p.max_seqlen_q - 1) {
      if (total + i < p.total_q) put(total + i);
    } else {
      for (int row = total + i; row < p.total_q; ++row) put(row);
    }
  }
}

// Online-softmax update of one KV tile: s_s holds the tile's masked scores
// (base 2); turns them into p (written to p_s as P), and rescales each row's
// running max and sum. Every thread of the block calls it.
template <int ROWS, int KEYS, typename P>
__device__ __forceinline__ void mla_softmax(const float* s_s, int s_stride, P* p_s, int p_stride, float* m_s,
                                            float* l_s, float* alpha_s) {
  constexpr int kPerRow = kMlaThreads / ROWS;  // threads per row, contiguous lanes of one warp
  const int r = threadIdx.x / kPerRow;
  const int sub = threadIdx.x % kPerRow;
  float mx = -INFINITY;
  for (int j = sub; j < KEYS; j += kPerRow) mx = fmaxf(mx, s_s[r * s_stride + j]);
#pragma unroll
  for (int off = kPerRow / 2; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float m_old = m_s[r];
  const float m_new = fmaxf(m_old, mx);
  float sum = 0.0f;
  for (int j = sub; j < KEYS; j += kPerRow) {
    const float pj = m_new == -INFINITY ? 0.0f : exp2f(s_s[r * s_stride + j] - m_new);
    sum += pj;
    p_s[r * p_stride + j] = from_float<P>(pj);
  }
#pragma unroll
  for (int off = kPerRow / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (sub == 0) {
    const float alpha = m_new == -INFINITY ? 1.0f : exp2f(m_old - m_new);  // exp2(-inf) = 0 on the first tile
    l_s[r] = l_s[r] * alpha + sum;
    m_s[r] = m_new;
    alpha_s[r] = alpha;
  }
}

// Rows of one KV tile: offsets (in elements) of positions lo .. lo + n - 1
// through the block table, -1 past n.
__device__ __forceinline__ void mla_tile_rows(const MlaParams& p, const MlaTile& t, int lo, int n, int keys,
                                              int64_t* row_s) {
  const int32_t* bt = p.block_table + static_cast<int64_t>(t.b) * p.max_pages;
  for (int j = threadIdx.x; j < keys; j += kMlaThreads) {
    int64_t off = -1;
    if (j < n) {
      const int pos = lo + j;
      const int64_t page = bt[min(pos / p.page_size, p.max_pages - 1)];
      off = (page * p.page_size + pos % p.page_size) * p.packed;
    }
    row_s[j] = off;
  }
}

// Epilogue of a split block (nsplit > 1): the unnormalized accumulator and
// the (max, sum) of each row that has a token.
__device__ __forceinline__ void mla_store_partial_ml(const MlaParams& p, const MlaTile& t, int rows,
                                                     const float* m_s, const float* l_s) {
  for (int r = threadIdx.x; r < rows; r += kMlaThreads) {
    const int i = (t.row0 + r) / p.heads;
    if (i >= t.q_len) continue;
    const int h = (t.row0 + r) % p.heads;
    float* ml = p.part_ml + ((static_cast<int64_t>(blockIdx.z) * p.total_q + t.q0 + i) * p.heads + h) * 2;
    ml[0] = m_s[r];
    ml[1] = l_s[r];
  }
}

__device__ __forceinline__ float* mla_partial_acc(const MlaParams& p, const MlaTile& t, int i, int h, int col) {
  return p.part_acc + ((static_cast<int64_t>(blockIdx.z) * p.total_q + t.q0 + i) * p.heads + h) * p.latent + col;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Shared-memory layout of the bf16 kernel (bytes), rows padded by 8 bf16 so
// that fragment loads and ldmatrix rows fall on distinct banks.
template <int MT>
struct MlaBf16Smem {
  static constexpr int kRows = 16 * MT;
  static constexpr int kSStride = kMlaKeysBf16 + 4;  // f32 scores
  static constexpr int kPStride = kMlaKeysBf16 + 8;  // bf16 probabilities
  static __host__ __device__ int row_stride(int packed) { return packed + 8; }
  static __host__ __device__ size_t rows_off() { return 0; }
  static __host__ __device__ size_t stats_off() { return rows_off() + kMlaKeysBf16 * sizeof(int64_t); }
  static __host__ __device__ size_t s_off() { return stats_off() + 4 * kRows * sizeof(float); }
  static __host__ __device__ size_t p_off() { return s_off() + kRows * kSStride * sizeof(float); }
  static __host__ __device__ size_t q_off() { return p_off() + kRows * kPStride * 2; }
  static __host__ __device__ size_t kv_off(int packed) { return q_off() + size_t(kRows) * row_stride(packed) * 2; }
  static __host__ __device__ size_t bytes(int packed) {
    return kv_off(packed) + size_t(kMlaKeysBf16) * row_stride(packed) * 2;
  }
};

// bf16 kernel: MT m16 row tiles (16 * MT packed rows) per block, 8 warps.
// S phase: warp w computes rows of m-tile w % MT against 8 / MT n8 tiles
// of keys. PV phase: warp w owns latent columns [w * latent / 8, (w + 1) *
// latent / 8) for every row. C: the cache element type (bf16, int8, e4m3).
template <int MT, typename C>
__global__ void __launch_bounds__(kMlaThreads, 1) mla_bf16_kernel(const MlaParams p) {
  using Smem = MlaBf16Smem<MT>;
  constexpr int kRows = Smem::kRows;
  constexpr int kKeys = kMlaKeysBf16;
  // The 8 n8 key tiles of a KV tile are split among the 8 / MT warps that share an m-tile.
  constexpr int kKeyTilesPerWarp = (kKeys / 8) / (kMlaWarps / MT);
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* row_s = reinterpret_cast<int64_t*>(smem + Smem::rows_off());
  float* m_s = reinterpret_cast<float*>(smem + Smem::stats_off());
  float* l_s = m_s + kRows;
  float* alpha_s = l_s + kRows;
  int* lim_s = reinterpret_cast<int*>(alpha_s + kRows);
  float* s_s = reinterpret_cast<float*>(smem + Smem::s_off());
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(smem + Smem::p_off());
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + Smem::q_off());
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem + Smem::kv_off(p.packed));

  const MlaTile t = mla_tile(p, kRows);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int stride = Smem::row_stride(p.packed);
  const int words = stride / 2;  // 32-bit words a shared row
  const int latent_tiles = p.latent / 64;  // n8 tiles a warp owns

  if (t.row0 >= t.q_len * p.heads) {
    // No token in this tile: only the last sequence's padding rows may need zeros.
    if (p.nsplit > 1 || t.b != p.batch - 1) return;
    for (int idx = tid; idx < kRows * (p.latent / 2); idx += kMlaThreads) {
      const int r = idx / (p.latent / 2);
      const int row = t.row0 + r;
      mla_store2<__nv_bfloat16>(p, t, row / p.heads, row % p.heads, 2 * (idx % (p.latent / 2)), 0.0f, 0.0f);
    }
    return;
  }

  // The tile's queries; rows of no token are zeros.
  const int chunks = p.packed / 8;
  const __nv_bfloat16* query = static_cast<const __nv_bfloat16*>(p.query);
  for (int idx = tid; idx < kRows * chunks; idx += kMlaThreads) {
    const int r = idx / chunks;
    const int c = idx % chunks;
    const int row = t.row0 + r;
    const int i = row / p.heads;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (i < t.q_len) {
      const int64_t q_row = static_cast<int64_t>(t.q0 + i) * p.heads + row % p.heads;
      v = *reinterpret_cast<const uint4*>(query + q_row * p.packed + c * 8);
    }
    *reinterpret_cast<uint4*>(q_s + r * stride + c * 8) = v;
  }
  for (int r = tid; r < kRows; r += kMlaThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.0f;
    lim_s[r] = mla_row_limit(p, t, r);
  }

  float acc[MT][kMlaMaxLatentTiles][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kMlaMaxLatentTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  const C* cache = static_cast<const C*>(p.cache);
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q_s);
  const uint32_t* kv32 = reinterpret_cast<const uint32_t*>(kv_s);
  const uint32_t* p32 = reinterpret_cast<const uint32_t*>(p_s);
  const int s_mt = warp % MT;
  const int s_key0 = (warp / MT) * kKeyTilesPerWarp * 8;

  for (int lo = t.kv_lo; lo < t.kv_hi; lo += kKeys) {
    const int n = min(kKeys, t.kv_hi - lo);
    __syncthreads();  // the previous tile's PV reads of kv_s are done
    mla_tile_rows(p, t, lo, n, kKeys, row_s);
    __syncthreads();
    for (int idx = tid; idx < kKeys * chunks; idx += kMlaThreads) {
      const int j = idx / chunks;
      const int c = idx % chunks;
      const int64_t off = row_s[j];
      // Rows past n are zero-filled: their p is 0, and 0 * garbage could be NaN.
      if constexpr (std::is_same_v<C, __nv_bfloat16>) {
        cp_async16(kv_s + j * stride + c * 8, off >= 0 ? cache + off + c * 8 : cache, off >= 0 ? 16 : 0);
      } else {
        const uint4 v = off >= 0 ? widen8_bf16<C>(*reinterpret_cast<const uint2*>(cache + off + c * 8))
                                 : make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(kv_s + j * stride + c * 8) = v;
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // S = Q . K^T for this warp's m-tile and key tiles, over all packed columns.
    float sacc[kKeyTilesPerWarp][4];
#pragma unroll
    for (int s = 0; s < kKeyTilesPerWarp; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[s][e] = 0.0f;
    const uint32_t* qa = q32 + (s_mt * 16 + g) * words + tig;
    for (int kw = 0; kw < p.packed / 2; kw += 8) {
      const uint32_t a0 = qa[kw], a1 = qa[8 * words + kw], a2 = qa[kw + 4], a3 = qa[8 * words + kw + 4];
#pragma unroll
      for (int s = 0; s < kKeyTilesPerWarp; ++s) {
        const uint32_t* kb = kv32 + (s_key0 + s * 8 + g) * words + tig + kw;
        mma_bf16_16816(sacc[s], a0, a1, a2, a3, kb[0], kb[4]);
      }
    }
#pragma unroll
    for (int s = 0; s < kKeyTilesPerWarp; ++s) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = s_mt * 16 + g + 8 * half;
        const int j = s_key0 + s * 8 + 2 * tig;
        const int lim = lim_s[r];
        float2 v;
        v.x = (j < n && lo + j <= lim) ? sacc[s][2 * half] * p.score_scale : -INFINITY;
        v.y = (j + 1 < n && lo + j + 1 <= lim) ? sacc[s][2 * half + 1] * p.score_scale : -INFINITY;
        *reinterpret_cast<float2*>(s_s + r * Smem::kSStride + j) = v;
      }
    }
    __syncthreads();
    mla_softmax<kRows, kKeys>(s_s, Smem::kSStride, p_s, Smem::kPStride, m_s, l_s, alpha_s);
    __syncthreads();

    // O = O * alpha + P . V over this warp's latent columns.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float a_lo = alpha_s[mt * 16 + g];
      const float a_hi = alpha_s[mt * 16 + g + 8];
#pragma unroll
      for (int nt = 0; nt < kMlaMaxLatentTiles; ++nt) {
        acc[mt][nt][0] *= a_lo;
        acc[mt][nt][1] *= a_lo;
        acc[mt][nt][2] *= a_hi;
        acc[mt][nt][3] *= a_hi;
      }
    }
    const int col0 = warp * latent_tiles * 8;
    const int m = lane >> 3;
    const int ld_row = (lane & 7) + 8 * (m & 1);
    const int ld_col = 8 * (m >> 1);
#pragma unroll
    for (int kk = 0; kk < kKeys; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint32_t* pa = p32 + (mt * 16 + g) * (Smem::kPStride / 2) + kk / 2 + tig;
        a[mt][0] = pa[0];
        a[mt][1] = pa[8 * (Smem::kPStride / 2)];
        a[mt][2] = pa[4];
        a[mt][3] = pa[8 * (Smem::kPStride / 2) + 4];
      }
#pragma unroll
      for (int np = 0; np < kMlaMaxLatentTiles / 2; ++np) {
        if (2 * np < latent_tiles) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, kv_s + (kk + ld_row) * stride + col0 + 16 * np + ld_col);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16_16816(acc[mt][2 * np], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[0], b[1]);
            mma_bf16_16816(acc[mt][2 * np + 1], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[2], b[3]);
          }
        }
      }
    }
  }
  __syncthreads();

  const int col0 = warp * latent_tiles * 8;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mt * 16 + g + 8 * half;
      const int row = t.row0 + r;
      const int i = row / p.heads;
      const int h = row % p.heads;
      const float l = l_s[r];
#pragma unroll
      for (int nt = 0; nt < kMlaMaxLatentTiles; ++nt) {
        if (nt >= latent_tiles) continue;
        const int col = col0 + nt * 8 + 2 * tig;
        const float v0 = acc[mt][nt][2 * half];
        const float v1 = acc[mt][nt][2 * half + 1];
        if (p.nsplit > 1) {
          if (i < t.q_len) *reinterpret_cast<float2*>(mla_partial_acc(p, t, i, h, col)) = make_float2(v0, v1);
        } else {
          mla_store2<__nv_bfloat16>(p, t, i, h, col, l > 0.0f ? v0 / l * p.v_scale : 0.0f,
                                    l > 0.0f ? v1 / l * p.v_scale : 0.0f);
        }
      }
    }
  }
  if (p.nsplit > 1) mla_store_partial_ml(p, t, kRows, m_s, l_s);
}

// f32 kernel (the tests' cache dtype): 16 packed rows a block, tiles of 32
// cached rows, CUDA cores. S phase: warp w takes keys w, w + 8, ...; its
// lanes split the packed columns and sum by shuffles. PV phase: thread c
// owns latent columns c and c + 256 of all 16 rows.
constexpr int kMlaF32Rows = 16;
constexpr int kMlaF32Cols = 2;  // latent <= 512 = 2 x 256 threads

struct MlaF32Smem {
  static constexpr int kSStride = kMlaKeysF32 + 4;
  static __host__ __device__ size_t stats_off() { return kMlaKeysF32 * sizeof(int64_t); }
  static __host__ __device__ size_t s_off() { return stats_off() + 4 * kMlaF32Rows * sizeof(float); }
  static __host__ __device__ size_t q_off() { return s_off() + kMlaF32Rows * kSStride * sizeof(float); }
  static __host__ __device__ size_t bytes(int packed) { return q_off() + size_t(kMlaF32Rows) * packed * sizeof(float); }
};

__global__ void __launch_bounds__(kMlaThreads) mla_f32_kernel(const MlaParams p) {
  constexpr int kRows = kMlaF32Rows;
  constexpr int kKeys = kMlaKeysF32;
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* row_s = reinterpret_cast<int64_t*>(smem);
  float* m_s = reinterpret_cast<float*>(smem + MlaF32Smem::stats_off());
  float* l_s = m_s + kRows;
  float* alpha_s = l_s + kRows;
  int* lim_s = reinterpret_cast<int*>(alpha_s + kRows);
  float* s_s = reinterpret_cast<float*>(smem + MlaF32Smem::s_off());
  float* q_s = reinterpret_cast<float*>(smem + MlaF32Smem::q_off());

  const MlaTile t = mla_tile(p, kRows);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if (t.row0 >= t.q_len * p.heads) {
    if (p.nsplit > 1 || t.b != p.batch - 1) return;
    for (int idx = tid; idx < kRows * (p.latent / 2); idx += kMlaThreads) {
      const int row = t.row0 + idx / (p.latent / 2);
      mla_store2<float>(p, t, row / p.heads, row % p.heads, 2 * (idx % (p.latent / 2)), 0.0f, 0.0f);
    }
    return;
  }

  const float* query = static_cast<const float*>(p.query);
  for (int idx = tid; idx < kRows * p.packed; idx += kMlaThreads) {
    const int r = idx / p.packed;
    const int row = t.row0 + r;
    const int i = row / p.heads;
    q_s[idx] = i < t.q_len
                   ? query[(static_cast<int64_t>(t.q0 + i) * p.heads + row % p.heads) * p.packed + idx % p.packed]
                   : 0.0f;
  }
  for (int r = tid; r < kRows; r += kMlaThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.0f;
    lim_s[r] = mla_row_limit(p, t, r);
  }
  float acc[kRows][kMlaF32Cols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kMlaF32Cols; ++c) acc[r][c] = 0.0f;

  const float* cache = static_cast<const float*>(p.cache);
  for (int lo = t.kv_lo; lo < t.kv_hi; lo += kKeys) {
    const int n = min(kKeys, t.kv_hi - lo);
    __syncthreads();
    mla_tile_rows(p, t, lo, n, kKeys, row_s);
    __syncthreads();
    for (int j = warp; j < kKeys; j += kMlaWarps) {
      float part[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) part[r] = 0.0f;
      if (j < n) {
        const float* k_row = cache + row_s[j];
        for (int d = lane; d < p.packed; d += 32) {
          const float kd = k_row[d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) part[r] += q_s[r * p.packed + d] * kd;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float s = warp_sum(part[r]);
        if (lane == 0) {
          s_s[r * MlaF32Smem::kSStride + j] = (j < n && lo + j <= lim_s[r]) ? s * p.score_scale : -INFINITY;
        }
      }
    }
    __syncthreads();
    mla_softmax<kRows, kKeys>(s_s, MlaF32Smem::kSStride, s_s, MlaF32Smem::kSStride, m_s, l_s, alpha_s);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kMlaF32Cols; ++c) {
      const int d = tid + c * kMlaThreads;
      if (d >= p.latent) continue;
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r][c] *= alpha_s[r];
      for (int j = 0; j < n; ++j) {
        const float vd = cache[row_s[j] + d];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][c] += s_s[r * MlaF32Smem::kSStride + j] * vd;
      }
    }
  }
  __syncthreads();

  // Columns d and d + 256 are not neighbours: store them one at a time.
  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int c = 0; c < kMlaF32Cols; ++c) {
    const int d = tid + c * kMlaThreads;
    if (d >= p.latent) continue;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = t.row0 + r;
      const int i = row / p.heads;
      const int h = row % p.heads;
      if (p.nsplit > 1) {
        if (i < t.q_len) *mla_partial_acc(p, t, i, h, d) = acc[r][c];
        continue;
      }
      const float l = l_s[r];
      const float v = l > 0.0f ? acc[r][c] / l * p.v_scale : 0.0f;
      if (i < t.q_len) out[(static_cast<int64_t>(t.q0 + i) * p.heads + h) * p.latent + d] = v;
      if (t.b == p.batch - 1 && i < p.max_seqlen_q) {
        const int total = p.cu_seqlens_q[p.batch];
        const int end = i < p.max_seqlen_q - 1 ? min(total + i + 1, p.total_q) : p.total_q;
        for (int prow = total + i; prow < end; ++prow) {
          out[(static_cast<int64_t>(prow) * p.heads + h) * p.latent + d] = v;
        }
      }
    }
  }
  if (p.nsplit > 1) mla_store_partial_ml(p, t, kRows, m_s, l_s);
}

// Merges the KV splits: one block per (token slot, sequence, head). Warp 0
// turns the splits' (max, sum) into weights in shared memory; then each
// thread sums its column pair over the splits. Splits that saw no visible
// key (sum 0) get weight 0 and are skipped, so their unwritten
// accumulators are never read.
template <typename T>
__global__ void __launch_bounds__(kMlaThreads) mla_merge_kernel(const MlaParams p) {
  __shared__ float w_s[kMlaMaxSplits];
  __shared__ float l_s;
  MlaTile t;
  t.b = blockIdx.y;
  t.q0 = p.cu_seqlens_q[t.b];
  t.q_len = p.cu_seqlens_q[t.b + 1] - t.q0;
  t.seq_k = p.seq_lens[t.b];
  t.row0 = 0;
  const int i = blockIdx.x;
  const int h = blockIdx.z;
  if (i >= t.q_len && (t.b != p.batch - 1 || i >= p.max_seqlen_q)) return;
  const bool has_token = i < t.q_len;
  const int64_t row = has_token ? static_cast<int64_t>(t.q0 + i) * p.heads + h : 0;
  const int64_t split_stride = static_cast<int64_t>(p.total_q) * p.heads;
  if (has_token && threadIdx.x < 32) {
    float m = -INFINITY;
    for (int s = threadIdx.x; s < p.nsplit; s += 32) {
      const float* ml = p.part_ml + (s * split_stride + row) * 2;
      if (ml[1] > 0.0f) m = fmaxf(m, ml[0]);
    }
    m = warp_max(m);
    float l = 0.0f;
    for (int s = threadIdx.x; s < p.nsplit; s += 32) {
      const float* ml = p.part_ml + (s * split_stride + row) * 2;
      const float w = ml[1] > 0.0f ? exp2f(ml[0] - m) : 0.0f;
      w_s[s] = w;
      l += ml[1] * w;
    }
    l = warp_sum(l);
    if (threadIdx.x == 0) l_s = l;
  }
  __syncthreads();
  for (int col = 2 * threadIdx.x; col < p.latent; col += 2 * kMlaThreads) {
    float v0 = 0.0f, v1 = 0.0f;
    if (has_token && l_s > 0.0f) {
      float a0 = 0.0f, a1 = 0.0f;
      for (int s = 0; s < p.nsplit; ++s) {
        const float w = w_s[s];
        if (w == 0.0f) continue;
        const float2 part = *reinterpret_cast<const float2*>(p.part_acc + (s * split_stride + row) * p.latent + col);
        a0 += part.x * w;
        a1 += part.y * w;
      }
      v0 = a0 / l_s * p.v_scale;
      v1 = a1 / l_s * p.v_scale;
    }
    mla_store2<T>(p, t, i, h, col, v0, v1);
  }
}

template <typename T>
int launch_merge(const MlaParams& p, cudaStream_t stream) {
  dim3 grid(p.max_seqlen_q, p.batch, p.heads);
  mla_merge_kernel<T><<<grid, kMlaThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int MT, typename C>
int launch_bf16(const MlaParams& p, cudaStream_t stream) {
  const size_t smem = MlaBf16Smem<MT>::bytes(p.packed);
  cudaError_t err = cudaFuncSetAttribute(mla_bf16_kernel<MT, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.max_seqlen_q * p.heads + 16 * MT - 1) / (16 * MT), p.batch, p.nsplit);
  mla_bf16_kernel<MT, C><<<grid, kMlaThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// bf16 queries over a cache of element type C, in MT m-tiles a block.
template <typename C>
int launch_bf16_tiles(const MlaParams& p, int m_tiles, cudaStream_t stream) {
  if (m_tiles == 4) return launch_bf16<4, C>(p, stream);
  if (m_tiles == 1) return launch_bf16<1, C>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_f32(const MlaParams& p, cudaStream_t stream) {
  const size_t smem = MlaF32Smem::bytes(p.packed);
  cudaError_t err =
      cudaFuncSetAttribute(mla_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.max_seqlen_q * p.heads + kMlaF32Rows - 1) / kMlaF32Rows, p.batch, p.nsplit);
  mla_f32_kernel<<<grid, kMlaThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace conch

// m_tiles: 16-row m tiles a bf16 block takes (1 or 4); f32 blocks take 16
// rows. nsplit > 1 needs part_acc and part_ml and runs the merge kernel
// after the split blocks. dtype: the query's and output's (bf16 or f32);
// cache_dtype: the cache's, the query's own or, under bf16 queries, int8
// or e4m3.
extern "C" int conch_mla_attention(const void* query, void* out, const void* cache, const void* cu_seqlens_q,
                                   const void* seq_lens, const void* block_table, void* part_acc, void* part_ml,
                                   int total_q, int batch, int max_pages, int heads, int page_size, int packed,
                                   int latent, int max_seqlen_q, int causal, int split_len, int nsplit, int m_tiles,
                                   float scale, float v_scale, int dtype, int cache_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (total_q == 0 || batch == 0) return static_cast<int>(cudaSuccess);
  if (packed % 128 != 0 || latent % 128 != 0 || latent > 512 || latent > packed || max_seqlen_q < 1 ||
      split_len < 1 || nsplit < 1 || nsplit > conch::kMlaMaxSplits ||
      (nsplit > 1 && (part_acc == nullptr || part_ml == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  conch::MlaParams p;
  p.query = query;
  p.out = out;
  p.cache = cache;
  p.cu_seqlens_q = static_cast<const int32_t*>(cu_seqlens_q);
  p.seq_lens = static_cast<const int32_t*>(seq_lens);
  p.block_table = static_cast<const int32_t*>(block_table);
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.total_q = total_q;
  p.batch = batch;
  p.max_pages = max_pages;
  p.heads = heads;
  p.page_size = page_size;
  p.packed = packed;
  p.latent = latent;
  p.max_seqlen_q = max_seqlen_q;
  p.causal = causal;
  p.split_len = split_len;
  p.nsplit = nsplit;
  p.score_scale = scale * conch::kLog2e;
  p.v_scale = v_scale;
  int code;
  if (dtype == conch::kBFloat16) {
    if (cache_dtype == conch::kBFloat16) {
      code = conch::launch_bf16_tiles<__nv_bfloat16>(p, m_tiles, s);
    } else if (cache_dtype == conch::kInt8) {
      code = conch::launch_bf16_tiles<int8_t>(p, m_tiles, s);
    } else if (cache_dtype == conch::kFloat8E4M3) {
      code = conch::launch_bf16_tiles<__nv_fp8_e4m3>(p, m_tiles, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (code == 0 && nsplit > 1) code = conch::launch_merge<__nv_bfloat16>(p, s);
  } else if (dtype == conch::kFloat32 && cache_dtype == conch::kFloat32) {
    code = conch::launch_f32(p, s);
    if (code == 0 && nsplit > 1) code = conch::launch_merge<float>(p, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return code;
}
