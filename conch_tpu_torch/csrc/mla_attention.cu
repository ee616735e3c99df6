// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Absorbed multi-head latent attention over the packed latent cache (K11).
//
// Replaces conch_tpu/kernels/attention/mla_attention.py:_mla_dma_kernel and
// its launcher mla_attention_launcher. Varlen, paged, causal or non-causal
// MQA: every query head of a sequence reads one shared stream of packed
// cache rows [c_kv | k_pe | 0-pad] (packed 640 for DeepSeek-V2-Lite). The
// score is q_cat . row over all `packed` columns, at scale * kv_scale; the
// value is the row's first `latent` (512) columns; the output (total_q,
// heads, latent) is the f32 accumulator over the softmax sum, times
// kv_scale.
//
// Bound on the H100: bytes at decode (16 heads x (640 + 512) x 2
// operations per 1280-byte row, 29 per byte, far below the card's ~295),
// operations at prefill (a 512-row step multiplies that by the query
// tokens of a sequence). MLA's saving is that one cached row serves every
// head, so a block's M rows are (token, head) rows of one sequence: the
// flattened rows t * 64 .. t * 64 + 63 of its (q_len x heads) queries
// (4 tokens of 16 heads; at decode one token, 48 rows idle).
//
// The launch plan comes from shapes alone, in Python
// (kernels/attention/mla_attention.py:mla_tile_plan): the grid has
// cdiv(total_q * heads, 64) + batch tile slots, at least the step's
// (sequence, tile) pairs, and a block finds its pair from cu_seqlens_q on
// the device (find_tile; slots past the last pair exit); split z of a
// tile walks its keys [z * split_len, ..) up to the tile's last row's
// limit, the splits aimed at two waves of working blocks. The wrapper
// reads no tensor value on the host.
//
// Design of the bf16 kernel (the layout of DeepSeek's FlashMLA kernel for
// Hopper, github.com/deepseek-ai/FlashMLA: 64-row warpgroup tiles, the
// latent accumulator split between two consumer warpgroups):
//  - three warpgroups: a producer and two consumers. The producer
//    (setmaxnreg down to 88 registers) copies the Q tile and then the
//    split's keys, 32 a stage, into a ring of `stages` stages (16-byte
//    cp.async into the 128-byte swizzled layout that wgmma reads, zero-
//    filled past the split), one block-table lookup a thread and 16 keys,
//    made a stage ahead. Each thread's copies arrive on the stage's `full`
//    mbarrier as they land (cp.async.mbarrier.arrive.noinc), so every
//    stage of the ring is in flight; the consumers fence the stage
//    (fence.proxy.async) before wgmma reads it. int8 and e4m3 rows go by
//    cp.async into a staging area after the ring (one stage of one-byte
//    rows; at packed 896 it leaves room for one stage), then each
//    producer thread widens the pieces it copied to bf16 exactly
//    (widen8_bf16: byte permutes, not the conversion unit) into the
//    stage, fences and signals it. A stage is refilled after both
//    consumers arrive on its `empty` mbarrier;
//  - each consumer (setmaxnreg up to 208) owns latent / 2 columns of the
//    64 x latent f32 accumulator (128 registers a thread at latent 512;
//    without the exchange the consumers spill and the kernel runs 3x
//    slower).
//    Per stage it computes S = Q . K^T over all packed columns with
//    wgmma.m64n32k16 from shared memory (Q and K both K-major), the
//    masked online softmax in base 2 in registers, P rounded to bf16 in
//    registers as the A operand of O += P . V (wgmma.m64n64k16, A from
//    registers, B = the same stage's rows read MN-major: V is the first
//    `latent` columns of K). Both consumers compute the same S, so no
//    barrier or shared memory joins them;
//  - with one split a consumer writes (O / l) * v_scale in bf16;
//    otherwise its unnormalized O and (max, sum) go to an f32 workspace
//    and a merge kernel, launched as a programmatic dependent (its launch
//    overlaps this grid's end), combines the live splits by log-sum-exp in
//    a fixed order, four columns a thread and eight splits' loads ahead of
//    their sums.
// Shared memory decides the shape: Q for 64 rows at packed 640 is 80 KB and
// a 64-key stage another 80 KB, so Q and two such stages (240 KB) exceed
// the 227 KB a block may use; 32-key stages of 40 KB leave room for three
// (200 KB at packed 640, four below packed 576; a one-byte cache's
// staging area takes a stage's rows in bytes beside them). Packed up to
// 896 keeps two stages. One block an SM.
// What sets the pace (tools/k11_tile_sweep.py, PERF.md): a stage takes
// about 2.2 us on one block whatever its copies (without them, 2.16): the
// consumers' chain of S, its wait, the softmax, PV and its wait, in step
// in both warpgroups; S is about a third of it. Dropped after timing: two
// stages, 16-key stages, scores by mma.sync (at decode too), the score
// product split between the consumers and joined through shared memory
// (its two barriers a stage cost what it saved), the next tile's S issued
// under the softmax (ptxas then serializes the wgmmas, or spills past
// 208 registers a thread), and persistent blocks (one an SM, walking the
// work items: a block's items then run one after another).
//
// Rounding follows the TPU kernel: bf16 q and rows into the tensor cores,
// f32 scores, p rounded to bf16 for PV, f32 accumulation and softmax sum.
// int8 and e4m3 latent caches (quantized on store) go through the same
// kernel under bf16 queries: their rows widen to bf16 exactly (both types
// fit bf16's 8-bit mantissa and its exponent range), and kv_scale folds
// into the score scale and the output.
//
// Rows past cu_seqlens_q[batch] are padding. They come out as the TPU
// launcher leaves them: its clamped gather gives padding row t the output
// of token min(t - cu_seqlens_q[batch], max_seqlen_q - 1) of the last
// sequence, or zeros where that sequence has no such token. A MoE layer
// after the attention routes the padding rows too, and their first
// choices take capacity from later choices, so the served tokens depend on
// it. With one split, the block that owns a token writes its copies and
// the blocks of split 0 write the zero rows; with splits the merge writes
// every row.
//
// f32 queries (the tests' dtype; no served model) keep a CUDA-core kernel,
// f32 throughout, over f32, int8 or e4m3 caches (a cache-type template
// parameter; an e4m3 cache rounds q and p to bf16, as the TPU kernel's
// matrix-unit type for it does): a block takes the plan's tiles and
// splits and walks its 64 rows 16 at a time.

#include "quant_gemm_mainloop.cuh"

namespace conch {
namespace mla {

using qgemm::desc_sw128;
using qgemm::fence_operands;
using qgemm::mbar_init;
using qgemm::mbar_wait;
using qgemm::smem_u32;
using qgemm::wgmma_commit;
using qgemm::wgmma_fence;
using qgemm::wgmma_wait0;

constexpr int kRows = 64;                         // M rows a tile: (token, head) rows of one sequence
constexpr int kKeys = 32;                         // keys a stage
constexpr int kChunk = 64;                        // bf16 columns of one 128-byte swizzled row
constexpr int kQChunkBytes = kRows * 128;         // one 64-column chunk of the Q tile
constexpr int kKChunkBytes = kKeys * 128;         // one 64-column chunk of a stage
constexpr int kConsumers = 2;                     // consumer warpgroups, latent / 2 columns each
constexpr int kThreads = 128 * (1 + kConsumers);  // the producer warpgroup first
constexpr int kMaxStages = 4;
constexpr int kMaxSplits = 64;
constexpr int kMaxPacked = 896;
constexpr int kSmemLimit = 232448;
constexpr int kSmemSlack = 1024 + 2 * kMaxStages * 8;  // aligning the base to 1024 bytes, the mbarriers
constexpr int kProducerRegs = 88;   // setmaxnreg: the producer gives registers up,
constexpr int kConsumerRegs = 208;  // the consumers take them (88 + 2 x 208 = 504 a lane)
constexpr int kF32Threads = 256;
constexpr int kF32Rows = 16;  // rows a pass of the f32 kernel
constexpr int kF32Keys = 32;
constexpr int kF32Cols = 2;  // latent <= 512 = 2 x 256 threads
constexpr int kMergeThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* query;  // (total_q, heads, packed)
  void* out;          // (total_q, heads, latent)
  const void* cache;  // (pages, page_size, packed): one layer
  const int32_t* cu_seqlens_q;
  const int32_t* seq_lens;
  const int32_t* block_table;  // (batch, max_pages)
  float* part_acc;             // (splits, total_q, heads, latent) when splits > 1
  float* part_ml;              // (splits, total_q, heads, 2): running max (base 2), softmax sum
  int total_q, batch, max_pages, heads, page_size, packed, latent, max_seqlen_q, causal;
  int split_len, splits, stages, cache_type;
  int staging;  // one-byte caches: the staging area's byte offset (kKeys rows of `packed` bytes)
  float score_scale;  // scale * kv_scale * log2(e)
  float v_scale;
};

// The one-byte caches' staging area, after the ring (none for bf16).
__host__ __device__ __forceinline__ uint32_t staging_bytes(const Params& p) {
  return p.cache_type == kBFloat16 ? 0 : kKeys * p.packed;
}

// One tile: flattened (token, head) rows row0 .. row0 + rows - 1 of
// sequence b, and the keys [0, hi) its last row sees.
struct Tile {
  int b, q0, q_len, seq_k, row0, rows, hi;
};

__device__ __forceinline__ Tile tile_of(const Params& p, int b, int tile) {
  Tile t;
  t.b = b;
  t.q0 = p.cu_seqlens_q[b];
  t.q_len = p.cu_seqlens_q[b + 1] - t.q0;
  t.seq_k = p.seq_lens[b];
  t.row0 = tile * kRows;
  t.rows = min(kRows, t.q_len * p.heads - t.row0);
  const int last = (t.row0 + t.rows - 1) / p.heads;
  t.hi = max(min(p.causal ? t.seq_k - t.q_len + last + 1 : t.seq_k, t.seq_k), 0);
  return t;
}

// Tile slot `slot`'s (sequence, tile) pair: the tiles in sequence order,
// cdiv(q_len * heads, 64) a sequence. False past the last pair. Each warp
// finds it alone: lane l counts sequence base + l's tiles, a prefix sum by
// shuffles and a ballot give the sequence, 32 sequences a round, so the
// lookups of a round are one load's latency.
__device__ __forceinline__ bool find_tile(const Params& p, int slot, Tile& t) {
  const int lane = threadIdx.x & 31;
  int rem = slot;
  for (int base = 0; base < p.batch; base += 32) {
    const int b = base + lane;
    const int tiles = b < p.batch ? ((p.cu_seqlens_q[b + 1] - p.cu_seqlens_q[b]) * p.heads + kRows - 1) / kRows : 0;
    int upto = tiles;  // tiles of sequences base .. b
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, upto, off);
      if (lane >= off) upto += v;
    }
    const unsigned past = __ballot_sync(0xffffffffu, upto > rem);  // sequences whose tiles reach past the slot
    if (past != 0) {
      const int first = __ffs(past) - 1;
      const int before = __shfl_sync(0xffffffffu, upto - tiles, first);
      t = tile_of(p, base + first, rem - before);
      return true;
    }
    rem -= __shfl_sync(0xffffffffu, upto, 31);
  }
  return false;
}

// The sequence that owns packed query row `row` < cu_seqlens_q[batch]: the
// last b with cu_seqlens_q[b] <= row (zero-length sequences own no row), by
// a ballot over 32 sequences a round.
__device__ __forceinline__ int sequence_of(const Params& p, int row) {
  const int lane = threadIdx.x & 31;
  for (int base = 0;; base += 32) {
    const int b = base + lane;
    const unsigned past = __ballot_sync(0xffffffffu, b < p.batch && p.cu_seqlens_q[b + 1] > row);
    if (past != 0) return base + __ffs(past) - 1;
  }
}

// Last visible key of tile row r, or -1 for a row past the tile's rows.
__device__ __forceinline__ int row_limit(const Params& p, const Tile& t, int r) {
  if (r >= t.rows) return -1;
  return p.causal ? t.seq_k - t.q_len + (t.row0 + r) / p.heads : t.seq_k - 1;
}

// Splits of a tile with keys to walk (the merge reads these).
__device__ __forceinline__ int live_splits(const Params& p, int hi) {
  return hi > 0 ? min((hi + p.split_len - 1) / p.split_len, p.splits) : 0;
}

// Writes two neighbouring output columns (col, col + 1) of token i, head h
// of the tile's sequence, and the padding rows that the TPU launcher's
// clamped gather maps to it when the sequence is the last one.
template <typename T>
__device__ __forceinline__ void store2(const Params& p, const Tile& t, int i, int h, int col, float v0, float v1) {
  T* out = static_cast<T*>(p.out);
  auto put = [&](int row) {
    T* dst = out + (static_cast<int64_t>(row) * p.heads + h) * p.latent + col;
    dst[0] = from_float<T>(v0);
    dst[1] = from_float<T>(v1);
  };
  put(t.q0 + i);
  if (t.b == p.batch - 1 && i < p.max_seqlen_q) {
    const int total = p.cu_seqlens_q[p.batch];
    const int end = i < p.max_seqlen_q - 1 ? min(total + i + 1, p.total_q) : p.total_q;
    for (int row = total + i; row < end; ++row) put(row);
  }
}

// The padding rows whose token the last sequence does not have: zeros,
// shared out among the blocks of split 0 (one split only).
template <typename T>
__device__ __forceinline__ void zero_padding_rows(const Params& p, int threads) {
  const int total = p.cu_seqlens_q[p.batch];
  const int last_len = p.cu_seqlens_q[p.batch] - p.cu_seqlens_q[p.batch - 1];
  T* out = static_cast<T*>(p.out);
  const int width = p.heads * p.latent;
  for (int row = total + blockIdx.x; row < p.total_q; row += gridDim.x) {
    if (min(row - total, p.max_seqlen_q - 1) < last_len) continue;  // a copy, written by its token's block
    for (int idx = threadIdx.x; idx < width; idx += threads) {
      out[static_cast<int64_t>(row) * width + idx] = from_float<T>(0.0f);
    }
  }
}

__device__ __forceinline__ float* partial_acc(const Params& p, int split, int64_t head_row, int col) {
  return p.part_acc + (static_cast<int64_t>(split) * p.total_q * p.heads + head_row) * p.latent + col;
}
__device__ __forceinline__ float* partial_ml(const Params& p, int split, int64_t head_row) {
  return p.part_ml + (static_cast<int64_t>(split) * p.total_q * p.heads + head_row) * 2;
}

// -- PTX -----------------------------------------------------------------------

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
// One arrival on `bar` once every cp.async this thread has issued so far has
// landed (the barrier's count includes it).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
// Orders this thread's generic-proxy writes to shared memory (cp.async,
// st.shared) before the async proxy's reads (wgmma).
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Byte offset of the 16-byte piece `piece` (columns 8 piece .. 8 piece + 7
// of a 64-column chunk) of row r in a 128-byte swizzled, 1024-byte
// aligned chunk.
__device__ __forceinline__ uint32_t swizzled(int r, int piece) { return r * 128 + ((piece ^ (r & 7)) << 4); }

// wgmma's descriptor of an MN-major bf16 operand with the 128-byte
// swizzle: rows of 64 values (128 bytes) along N, 8-row atoms along K
// 1024 bytes apart. With one 64-column atom along N (m64n64) only the
// K-atom stride is read; both offsets carry it.
__device__ __forceinline__ uint64_t desc_mn_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// d[N / 2] (+)= A[64 x 16] . B[16 x N]: both from shared memory, K-major
// (N = the keys of a stage).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// 16-key stages: the variant tools/k11_tile_sweep.py times.
template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[32] += A[64 x 16] . B[16 x 64]: A from registers (the mma.m16n8k16 A
// layout, warp w of the warpgroup holding rows 16w .. 16w + 15), B from
// shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64_t(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Keeps the A fragments alive (unmodified) until the wgmmas reading them
// have completed.
__device__ __forceinline__ void hold(uint32_t (&a)[kKeys / 16][4]) {
#pragma unroll
  for (int k = 0; k < kKeys / 16; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// -- the bf16 kernel: producer ----------------------------------------------------

// The cache rows of a stage's keys k0 .. k0 + kKeys - 1 that thread `pt`
// copies (key pass * 16 + pt / 8 of each pass; invalid past s_hi): one
// block-table lookup a pass, made a stage ahead of the copies.
constexpr int kPasses = kKeys / 16;
struct StageRows {
  int64_t row[kPasses];
  bool valid[kPasses];
};

__device__ __forceinline__ StageRows stage_rows(const Params& p, const Tile& t, int k0, int s_hi, int pt) {
  const int32_t* bt = p.block_table + static_cast<int64_t>(t.b) * p.max_pages;
  StageRows r;
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
    const int pos = k0 + pass * 16 + (pt >> 3);
    r.valid[pass] = pos < s_hi;
    r.row[pass] = r.valid[pass] ? (static_cast<int64_t>(bt[pos / p.page_size]) * p.page_size + pos % p.page_size) *
                                      p.packed
                                : 0;
  }
  return r;
}

// One stage: 8 threads a key, 16 keys a pass, thread `pt` taking 16-byte
// pieces pt % 8, pt % 8 + 8, ... of its key's row (zeros past s_hi). bf16
// rows go by cp.async into the stage (one piece of each 64-column chunk);
// one-byte rows by cp.async into the staging area, every piece in flight
// at once, then, landed, each thread widens the pieces it copied into the
// stage (no other thread reads them, so no barrier).
__device__ __forceinline__ void copy_stage(const Params& p, uint8_t* smem, uint32_t stage_off, const StageRows& r,
                                           int pt) {
  const int sub = pt & 7;
  if (p.cache_type == kBFloat16) {
    const int chunks = p.packed / kChunk;
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      const int j = pass * 16 + (pt >> 3);
      const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(p.cache) + r.row[pass] + 8 * sub;
      for (int c = 0; c < chunks; ++c) {
        cp_async16(smem_u32(smem) + stage_off + c * kKChunkBytes + swizzled(j, sub), src + c * kChunk,
                   r.valid[pass] ? 16 : 0);
      }
    }
    return;
  }
  // Columns 16 u .. 16 u + 15, u = sub + 8 k: chunk u / 4, pieces 2 (u % 4) and 2 (u % 4) + 1.
  const int pieces = p.packed / 16;
  const uint8_t* cache = static_cast<const uint8_t*>(p.cache);
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
    const int j = pass * 16 + (pt >> 3);
    for (int u = sub; u < pieces; u += 8) {
      cp_async16(smem_u32(smem) + p.staging + j * p.packed + 16 * u, cache + r.row[pass] + 16 * u,
                 r.valid[pass] ? 16 : 0);
    }
  }
  cp_async_wait_all();
  const bool int8 = p.cache_type == kInt8;
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
    const int j = pass * 16 + (pt >> 3);
    for (int u = sub; u < pieces; u += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(smem + p.staging + j * p.packed + 16 * u);
      const uint2 first = make_uint2(raw.x, raw.y), second = make_uint2(raw.z, raw.w);
      const uint4 lo = int8 ? widen8_bf16<int8_t>(first) : widen8_bf16<__nv_fp8_e4m3>(first);
      const uint4 hi = int8 ? widen8_bf16<int8_t>(second) : widen8_bf16<__nv_fp8_e4m3>(second);
      uint8_t* base = smem + stage_off + (u >> 2) * kKChunkBytes;
      *reinterpret_cast<uint4*>(base + swizzled(j, 2 * (u & 3))) = lo;
      *reinterpret_cast<uint4*>(base + swizzled(j, 2 * (u & 3) + 1)) = hi;
    }
  }
}

// The Q tile: 64 rows (zeros past the tile's rows), 8 threads a row.
__device__ __forceinline__ void load_q(const Params& p, const Tile& t, uint8_t* smem, int pt) {
  const __nv_bfloat16* query = static_cast<const __nv_bfloat16*>(p.query);
  const int sub = pt & 7;
  const int chunks = p.packed / kChunk;
  for (int r = pt >> 3; r < kRows; r += 16) {
    const bool valid = r < t.rows;
    const __nv_bfloat16* src =
        query + (valid ? (static_cast<int64_t>(t.q0) * p.heads + t.row0 + r) * p.packed : 0) + 8 * sub;
    for (int c = 0; c < chunks; ++c) {
      cp_async16(smem_u32(smem) + c * kQChunkBytes + swizzled(r, sub), src + c * kChunk, valid ? 16 : 0);
    }
  }
}

// -- the bf16 kernel ------------------------------------------------------------

// NC: the 64-column latent chunks each consumer warpgroup owns (latent =
// 128 NC). Block (x, z) takes split z of tile slot x.
template <int NC>
__global__ void __launch_bounds__(kThreads, 1) mla_wgmma_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int chunks = p.packed / kChunk;
  const uint32_t q_bytes = chunks * kQChunkBytes;
  const uint32_t stage_bytes = chunks * kKChunkBytes;
  const uint32_t bars = smem_u32(smem) + q_bytes + p.stages * stage_bytes + staging_bytes(p);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kMaxStages + s); };
  const int tid = threadIdx.x;
  const int split = blockIdx.y;

  if (split == 0 && p.splits == 1) zero_padding_rows<__nv_bfloat16>(p, kThreads);
  Tile t;
  if (!find_tile(p, blockIdx.x, t)) return;
  const int s_lo = split * p.split_len;
  const int s_hi = min(s_lo + p.split_len, t.hi);
  // With splits the merge writes what a split without keys would.
  if (s_lo >= s_hi && p.splits > 1) return;
  const int tiles = s_hi > s_lo ? (s_hi - s_lo + kKeys - 1) / kKeys : 0;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full(s), 128);
      mbar_init(empty(s), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // Producer: Q with the first stage, then each stage as soon as the
    // consumers have released its slot; the next stage's block-table
    // lookups go out before that wait. bf16 copies arrive on the stage's
    // `full` barrier as they land (the consumers fence them for wgmma);
    // one-byte rows are stored, fenced and signalled here.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const bool async_copy = p.cache_type == kBFloat16;
    StageRows rows = stage_rows(p, t, s_lo, s_hi, tid);
    for (int i = 0; i < tiles; ++i) {
      const int st = i % p.stages;
      if (i >= p.stages) mbar_wait(empty(st), ((i / p.stages) + 1) & 1);
      if (i == 0) load_q(p, t, smem, tid);
      copy_stage(p, smem, q_bytes + st * stage_bytes, rows, tid);
      if (async_copy) {
        cp_async_arrive(full(st));
      } else {
        fence_proxy_async();  // copy_stage waited for its copies, the Q tile's among them
        mbar_arrive(full(st));
      }
      if (i + 1 < tiles) rows = stage_rows(p, t, s_lo + (i + 1) * kKeys, s_hi, tid);
    }
    cp_async_wait_all();
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cw = tid / 128 - 1;  // consumer warpgroup: latent chunks cw * NC .. cw * NC + NC - 1
  const int warp = (tid / 32) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) lim[h] = row_limit(p, t, warp * 16 + g + 8 * h);
  float o[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[c][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const uint32_t q_addr = smem_u32(smem);

  for (int i = 0; i < tiles; ++i) {
    const int st = i % p.stages;
    mbar_wait(full(st), (i / p.stages) & 1);
    fence_proxy_async();  // the stage's cp.async writes, before wgmma reads them
    const uint32_t k_addr = q_addr + q_bytes + st * stage_bytes;
    // S = Q . K^T over every packed column.
    float s[kKeys / 2];
#pragma unroll
    for (int e = 0; e < kKeys / 2; ++e) s[e] = 0.0f;
    fence_operands(s);
    wgmma_fence();
    for (int c = 0; c < chunks; ++c) {  // 64-column chunks, four k16 steps each
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wgmma_ss<kKeys>(s, desc_sw128(q_addr + c * kQChunkBytes + 32 * k),
                        desc_sw128(k_addr + c * kKChunkBytes + 32 * k), c > 0 || k > 0);
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_operands(s);
    // Logits in base 2, masked past the split and past each row's limit;
    // s[4j + e] is row g + 8 (e >> 1), key 8j + 2 tig + (e & 1).
    const int k0 = s_lo + i * kKeys;
#pragma unroll
    for (int e = 0; e < kKeys / 2; ++e) {
      const int key = k0 + 8 * (e >> 2) + 2 * tig + (e & 1);
      s[e] = (key < s_hi && key <= lim[(e >> 1) & 1]) ? s[e] * p.score_scale : -INFINITY;
    }
    // Online softmax of rows g (h 0) and g + 8 (h 1); a quad of lanes holds a row.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;  // a row that has seen no key yet
      const float alpha = exp2f(m[h] - m_use);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        s[4 * j + 2 * h] = exp2f(s[4 * j + 2 * h] - m_use);
        s[4 * j + 2 * h + 1] = exp2f(s[4 * j + 2 * h + 1] - m_use);
        sum += s[4 * j + 2 * h] + s[4 * j + 2 * h + 1];
      }
      l[h] = l[h] * alpha + sum;
      m[h] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[c][4 * j + 2 * h] *= alpha;
          o[c][4 * j + 2 * h + 1] *= alpha;
        }
    }
    // O += P . V: P rounded to bf16 as the A operand (keys 16 kk .. 16 kk + 15).
    uint32_t a[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      a[kk][0] = pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]);
      a[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
      a[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
      a[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_operands(o[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        wgmma_rs_n64_t(o[c], a[kk], desc_mn_sw128(k_addr + (cw * NC + c) * kKChunkBytes + kk * 2048));
      }
    wgmma_commit();
    wgmma_wait0();
    hold(a);
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_operands(o[c]);
    mbar_arrive(empty(st));
  }

  // o[c][4j + e] is row 16 warp + g + 8 (e >> 1), column (cw NC + c) 64 + 8j + 2 tig + (e & 1).
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = warp * 16 + g + 8 * h;
    if (r >= t.rows) continue;
    const int i = (t.row0 + r) / p.heads;
    const int head = (t.row0 + r) % p.heads;
    const int64_t head_row = (static_cast<int64_t>(t.q0) + i) * p.heads + head;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = (cw * NC + c) * kChunk + 8 * j + 2 * tig;
        const float v0 = o[c][4 * j + 2 * h], v1 = o[c][4 * j + 2 * h + 1];
        if (p.splits == 1) {
          store2<__nv_bfloat16>(p, t, i, head, col, l[h] > 0.0f ? v0 / l[h] * p.v_scale : 0.0f,
                                l[h] > 0.0f ? v1 / l[h] * p.v_scale : 0.0f);
        } else {
          *reinterpret_cast<float2*>(partial_acc(p, split, head_row, col)) = make_float2(v0, v1);
        }
      }
    if (p.splits > 1 && cw == 0 && tig == 0) {
      float* ml = partial_ml(p, split, head_row);
      ml[0] = m[h];
      ml[1] = l[h];
    }
  }
  // The merge may start launching (it waits for this grid to finish before
  // it reads the workspace).
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// -- the f32 kernel ---------------------------------------------------------------

struct F32Smem {
  static constexpr int kSStride = kF32Keys + 4;
  static __host__ __device__ size_t stats_off() { return kF32Keys * sizeof(int64_t); }
  static __host__ __device__ size_t s_off() { return stats_off() + 4 * kF32Rows * sizeof(float); }
  static __host__ __device__ size_t q_off() { return s_off() + kF32Rows * kSStride * sizeof(float); }
  static __host__ __device__ size_t bytes(int packed) { return q_off() + size_t(kF32Rows) * packed * sizeof(float); }
};

// Online-softmax update of one key tile: s_s holds the tile's masked scores
// (base 2); turns them into p in place, and rescales each row's running max
// and sum. Every thread of the block calls it.
__device__ __forceinline__ void f32_softmax(float* s_s, float* m_s, float* l_s, float* alpha_s, bool bf16_p) {
  constexpr int kPerRow = kF32Threads / kF32Rows;  // threads per row, contiguous lanes of one warp
  const int r = threadIdx.x / kPerRow;
  const int sub = threadIdx.x % kPerRow;
  float mx = -INFINITY;
  for (int j = sub; j < kF32Keys; j += kPerRow) mx = fmaxf(mx, s_s[r * F32Smem::kSStride + j]);
#pragma unroll
  for (int off = kPerRow / 2; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float m_old = m_s[r];
  const float m_new = fmaxf(m_old, mx);
  float sum = 0.0f;
  for (int j = sub; j < kF32Keys; j += kPerRow) {
    float* sj = s_s + r * F32Smem::kSStride + j;
    const float pj = m_new == -INFINITY ? 0.0f : exp2f(*sj - m_new);
    sum += pj;
    *sj = bf16_p ? __bfloat162float(__float2bfloat16(pj)) : pj;
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

// f32 queries over a cache of element type C (f32, int8, e4m3): the plan's
// 64-row tiles, 16 rows a pass, tiles of 32 cached rows, CUDA cores. S
// phase: warp w takes keys w, w + 8, ...; its lanes split the packed
// columns and sum by shuffles. PV phase: thread c owns latent columns c
// and c + 256 of the pass's rows.
template <typename C>
__global__ void __launch_bounds__(kF32Threads) mla_f32_kernel(const __grid_constant__ Params p) {
  constexpr bool kBf16Mxu = std::is_same_v<C, __nv_fp8_e4m3>;  // the TPU kernel's matrix-unit type
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* row_s = reinterpret_cast<int64_t*>(smem);
  float* m_s = reinterpret_cast<float*>(smem + F32Smem::stats_off());
  float* l_s = m_s + kF32Rows;
  float* alpha_s = l_s + kF32Rows;
  int* lim_s = reinterpret_cast<int*>(alpha_s + kF32Rows);
  float* s_s = reinterpret_cast<float*>(smem + F32Smem::s_off());
  float* q_s = reinterpret_cast<float*>(smem + F32Smem::q_off());
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int split = blockIdx.y;

  if (split == 0 && p.splits == 1) zero_padding_rows<float>(p, kF32Threads);
  Tile t;
  if (!find_tile(p, blockIdx.x, t)) return;
  const int s_lo = split * p.split_len;
  const int s_hi = min(s_lo + p.split_len, t.hi);
  if (s_lo >= s_hi && p.splits > 1) return;
  const float* query = static_cast<const float*>(p.query);
  const C* cache = static_cast<const C*>(p.cache);
  const int32_t* bt = p.block_table + static_cast<int64_t>(t.b) * p.max_pages;
  float* out = static_cast<float*>(p.out);

  for (int pass = 0; pass * kF32Rows < t.rows; ++pass) {
    const int r0 = pass * kF32Rows;
    __syncthreads();  // the previous pass is done with q_s and the stats
    for (int idx = tid; idx < kF32Rows * p.packed; idx += kF32Threads) {
      const int r = idx / p.packed;
      float v = 0.0f;
      if (r0 + r < t.rows) {
        v = query[(static_cast<int64_t>(t.q0) * p.heads + t.row0 + r0 + r) * p.packed + idx % p.packed];
      }
      q_s[idx] = kBf16Mxu ? __bfloat162float(__float2bfloat16(v)) : v;
    }
    for (int r = tid; r < kF32Rows; r += kF32Threads) {
      m_s[r] = -INFINITY;
      l_s[r] = 0.0f;
      lim_s[r] = row_limit(p, t, r0 + r);
    }
    float acc[kF32Rows][kF32Cols];
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r)
#pragma unroll
      for (int c = 0; c < kF32Cols; ++c) acc[r][c] = 0.0f;

    for (int lo = s_lo; lo < s_hi; lo += kF32Keys) {
      const int n = min(kF32Keys, s_hi - lo);
      __syncthreads();
      for (int j = tid; j < kF32Keys; j += kF32Threads) {
        const int pos = lo + j;
        row_s[j] = j < n ? (static_cast<int64_t>(bt[pos / p.page_size]) * p.page_size + pos % p.page_size) * p.packed
                         : -1;
      }
      __syncthreads();
      for (int j = warp; j < kF32Keys; j += kF32Threads / 32) {
        float part[kF32Rows];
#pragma unroll
        for (int r = 0; r < kF32Rows; ++r) part[r] = 0.0f;
        if (j < n) {
          const C* k_row = cache + row_s[j];
          for (int d = lane; d < p.packed; d += 32) {
            const float kd = to_float(k_row[d]);
#pragma unroll
            for (int r = 0; r < kF32Rows; ++r) part[r] += q_s[r * p.packed + d] * kd;
          }
        }
#pragma unroll
        for (int r = 0; r < kF32Rows; ++r) {
          const float s = warp_sum(part[r]);
          if (lane == 0) {
            s_s[r * F32Smem::kSStride + j] = (j < n && lo + j <= lim_s[r]) ? s * p.score_scale : -INFINITY;
          }
        }
      }
      __syncthreads();
      f32_softmax(s_s, m_s, l_s, alpha_s, kBf16Mxu);
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kF32Cols; ++c) {
        const int d = tid + c * kF32Threads;
        if (d >= p.latent) continue;
#pragma unroll
        for (int r = 0; r < kF32Rows; ++r) acc[r][c] *= alpha_s[r];
        for (int j = 0; j < n; ++j) {
          const float vd = to_float(cache[row_s[j] + d]);
#pragma unroll
          for (int r = 0; r < kF32Rows; ++r) acc[r][c] += s_s[r * F32Smem::kSStride + j] * vd;
        }
      }
    }
    __syncthreads();

    // Columns d and d + 256 are not neighbours: store them one at a time.
#pragma unroll
    for (int c = 0; c < kF32Cols; ++c) {
      const int d = tid + c * kF32Threads;
      if (d >= p.latent) continue;
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) {
        if (r0 + r >= t.rows) continue;
        const int i = (t.row0 + r0 + r) / p.heads;
        const int h = (t.row0 + r0 + r) % p.heads;
        const int64_t head_row = (static_cast<int64_t>(t.q0) + i) * p.heads + h;
        if (p.splits > 1) {
          *partial_acc(p, split, head_row, d) = acc[r][c];
          continue;
        }
        const float l = l_s[r];
        const float v = l > 0.0f ? acc[r][c] / l * p.v_scale : 0.0f;
        out[head_row * p.latent + d] = v;
        if (t.b == p.batch - 1 && i < p.max_seqlen_q) {
          const int total = p.cu_seqlens_q[p.batch];
          const int end = i < p.max_seqlen_q - 1 ? min(total + i + 1, p.total_q) : p.total_q;
          for (int prow = total + i; prow < end; ++prow) {
            out[(static_cast<int64_t>(prow) * p.heads + h) * p.latent + d] = v;
          }
        }
      }
    }
    if (p.splits > 1) {
      for (int r = tid; r < kF32Rows; r += kF32Threads) {
        if (r0 + r >= t.rows) continue;
        const int row = t.row0 + r0 + r;
        float* ml = partial_ml(p, split, static_cast<int64_t>(t.q0) * p.heads + row);
        ml[0] = m_s[r];
        ml[1] = l_s[r];
      }
    }
  }
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// -- the merge --------------------------------------------------------------------

// Merges the live splits of one (row, head): split z carries weight w_z =
// 2^(m_z - m), m the largest of their maxima; the output is (sum_z w_z
// acc_z / sum_z w_z l_z) * v_scale, the splits taken in order. A split in
// which the row saw no key has m_z = -inf and weight 0. A padding row
// merges the splits of the token the TPU launcher's clamped gather gives
// it, or is zero.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads) mla_merge_kernel(const __grid_constant__ Params p) {
  __shared__ float w_s[kMaxSplits];
  __shared__ float l_s;
  const int row = blockIdx.x;
  const int h = blockIdx.y;
  const int total = p.cu_seqlens_q[p.batch];
  int b = p.batch - 1, src = -1;
  if (row < total) {
    b = sequence_of(p, row);
    src = row;
  } else {
    const int i = min(row - total, p.max_seqlen_q - 1);
    if (i < total - p.cu_seqlens_q[b]) src = p.cu_seqlens_q[b] + i;
  }
  int live = 0;
  if (src >= 0) {
    const Tile t = tile_of(p, b, ((src - p.cu_seqlens_q[b]) * p.heads + h) / kRows);
    live = live_splits(p, t.hi);
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the split grid has finished and its stores are visible
  const int64_t head_row = static_cast<int64_t>(src) * p.heads + h;
  if (threadIdx.x < 32) {
    float m_z[2], mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int z = threadIdx.x + 32 * u;
      m_z[u] = z < live ? partial_ml(p, z, head_row)[0] : -INFINITY;
      mx = fmaxf(mx, m_z[u]);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int z = threadIdx.x + 32 * u;
      if (z < live) {
        const float w = mx == -INFINITY ? 0.0f : exp2f(m_z[u] - mx);
        w_s[z] = w;
        sum += partial_ml(p, z, head_row)[1] * w;
      }
    }
    sum = warp_sum(sum);
    if (threadIdx.x == 0) l_s = sum;
  }
  __syncthreads();
  // Four columns a thread; the splits' loads eight at a time, ahead of
  // their sums (which go in split order).
  T* out = static_cast<T*>(p.out) + (static_cast<int64_t>(row) * p.heads + h) * p.latent;
  const float l = l_s;
  for (int col = 4 * threadIdx.x; col < p.latent; col += 4 * kMergeThreads) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int z0 = 0; z0 < live; z0 += 8) {
      float4 part[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        part[u] = z0 + u < live ? *reinterpret_cast<const float4*>(partial_acc(p, z0 + u, head_row, col))
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (z0 + u >= live) break;
        const float w = w_s[z0 + u];
        acc[0] += part[u].x * w;
        acc[1] += part[u].y * w;
        acc[2] += part[u].z * w;
        acc[3] += part[u].w * w;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) out[col + k] = from_float<T>(l > 0.0f ? acc[k] / l * p.v_scale : 0.0f);
  }
}

// The split grid, then (with splits) the merge as its programmatic dependent.
template <typename T, typename Kernel>
cudaError_t launch(const Params& p, Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream) {
  cudaError_t status =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (status != cudaSuccess) return status;
  kernel<<<grid, threads, smem, stream>>>(p);
  status = cudaGetLastError();
  if (status != cudaSuccess || p.splits == 1) return status;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(p.total_q, p.heads);
  config.blockDim = dim3(kMergeThreads);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  status = cudaLaunchKernelEx(&config, mla_merge_kernel<T>, p);
  if (status != cudaSuccess) return status;
  return cudaGetLastError();
}

size_t wgmma_smem(int packed, int stages) {
  return static_cast<size_t>(packed / kChunk) * (kQChunkBytes + stages * kKChunkBytes) + kSmemSlack;
}

cudaError_t launch_wgmma(const Params& p, dim3 grid, cudaStream_t stream) {
  const size_t smem = wgmma_smem(p.packed, p.stages) + staging_bytes(p);
  switch (p.latent / 128) {
    case 1: return launch<__nv_bfloat16>(p, mla_wgmma_kernel<1>, grid, kThreads, smem, stream);
    case 2: return launch<__nv_bfloat16>(p, mla_wgmma_kernel<2>, grid, kThreads, smem, stream);
    case 3: return launch<__nv_bfloat16>(p, mla_wgmma_kernel<3>, grid, kThreads, smem, stream);
    default: return launch<__nv_bfloat16>(p, mla_wgmma_kernel<4>, grid, kThreads, smem, stream);
  }
}

cudaError_t launch_f32(const Params& p, dim3 grid, cudaStream_t stream) {
  const size_t smem = F32Smem::bytes(p.packed);
  switch (p.cache_type) {
    case kFloat32: return launch<float>(p, mla_f32_kernel<float>, grid, kF32Threads, smem, stream);
    case kInt8: return launch<float>(p, mla_f32_kernel<int8_t>, grid, kF32Threads, smem, stream);
    default: return launch<float>(p, mla_f32_kernel<__nv_fp8_e4m3>, grid, kF32Threads, smem, stream);
  }
}

}  // namespace mla
}  // namespace conch

// query (total_q, heads, packed) and out (total_q, heads, latent) in
// `dtype` (bf16 or f32); the cache layer (pages, page_size, packed) in
// `cache_dtype`: bf16, int8 or e4m3 under bf16 queries, f32, int8 or e4m3
// under f32 queries. The plan (mla_tile_plan): rows (64), tile_slots (at
// least the step's (sequence, tile) pairs), kv_tile (32), stages (ring
// stages of the bf16 kernel, 2 to 4, that fit beside Q), split_len and
// splits (1 to 64); with splits > 1, part_acc (splits, total_q, heads,
// latent) and part_ml (splits, total_q, heads, 2) f32. Plans the kernels cannot run
// are refused.
extern "C" int conch_mla_attention(const void* query, void* out, const void* cache, const void* cu_seqlens_q,
                                   const void* seq_lens, const void* block_table, void* part_acc, void* part_ml,
                                   int total_q, int batch, int max_pages, int heads, int page_size, int packed,
                                   int latent, int max_seqlen_q, int causal, int rows, int tile_slots, int kv_tile,
                                   int stages, int split_len, int splits, float scale, float v_scale, int dtype,
                                   int cache_dtype, void* stream) {
  using namespace conch::mla;
  auto s = static_cast<cudaStream_t>(stream);
  if (total_q == 0 || batch == 0) return static_cast<int>(cudaSuccess);
  const bool bf16 = dtype == conch::kBFloat16;
  const bool cache_ok = cache_dtype == conch::kInt8 || cache_dtype == conch::kFloat8E4M3 ||
                        cache_dtype == (bf16 ? conch::kBFloat16 : conch::kFloat32);
  if ((!bf16 && dtype != conch::kFloat32) || !cache_ok || packed % 128 != 0 || (bf16 && packed > kMaxPacked) ||
      latent % 128 != 0 || latent > 512 || latent > packed || heads < 1 || page_size < 1 || max_seqlen_q < 1 ||
      rows != kRows || kv_tile != kKeys || tile_slots < 1 || split_len < 1 || split_len % kKeys != 0 || splits < 1 ||
      splits > kMaxSplits || (splits > 1 && (part_acc == nullptr || part_ml == nullptr)) ||
      (bf16 && (stages < 2 || stages > kMaxStages || wgmma_smem(packed, stages) > static_cast<size_t>(kSmemLimit)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
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
  p.splits = splits;
  p.stages = stages;
  p.cache_type = cache_dtype;
  p.score_scale = scale * kLog2e;
  p.v_scale = v_scale;
  if (bf16 && cache_dtype != conch::kBFloat16) {
    // The staging area goes after the ring: as many of the plan's stages as
    // fit beside it (all but at packed 896).
    while (p.stages > 1 && wgmma_smem(packed, p.stages) + staging_bytes(p) > static_cast<size_t>(kSmemLimit)) {
      --p.stages;
    }
    p.staging = (packed / kChunk) * (kQChunkBytes + p.stages * kKChunkBytes);
  }
  const dim3 grid(tile_slots, splits);
  return static_cast<int>(bf16 ? launch_wgmma(p, grid, s) : launch_f32(p, grid, s));
}
