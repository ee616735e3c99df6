// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Greedy non-maximum suppression keep mask (K13c).
//
// Replaces conch_tpu/kernels/vision/nms.py:_nms_kernel: over N boxes sorted
// by descending score (f32 x1, y1, x2, y2 and area = (x2 - x1) * (y2 - y1)),
// box j is suppressed when a kept box i < j has IoU(i, j) > threshold; box i
// is kept when no kept box before it suppresses it. The TPU kernel walks i
// in a loop with the keep mask as its carry, computing IoU against all N
// boxes each step. Here the boxes go in 64-box words and the work is split
// in two kernels:
//   1. nms_mask_kernel writes the upper triangle of the (N, W) 64-bit
//      suppression mask, W = ceil(N / 64): bit k of word (i, c) is set when
//      box 64 c + k > i has IoU with box i above the threshold. Storage is
//      band-major: band w holds the 64 rows of word w, columns w .. W - 1,
//      each row padded to an even number of words; a band is cut into
//      chunks of `chunk_words` columns, chunk-major, so every chunk is one
//      contiguous, 16-byte-aligned run of 64 x width words (band_offset).
//      A block of 256 threads takes four row tiles against one column tile
//      held in shared memory.
//   2. nms_scan_kernel, one block, walks the words in order. A producer
//      thread streams the chunks, in order, into a ring of `stages` slots
//      in shared memory by TMA bulk copies (cp.async.bulk), each landing on
//      the slot's `full` mbarrier, several bands ahead; a slot is refilled
//      only after every consumer warp has arrived on its `empty` mbarrier.
//      Warp 0 resolves word w from the 64 diagonal words in registers with
//      a branch-free loop (box r is kept unless removed; removed |= kept ?
//      diag[r] : 0), then ORs the kept rows' next word (w + 1) with a
//      warp-wide reduction and carries it in a register: only that lies on
//      the serial path. The background warps OR the kept rows' later words
//      (w + 2 ..) into the shared `removed` bitmap meanwhile. Word w's
//      kept mask goes to them through an mbarrier (kept_bar, two used in
//      turns), and warp 0 resolves word w only once they have finished
//      band w - 2 (done_bar, two in turns): neither side runs more than one
//      phase ahead of the other, so parities never alias.
//   This equals the TPU loop's suppress = (iou > t) & (j > i) & keep_i.
// Exactness: the JAX test compares kept indices exactly, so the IoU is the
// TPU kernel's f32 arithmetic, operation for operation, with every product,
// sum and quotient rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn): nvcc would otherwise contract area + ai - inter into an FMA.
// Bound on the H100: operations (about 20 f32 operations per pair, N^2 / 2
// pairs); the scan's serial floor is N dependent resolve steps (a bit test
// and a predicated OR each).

#include <algorithm>

#include "bulk_copy.cuh"
#include "common.cuh"

namespace conch {
namespace {

constexpr int kNmsTile = 64;                              // boxes a word
constexpr int kNmsRowTiles = 4;                           // row tiles a mask block
constexpr int kNmsMaskThreads = kNmsTile * kNmsRowTiles;  // a thread a row
constexpr int kNmsBackgroundWarps = 4;  // 8 slow the resolver (tools/vision_diagnostics.py)
constexpr int kNmsBackgroundThreads = 32 * kNmsBackgroundWarps;
constexpr int kNmsScanThreads = 64 + kNmsBackgroundThreads;  // resolver warp, producer warp, background
constexpr int kNmsConsumerWarps = 1 + kNmsBackgroundWarps;   // arrivals that free a ring slot

// Words in each row of band w: W - w, rounded up to even.
__host__ __device__ __forceinline__ int band_row_words(int words, int w) { return (words - w + 1) & ~1; }

// First word of band w: 64 times the sum of band_row_words(u) for u < w, that
// is, of m over m = W - w + 1 .. W plus the odd m among them.
__host__ __device__ __forceinline__ int64_t band_offset(int words, int w) {
  const int64_t a = words - w + 1, b = words;
  return kNmsTile * ((a + b) * w / 2 + (b + 1) / 2 - a / 2);
}

__global__ void __launch_bounds__(kNmsMaskThreads) nms_mask_kernel(const float* __restrict__ x1,
                                                                  const float* __restrict__ y1,
                                                                  const float* __restrict__ x2,
                                                                  const float* __restrict__ y2,
                                                                  const float* __restrict__ area, int n,
                                                                  float threshold, uint64_t* __restrict__ mask,
                                                                  int words, int chunk_words) {
  const int col_tile = blockIdx.x, tile0 = blockIdx.y * kNmsRowTiles;
  if (tile0 > col_tile) return;  // every row tile below the diagonal: the scan reads none of it
  __shared__ float cx1[kNmsTile], cy1[kNmsTile], cx2[kNmsTile], cy2[kNmsTile], carea[kNmsTile];
  const int col0 = col_tile * kNmsTile;
  const int cols = min(kNmsTile, n - col0);
  if (threadIdx.x < cols) {
    const int j = col0 + threadIdx.x;
    cx1[threadIdx.x] = x1[j];
    cy1[threadIdx.x] = y1[j];
    cx2[threadIdx.x] = x2[j];
    cy2[threadIdx.x] = y2[j];
    carea[threadIdx.x] = area[j];
  }
  __syncthreads();
  const int row_tile = tile0 + threadIdx.x / kNmsTile, r = threadIdx.x % kNmsTile;
  if (row_tile > col_tile) return;
  const int i = row_tile * kNmsTile + r;
  uint64_t bits = 0;
  if (i < n) {  // rows past the last box (in the last band) store 0
    const float xi1 = x1[i], yi1 = y1[i], xi2 = x2[i], yi2 = y2[i], ai = area[i];
    for (int k = (col_tile == row_tile ? r + 1 : 0); k < cols; ++k) {
      const float inter_w = fmaxf(0.0f, __fsub_rn(fminf(cx2[k], xi2), fmaxf(cx1[k], xi1)));
      const float inter_h = fmaxf(0.0f, __fsub_rn(fminf(cy2[k], yi2), fmaxf(cy1[k], yi1)));
      const float inter = __fmul_rn(inter_w, inter_h);
      const float uni = __fsub_rn(__fadd_rn(carea[k], ai), inter);
      // inter == 0 gives iou 0 (+-0: equal in the compare) without the division.
      const float iou = uni > 0.0f && inter != 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
      if (iou > threshold) bits |= 1ull << k;
    }
  }
  const int j = col_tile - row_tile, chunk = j / chunk_words, jj = j - chunk * chunk_words;
  const int width = min(chunk_words, band_row_words(words, row_tile) - chunk * chunk_words);
  uint64_t* row = mask + band_offset(words, row_tile) + static_cast<int64_t>(kNmsTile) * chunk * chunk_words +
                  static_cast<int64_t>(r) * width;
  row[jj] = bits;
  if (col_tile == words - 1 && jj + 1 < width) row[jj + 1] = 0;  // an odd row's pad word
}

__global__ void __launch_bounds__(kNmsScanThreads) nms_scan_kernel(const uint64_t* __restrict__ mask, int n,
                                                                  int words, int chunk_words, int stages,
                                                                  bool* __restrict__ keep) {
  // Shared memory: the ring (stages x 64 x chunk_words words), the removed
  // bitmap (words, rounded up to even), two kept words, then the mbarriers:
  // full[stages], empty[stages], kept_bar[2], done_bar[2].
  extern __shared__ __align__(16) uint64_t smem[];
  const int stage_words = kNmsTile * chunk_words;
  uint64_t* ring = smem;
  uint64_t* removed = ring + static_cast<int64_t>(stages) * stage_words;
  uint64_t* kept_sh = removed + ((words + 1) & ~1);
  const uint32_t full = smem_addr(kept_sh + 2), empty = full + 8 * stages, kept_bar = empty + 8 * stages,
                 done_bar = kept_bar + 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int v = threadIdx.x; v < words; v += blockDim.x) removed[v] = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kNmsConsumerWarps);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(kept_bar + 8 * b, 1);
      mbar_init(done_bar + 8 * b, kNmsBackgroundThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto chunks = [&](int w) { return (band_row_words(words, w) + chunk_words - 1) / chunk_words; };
  auto width_of = [&](int w, int k) { return min(chunk_words, band_row_words(words, w) - k * chunk_words); };

  if (warp == 1) {  // the producer: every chunk in order, `stages` in flight
    if (lane != 0) return;
    int q = 0;
    for (int w = 0; w < words; ++w) {
      const uint64_t* band = mask + band_offset(words, w);
      for (int k = 0, nk = chunks(w); k < nk; ++k, ++q) {
        const int s = q % stages;
        if (q >= stages) mbar_wait(empty + 8 * s, (q / stages - 1) & 1);
        bulk_copy(smem_addr(ring + static_cast<int64_t>(s) * stage_words),
                  band + static_cast<int64_t>(kNmsTile) * k * chunk_words, kNmsTile * width_of(w, k) * 8,
                  full + 8 * s);
      }
    }
    return;
  }

  int q = 0;  // the chunk being consumed, in the producer's order
  if (warp == 0) {  // the resolver
    uint64_t next_removed = 0;  // word w's removals by word w - 1's kept boxes
    for (int w = 0; w < words; ++w) {
      int s = q % stages;
      mbar_wait(full + 8 * s, (q / stages) & 1);
      const uint64_t* band = ring + static_cast<int64_t>(s) * stage_words;
      const int width = width_of(w, 0);
      uint64_t diag[kNmsTile];
#pragma unroll
      for (int r = 0; r < kNmsTile; ++r) diag[r] = band[r * width];
      // Rows lane and lane + 32 of the next word (column 1; the pad word of
      // the last band).
      const uint64_t next_a = band[lane * width + 1], next_b = band[(lane + 32) * width + 1];
      if (w >= 2) mbar_wait(done_bar + 8 * (w & 1), ((w - 2) >> 1) & 1);
      const int rows = min(kNmsTile, n - w * kNmsTile);
      const uint64_t live = rows == kNmsTile ? ~0ull : (1ull << rows) - 1;
      uint64_t rem = removed[w] | next_removed | ~live;
#pragma unroll
      for (int r = 0; r < kNmsTile; ++r) {
        if (!((rem >> r) & 1)) rem |= diag[r];  // box r kept: it removes the later boxes it overlaps
      }
      const uint64_t kept = ~rem;
      if (lane == 0) {
        kept_sh[w & 1] = kept;
        mbar_arrive(kept_bar + 8 * (w & 1));
      }
      const int64_t ra = static_cast<int64_t>(w) * kNmsTile + lane, rb = ra + 32;
      if (ra < n) keep[ra] = (kept >> lane) & 1;
      if (rb < n) keep[rb] = (kept >> (lane + 32)) & 1;
      const uint64_t part = (((kept >> lane) & 1) ? next_a : 0) | (((kept >> (lane + 32)) & 1) ? next_b : 0);
      next_removed = static_cast<uint64_t>(__reduce_or_sync(0xffffffffu, static_cast<uint32_t>(part))) |
                     static_cast<uint64_t>(__reduce_or_sync(0xffffffffu, static_cast<uint32_t>(part >> 32))) << 32;
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
      ++q;
      for (int k = 1, nk = chunks(w); k < nk; ++k, ++q) {  // the band's other chunks: the background's
        s = q % stages;
        mbar_wait(full + 8 * s, (q / stages) & 1);
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
    }
    return;
  }

  // The background warps: band w's kept rows into the words after w + 1.
  const int t = threadIdx.x - 64;
  for (int w = 0; w < words; ++w) {
    mbar_wait(kept_bar + 8 * (w & 1), (w >> 1) & 1);
    const uint64_t kept = kept_sh[w & 1];
    const int last = words - w;  // band columns j < last are words w + j
    for (int k = 0, nk = chunks(w); k < nk; ++k, ++q) {
      const int s = q % stages;
      mbar_wait(full + 8 * s, (q / stages) & 1);
      const uint64_t* chunk = ring + static_cast<int64_t>(s) * stage_words;
      const int width = width_of(w, k), j0 = k * chunk_words;
      const int lo = max(2, j0), cols = min(last, j0 + width) - lo;
      if (kept != 0 && cols > 0) {
        // ``groups`` threads a column, thread g taking rows g, g + groups, ...:
        // neighbouring threads read neighbouring words of a row.
        const int groups = max(1, min(kNmsTile, kNmsBackgroundThreads / cols));
        for (int u = t; u < groups * cols; u += kNmsBackgroundThreads) {
          const int j = lo + u % cols, g = u / cols;
          uint64_t bits = 0;
#pragma unroll 8
          for (int r = g; r < kNmsTile; r += groups) bits |= ((kept >> r) & 1) ? chunk[r * width + j - j0] : 0;
          if (bits) atomicOr(reinterpret_cast<unsigned long long*>(&removed[w + j]), bits);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    mbar_arrive(done_bar + 8 * (w & 1));
  }
}

}  // namespace
}  // namespace conch

// x1, y1, x2, y2, area: (n,) f32 in score order; mask: the band-major
// triangle, mask_words 64-bit words (kernels/vision/nms.py:nms_plan);
// keep: (n,) bool. The plan: chunk_words (even), stages, smem_bytes of the
// scan's dynamic shared memory.
extern "C" int conch_nms_keep_mask(const void* x1, const void* y1, const void* x2, const void* y2, const void* area,
                                   int n, float threshold, void* mask, void* keep, int chunk_words, int stages,
                                   int smem_bytes, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (chunk_words < 2 || chunk_words % 2 || stages < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int words = (n + conch::kNmsTile - 1) / conch::kNmsTile;
  const dim3 grid(words, (words + conch::kNmsRowTiles - 1) / conch::kNmsRowTiles);
  conch::nms_mask_kernel<<<grid, conch::kNmsMaskThreads, 0, s>>>(
      static_cast<const float*>(x1), static_cast<const float*>(y1), static_cast<const float*>(x2),
      static_cast<const float*>(y2), static_cast<const float*>(area), n, threshold, static_cast<uint64_t*>(mask),
      words, chunk_words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(conch::nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  conch::nms_scan_kernel<<<1, conch::kNmsScanThreads, smem_bytes, s>>>(static_cast<const uint64_t*>(mask), n, words,
                                                                      chunk_words, stages, static_cast<bool*>(keep));
  return static_cast<int>(cudaGetLastError());
}
