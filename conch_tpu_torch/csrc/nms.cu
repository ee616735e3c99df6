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
// boxes each step. Here the work is split in two kernels:
//   1. nms_mask_kernel, one block of 64 threads per (64-row, 64-column)
//      tile on or above the diagonal: thread i writes the 64-bit word of
//      boxes j > i in the tile's columns whose IoU with i is > threshold;
//   2. nms_scan_kernel, one block: the boxes in 64-box words, in order. For
//      word w, one warp resolves the word's boxes in order from the
//      diagonal words (a box is kept unless an earlier kept box removed it),
//      then the block ORs the kept rows' later words into a "removed"
//      bitmap in shared memory. This equals the TPU loop's
//      suppress = (iou > t) & (j > i) & keep_i.
// Exactness: the JAX test compares kept indices exactly, so the IoU is the
// TPU kernel's f32 arithmetic, operation for operation, with every product,
// sum and quotient rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn): nvcc would otherwise contract area + ai - inter into an FMA.
// Bound on the H100: operations (about 20 f32 operations per pair, N^2 / 2
// pairs). The scan is serial over the words: per word, one shuffle per
// kept box in warp 0, then one round of independent loads of the kept
// rows' later words across the block.

#include <algorithm>

#include "common.cuh"

namespace conch {

constexpr int kNmsTile = 64;
constexpr int kNmsScanThreads = 256;

__global__ void __launch_bounds__(kNmsTile) nms_mask_kernel(const float* __restrict__ x1, const float* __restrict__ y1,
                                                           const float* __restrict__ x2, const float* __restrict__ y2,
                                                           const float* __restrict__ area, int n, float threshold,
                                                           uint64_t* __restrict__ mask, int words) {
  const int row_tile = blockIdx.y, col_tile = blockIdx.x;
  if (col_tile < row_tile) return;  // the scan reads only words on and above the diagonal
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
  const int i = row_tile * kNmsTile + threadIdx.x;
  if (i >= n) return;
  const float xi1 = x1[i], yi1 = y1[i], xi2 = x2[i], yi2 = y2[i], ai = area[i];
  uint64_t bits = 0;
  for (int k = (col_tile == row_tile ? threadIdx.x + 1 : 0); k < cols; ++k) {
    const float inter_w = fmaxf(0.0f, __fsub_rn(fminf(cx2[k], xi2), fmaxf(cx1[k], xi1)));
    const float inter_h = fmaxf(0.0f, __fsub_rn(fminf(cy2[k], yi2), fmaxf(cy1[k], yi1)));
    const float inter = __fmul_rn(inter_w, inter_h);
    const float uni = __fsub_rn(__fadd_rn(carea[k], ai), inter);
    const float iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
    if (iou > threshold) bits |= 1ull << k;
  }
  mask[static_cast<int64_t>(i) * words + col_tile] = bits;
}

__global__ void __launch_bounds__(kNmsScanThreads) nms_scan_kernel(const uint64_t* __restrict__ mask, int n, int words,
                                                                  bool* __restrict__ keep) {
  extern __shared__ uint64_t removed[];
  __shared__ uint64_t kept_word;
  for (int v = threadIdx.x; v < words; v += blockDim.x) removed[v] = 0;
  __syncthreads();
  const int lane = threadIdx.x % 32;
  // Warp 0's lane l holds the diagonal words of rows l and l + 32 of the
  // word it resolves next, loaded one word ahead.
  uint64_t da = 0, db = 0;
  auto load_diagonal = [&](int w) {
    const int64_t ra = static_cast<int64_t>(w) * kNmsTile + lane, rb = ra + 32;
    da = ra < n ? mask[ra * words + w] : 0;
    db = rb < n ? mask[rb * words + w] : 0;
  };
  if (threadIdx.x < 32) load_diagonal(0);
  for (int w = 0; w < words; ++w) {
    const int64_t row0 = static_cast<int64_t>(w) * kNmsTile;
    if (threadIdx.x < 32) {
      const int64_t ra = row0 + lane, rb = ra + 32;
      const int rows = min(kNmsTile, n - static_cast<int>(row0));
      const uint64_t live = rows == kNmsTile ? ~0ull : ((1ull << rows) - 1);
      uint64_t cur = removed[w], kept = 0;
      uint64_t cand = live & ~cur;
      while (cand) {  // the next box not removed, in order, is kept
        const int r = __ffsll(static_cast<long long>(cand)) - 1;
        const uint64_t d = __shfl_sync(0xffffffffu, r < 32 ? da : db, r & 31);
        kept |= 1ull << r;
        cur |= d;
        cand = live & ~cur & ~((2ull << r) - 1);  // boxes after r (r = 63: none)
      }
      if (lane == 0) kept_word = kept;
      if (ra < n) keep[ra] = (kept >> lane) & 1;
      if (rb < n) keep[rb] = (kept >> (lane + 32)) & 1;
    }
    __syncthreads();
    if (threadIdx.x < 32 && w + 1 < words) load_diagonal(w + 1);  // in flight during the OR below
    const uint64_t kept = kept_word;
    const int later = words - w - 1;  // the words after w (w < words - 1: all 64 rows are boxes)
    if (kept != 0 && later > 0) {
      // ``groups`` threads per later word v, thread g taking rows g, g +
      // groups, ...: neighbouring threads read neighbouring words of a row,
      // and a thread's loads are independent, so they are all in flight at
      // once. The word's OR goes into the bitmap by one shared atomic a thread.
      const int groups = max(1, min(kNmsTile, static_cast<int>(blockDim.x) / later));
      for (int t = threadIdx.x; t < groups * later; t += blockDim.x) {
        const int v = w + 1 + t % later, g = t / later;
        uint64_t bits = 0;
#pragma unroll 8
        for (int r = g; r < kNmsTile; r += groups) {
          const uint64_t row = mask[(row0 + r) * words + v];
          bits |= ((kept >> r) & 1) ? row : 0;
        }
        if (bits) atomicOr(reinterpret_cast<unsigned long long*>(&removed[v]), bits);
      }
    }
    __syncthreads();
  }
}

}  // namespace conch

// x1, y1, x2, y2, area: (n,) f32 in score order; mask: (n, words) 64-bit
// scratch, words = ceil(n / 64); keep: (n,) bool. Shared memory: words * 8
// bytes (<= 48 KB: n <= 393216).
extern "C" int conch_nms_keep_mask(const void* x1, const void* y1, const void* x2, const void* y2, const void* area,
                                   int n, float threshold, void* mask, void* keep, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  const int words = (n + conch::kNmsTile - 1) / conch::kNmsTile;
  const dim3 grid(words, words);
  conch::nms_mask_kernel<<<grid, conch::kNmsTile, 0, s>>>(
      static_cast<const float*>(x1), static_cast<const float*>(y1), static_cast<const float*>(x2),
      static_cast<const float*>(y2), static_cast<const float*>(area), n, threshold, static_cast<uint64_t*>(mask),
      words);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  conch::nms_scan_kernel<<<1, conch::kNmsScanThreads, words * sizeof(uint64_t), s>>>(
      static_cast<const uint64_t*>(mask), n, words, static_cast<bool*>(keep));
  return static_cast<int>(cudaGetLastError());
}
