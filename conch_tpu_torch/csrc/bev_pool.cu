// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// BEV pool forward (K13a) and backward (K13b).
//
// K13a replaces conch_tpu/kernels/vision/bev_pool.py:_interval_sums_kernel
// (per-interval f32 sums of image_feats) and :_placement_kernel (the
// scatter-add of those sums onto the (B*Z*X*Y, C) grid) with one kernel.
// K13b replaces :_grad_sums_kernel (a gather of each interval's cell row of
// grad_output) and :_grad_points_kernel (its broadcast to the interval's
// points) with one kernel. The TPU kernels build windowed one-hot matrices
// and contract them on the MXU because Mosaic has no gather or scatter;
// here the kernels read the rows they need directly.
//
// Contract (cells_sorted=True, as BEVFusion builds the intervals): the
// intervals come in ascending start and ascending flat-cell order, so
// intervals that share a cell are neighbours (dropped intervals aside), and
// they are disjoint. A cell is ((b*Z + z)*X + x)*Y + y from the interval's
// first point, geom row (x, y, z, b); a cell with any coordinate outside
// its range, or an interval that starts outside the points, is dropped
// (forward) and gives its points a zero gradient (backward). A run is the
// kept intervals of one cell, dropped ones between them skipped. No kernel
// reads or writes outside its tensors.
//
// K13a: the work is split over the points. Block b owns the kept intervals
// that start in its tile of `tile_points` points (kernels/vision/
// bev_pool.py:bev_forward_plan) and the runs whose first kept interval is
// one of them; it finishes the run it owns last even past its tile, and
// skips the intervals at its tile's head that continue a run an earlier
// block owns. So every kept interval and every run has one owner, and the
// block's one 32-way search over the starts and one look back (the cell of
// the last kept interval before its tile) replace a walk back per interval.
// A producer warp reads the intervals 32 at a time, a lane each, and lays
// the owned intervals' rows end to end (prefix sums across the lanes): the
// block's stream, cut into stages of `stage_rows` rows that go by TMA bulk
// copies (one for a stage whose rows are one span of feats, else one a
// piece) into a ring of `stages` slots of shared memory (`full` and `empty`
// mbarriers). Each stage's header lists its pieces (a part of one interval:
// rows, and flags that open or close the interval or its run) in segments
// (the pieces of one run); headers have a ring of stages + 1, so the
// producer fills the open stage's while the consumers read the others. A
// run's close is known at the next run's opening or the block's end, maybe
// a batch later: the stage holding an undecided piece waits for it. The
// consumer warps take (segment, channel vector) pairs, the vector as narrow
// as fills them (a long interval's stage gets a thread a channel), and add
// the rows in point order in f32: each interval's sum from 0, each run's
// sums in interval order from 0, one cast when the run closes. A run that
// crosses a stage carries its two sums through shared memory. No atomics,
// and every sum is the plain version's (reference/vision/vision.py), in its
// order, so the result is equal to it bit for bit. The output is
// torch.empty: the producer also writes zeros to the cells strictly
// between each owned run's cell and the kept cell before it (or the grid's
// head), to the cell of a run without rows, the owner of the last run to
// the grid's tail, and block 0 to the whole grid when no interval is kept;
// every grid row is written once. Rows that a TMA copy cannot move (a row
// or base not a multiple of 16 bytes) are read by the consumers straight
// from global memory, with the same pieces. Bound on the H100: bytes (every
// kept feature row read once, the grid written once). Measured
// (tools/vision_diagnostics.py): the ring is latency-bound (the producer and
// the consumers each wait on the other about half of a block's life), and
// shared memory caps the bytes in flight, so the plan takes two stages of
// about 18 KB and four consumer warps: five blocks, five producers, an SM.
//
// K13b: every output row written once, in the order of the points. A block
// takes 256 consecutive points, a warp 32 of them, a lane one. The warp
// finds the first interval starting at or after its first point by one
// 32-way search over `starts` (a lane a probe) and, by a step back over
// empty intervals, the last one with points before it; the intervals that
// start among its points (one coalesced load of 32 starts and lengths)
// mark their first point, and a warp-wide prefix maximum gives every point
// the last non-empty interval starting at or before it: the only one that
// can hold it, since the intervals ascend and are disjoint. A point inside
// that interval takes its cell's row of grad, every other point zeros:
// dropped intervals, gaps, points before the first interval or past a
// clamped end. The warp then stores its rows as consecutive vectors of up
// to 16 bytes across its lanes (every lane stores, whatever C), and the
// blocks, in point order, write one front of the output as a fill does.
// The cells' rows are read through L1 and L2 (an interval's points share
// one); the stores are streamed (evict first) so those rows stay in L2.
// Equal bit for bit to the plain version, which copies the same rows. The
// output is torch.empty. Bound: bytes (the point rows written, the cells'
// rows read).

#include <algorithm>

#include "bulk_copy.cuh"
#include "common.cuh"

namespace conch {

struct BevGrid {
  int64_t num_points;
  int64_t num_intervals;
  int channels;
  int batch, gz, gx, gy;
};

// The flat cell of an interval starting at `start`, or -1 when it is dropped.
__device__ __forceinline__ int64_t bev_cell_at(const int32_t* __restrict__ geom, int64_t start, const BevGrid& g) {
  if (start < 0 || start >= g.num_points) return -1;
  const int4 p = reinterpret_cast<const int4*>(geom)[start];  // (x, y, z, b)
  if (p.x < 0 || p.x >= g.gx || p.y < 0 || p.y >= g.gy || p.z < 0 || p.z >= g.gz || p.w < 0 || p.w >= g.batch)
    return -1;
  return ((static_cast<int64_t>(p.w) * g.gz + p.z) * g.gx + p.x) * g.gy + p.y;
}

// The flat cell of interval i, or -1 when it is dropped.
__device__ __forceinline__ int64_t bev_cell(const int32_t* __restrict__ geom, const int32_t* __restrict__ starts,
                                            int64_t i, const BevGrid& g) {
  return bev_cell_at(geom, starts[i], g);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// The first interval that starts at or after p (num_intervals if none), by
// a warp: lane l probes the last index of the l-th of 32 equal parts of
// [lo, hi).
__device__ __forceinline__ int64_t first_start_at_or_after(const int32_t* __restrict__ starts, int64_t ni, int64_t p,
                                                           int lane) {
  int64_t lo = 0, hi = ni;
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t probe = lo + (lane + 1) * step - 1;
    const unsigned at_or_after = __ballot_sync(0xffffffffu, probe >= hi || starts[probe] >= p);
    if (at_or_after == 0) {
      lo = hi;
    } else {
      const int f = __ffs(at_or_after) - 1;
      hi = min64(hi, lo + (f + 1) * step - 1);
      lo += f * step;
    }
  }
  return lo;
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T>
__device__ __forceinline__ T to_type(float x);
template <>
__device__ __forceinline__ float to_type<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_type<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <>
__device__ __forceinline__ __half to_type<__half>(float x) { return __float2half(x); }

template <typename T, int V>
__device__ __forceinline__ void add_row(float (&s)[V], const Vec<T, V>& x) {
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] += to_float(x.v[k]);
}

// V elements of T as one plain word of their size, so a row's vector moves
// in a register (a struct would go through the stack in a select).
template <int Bytes>
struct RawVec;
template <>
struct RawVec<16> {
  using type = uint4;
};
template <>
struct RawVec<8> {
  using type = uint2;
};
template <>
struct RawVec<4> {
  using type = uint32_t;
};
template <>
struct RawVec<2> {
  using type = uint16_t;
};

// --- K13a ---------------------------------------------------------------------

constexpr int kFwdConsumerWarps = 4;
constexpr int kFwdConsumers = 32 * kFwdConsumerWarps;
constexpr int kFwdThreads = 32 + kFwdConsumers;  // the producer warp, then the consumers
constexpr int kFwdMinBlocks = 65536 / (kFwdThreads * 80);  // blocks an SM at 80 registers a thread
constexpr int kFwdPieces = 128;                  // pieces, and rows, a stage holds at most
constexpr int kFwdZeros = 32;                    // ranges of grid rows to zero a stage holds at most
constexpr int kFwdUnroll = 8;                    // rows loaded ahead of their adds

// A piece's flags: it opens its interval (the sum starts from 0) or closes it
// (the sum is added to the run's), it opens its run (the run's sum starts
// from 0) or closes it (the cell's row is written).
enum : int { kOpenInterval = 1, kCloseInterval = 2, kOpenRun = 4, kCloseRun = 8 };

// A part of one interval in one stage.
struct FwdPiece {
  int32_t grow;  // first row in feats
  int32_t cell;  // the run's cell
  int16_t srow;  // first row in the stage
  int16_t rows;
  int16_t flags;
  int16_t pad;
};
// A stage's header: its pieces, in point order, in segments (the pieces
// seg_start[k] .. seg_start[k + 1] - 1 belong to one run), and ranges of
// grid rows [zero_lo, zero_hi) that its consumers zero; the last stage has
// `done` set.
struct FwdHeader {
  int32_t pieces, segs, done, zeros;
  int16_t seg_start[kFwdPieces + 8];
  int32_t zero_lo[kFwdZeros], zero_hi[kFwdZeros];
  FwdPiece piece[kFwdPieces];
};
static_assert(sizeof(FwdPiece) == 16 && sizeof(FwdHeader) == 2592, "kernels/vision/bev_pool.py: FWD_HEADER_BYTES");
// Launch plan (kernels/vision/bev_pool.py:bev_forward_plan).
struct FwdPlan {
  int64_t tile_points;
  int64_t stage_rows;   // rows a stage holds
  int64_t stage_bytes;  // bytes of a stage's rows (TMA), else 0
  int stages;
};

// Zeros to the grid rows [lo, hi), thread t of `threads`, in vectors of V.
template <typename T, int V>
__device__ __forceinline__ void zero_rows(T* __restrict__ out, int64_t lo, int64_t hi, int channels, int t,
                                          int threads) {
  using R = typename RawVec<sizeof(T) * V>::type;  // zero bits are +0 in every float type
  if (hi <= lo) return;
  R* dst = reinterpret_cast<R*>(out + lo * channels);
  const int64_t n = (hi - lo) * (channels / V);
  for (int64_t v = t; v < n; v += threads) dst[v] = R{};
}

// s += the `rows` rows at p (stride `stride` elements), W elements each, in order.
template <typename T, int W>
__device__ __forceinline__ void sum_rows(float (&s)[W], const T* p, int rows, int stride) {
  int r = 0;
  for (; r + kFwdUnroll <= rows; r += kFwdUnroll) {
    Vec<T, W> x[kFwdUnroll];
#pragma unroll
    for (int u = 0; u < kFwdUnroll; ++u) x[u] = *reinterpret_cast<const Vec<T, W>*>(p + (r + u) * stride);
#pragma unroll
    for (int u = 0; u < kFwdUnroll; ++u) add_row(s, x[u]);  // in point order
  }
  for (; r < rows; ++r) add_row(s, *reinterpret_cast<const Vec<T, W>*>(p + r * stride));
}

// The consumers' pass over one stage: (segment, W-element vector) pairs.
// The carried sums come in through carry_in (the interval's C, then the
// run's C) and go out through carry_out: two buffers in turns, so a stage's
// first segment never reads what its last one writes.
template <typename T, int W, bool kTma>
__device__ __forceinline__ void consume_stage(const FwdHeader& h, const T* __restrict__ rows_base,
                                              const T* __restrict__ feats, T* __restrict__ out,
                                              const float* carry_in, float* carry_out, int channels, int tid) {
  const int per_seg = channels / W;
  for (int u = tid; u < h.segs * per_seg; u += kFwdConsumers) {
    const int seg = u / per_seg, c = (u - seg * per_seg) * W;
    const int pa = h.seg_start[seg], pb = h.seg_start[seg + 1];
    float s[W], acc[W];
    const int first = h.piece[pa].flags;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      s[k] = first & kOpenInterval ? 0.0f : carry_in[c + k];  // the interval or run a stage before carried on
      acc[k] = first & kOpenRun ? 0.0f : carry_in[channels + c + k];
    }
    for (int p = pa; p < pb; ++p) {
      const FwdPiece pc = h.piece[p];
      if (pc.flags & kOpenInterval) {
#pragma unroll
        for (int k = 0; k < W; ++k) s[k] = 0.0f;
      }
      if (pc.flags & kOpenRun) {
#pragma unroll
        for (int k = 0; k < W; ++k) acc[k] = 0.0f;
      }
      const T* src = kTma ? rows_base + pc.srow * channels + c : feats + static_cast<int64_t>(pc.grow) * channels + c;
      sum_rows<T, W>(s, src, pc.rows, channels);
      if (pc.flags & kCloseInterval) {
#pragma unroll
        for (int k = 0; k < W; ++k) acc[k] += s[k];
      }
      if (pc.flags & kCloseRun) {
        Vec<T, W> y;
#pragma unroll
        for (int k = 0; k < W; ++k) y.v[k] = to_type<T>(acc[k]);
        *reinterpret_cast<Vec<T, W>*>(out + static_cast<int64_t>(pc.cell) * channels + c) = y;
      }
    }
    if (!(h.piece[pb - 1].flags & kCloseRun)) {  // the stage's last segment: its run goes on in the next stage
#pragma unroll
      for (int k = 0; k < W; ++k) {
        carry_out[c + k] = s[k];
        carry_out[channels + c + k] = acc[k];
      }
    }
  }
}

// The lowest set bit of m at or above bit b (32: none).
__device__ __forceinline__ int next_bit(unsigned m, int b) {
  const unsigned above = b >= 32 ? 0u : m & (0xffffffffu << b);
  return above ? __ffs(above) - 1 : 32;
}

template <typename T, int V, bool kTma>
__global__ void __launch_bounds__(kFwdThreads, kFwdMinBlocks) bev_pool_fwd_kernel(const T* __restrict__ feats,
                                                                  const int32_t* __restrict__ geom,
                                                                  const int32_t* __restrict__ starts,
                                                                  const int32_t* __restrict__ lengths,
                                                                  T* __restrict__ out, BevGrid g, FwdPlan plan) {
  // Shared memory: the ring (stages x stage_bytes), the headers (stages + 1:
  // stage q's in slot q % (stages + 1), so the producer fills the open
  // stage's while the consumers read the stages before it), the carried sums
  // (two buffers of 2 x C f32), then the mbarriers full[stages], empty[stages].
  extern __shared__ __align__(16) unsigned char smem[];
  const int stages = plan.stages, channels = g.channels;
  unsigned char* ring = smem;
  FwdHeader* headers = reinterpret_cast<FwdHeader*>(smem + stages * plan.stage_bytes);
  float* carry = reinterpret_cast<float*>(headers + stages + 1);
  const uint32_t full = smem_addr(carry + 4 * channels), empty = full + 8 * stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 32) {  // the consumers: every stage in order, until the last
    const int tid = threadIdx.x - 32;
    for (int64_t q = 0;; ++q) {
      const int s = static_cast<int>(q % stages);
      mbar_wait(full + 8 * s, static_cast<int>((q / stages) & 1));
      const FwdHeader& h = headers[q % (stages + 1)];
      const T* rows = reinterpret_cast<const T*>(ring + s * plan.stage_bytes);
      const bool done = h.done;
      const float* carry_in = carry + 2 * channels * ((q + 1) & 1);
      float* carry_out = carry + 2 * channels * (q & 1);
      // The narrowest vector whose pairs still fit the consumers once.
      int w = 1;
      while (w < V && h.segs * (channels / w) > kFwdConsumers) w *= 2;
      if (w == 1) {
        consume_stage<T, 1, kTma>(h, rows, feats, out, carry_in, carry_out, channels, tid);
      } else if (w == 2) {
        if constexpr (V >= 2) consume_stage<T, 2, kTma>(h, rows, feats, out, carry_in, carry_out, channels, tid);
      } else if (w == 4) {
        if constexpr (V >= 4) consume_stage<T, 4, kTma>(h, rows, feats, out, carry_in, carry_out, channels, tid);
      } else {
        if constexpr (V >= 8) consume_stage<T, 8, kTma>(h, rows, feats, out, carry_in, carry_out, channels, tid);
      }
      // The stage's zeros, while the slowest pair finishes (the header is still this stage's).
      for (int k = 0; k < h.zeros; ++k) zero_rows<T, V>(out, h.zero_lo[k], h.zero_hi[k], channels, tid, kFwdConsumers);
      asm volatile("bar.sync 1, %0;\n" ::"r"(kFwdConsumers) : "memory");  // the stage read, the carry written
      if (tid == 0) mbar_arrive(empty + 8 * s);
      if (done) return;
    }
  }

  // The producer warp. It reads the intervals 32 at a time, a lane each, and
  // lays the owned non-empty intervals' rows end to end: this block's stream,
  // cut into stages of stage_rows rows. Stage t_pub is open (rows from t_pub
  // x stage_rows to `streamed`, `npieces` pieces); every stage before it is
  // published. A piece whose run's end is not yet known (`pending`) keeps its
  // stage open until a later batch shows it.
  const int lane = threadIdx.x;
  const unsigned all = 0xffffffffu, below = (1u << lane) - 1;
  const int64_t ni = g.num_intervals, np = g.num_points;
  const int64_t grid_rows = static_cast<int64_t>(g.batch) * g.gz * g.gx * g.gy;
  const int64_t row_bytes = static_cast<int64_t>(channels) * sizeof(T);
  const int64_t sr = plan.stage_rows;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * plan.tile_points;
  const int64_t p1 = min64(p0 + plan.tile_points, np);
  const int64_t first = first_start_at_or_after(starts, ni, p0, lane);
  // The cell of the last kept interval before the tile's (-1: none).
  int64_t cur_cell = -1;
  for (int64_t base = first - 1; base >= 0; base -= 32) {
    const int64_t idx = base - lane;
    const int64_t c = idx >= 0 ? bev_cell(geom, starts, idx, g) : -1;
    const unsigned kept = __ballot_sync(all, c >= 0);
    if (kept) {
      cur_cell = __shfl_sync(all, c, __ffs(kept) - 1);
      break;
    }
  }

  // The open stage: its pieces and segments so far, whether its last piece
  // closes its run, and whether its pieces are one span of feats (from
  // span_begin to span_end: one copy).
  int64_t streamed = 0, t_pub = 0, span_begin = 0, span_end = 0;
  int npieces = 0, nsegs = 0, pending = -1;
  bool last_closes = true, one_span = true;
  int nzeros = 0;  // the open stage's ranges to zero
  // Hands the lanes' ranges [lo, hi) (where `has`) to the open stage's
  // consumers, or zeros them here when its header is full.
  auto zero_later = [&](bool has, int64_t lo, int64_t hi) {
    const unsigned m = __ballot_sync(all, has);
    if (nzeros + __popc(m) <= kFwdZeros) {
      FwdHeader& hd = headers[t_pub % (stages + 1)];
      if (has) {
        const int k = nzeros + __popc(m & below);
        hd.zero_lo[k] = static_cast<int32_t>(lo);
        hd.zero_hi[k] = static_cast<int32_t>(hi);
      }
      nzeros += __popc(m);
    } else {
      for (unsigned left = m; left;) {
        const int l = __ffs(left) - 1;
        left &= left - 1;
        zero_rows<T, V>(out, __shfl_sync(all, lo, l), __shfl_sync(all, hi, l), channels, lane, 32);
      }
    }
  };
  // Publishes stage t_pub: its header's counts, then (once the consumers
  // release its ring slot) its row copies.
  auto publish = [&](bool done) {
    FwdHeader& hd = headers[t_pub % (stages + 1)];
    const int s = static_cast<int>(t_pub % stages);
    const int64_t rows = min64(streamed - t_pub * sr, sr);
    if (lane == 0) {
      hd.seg_start[nsegs] = static_cast<int16_t>(npieces);
      hd.pieces = npieces;
      hd.segs = nsegs;
      hd.zeros = nzeros;
      hd.done = done;
      if (t_pub >= stages) mbar_wait(empty + 8 * s, static_cast<int>((t_pub / stages - 1) & 1));
      if constexpr (kTma) {
        mbar_arrive_expect(full + 8 * s, static_cast<uint32_t>(rows * row_bytes));  // the header visible, rows expected
      } else {
        mbar_arrive(full + 8 * s);
      }
    }
    __syncwarp();
    if constexpr (kTma) {
      unsigned char* dst = ring + s * plan.stage_bytes;
      if (one_span) {
        if (lane == 0 && rows > 0)
          bulk_load(smem_addr(dst), feats + span_begin * channels, static_cast<uint32_t>(rows * row_bytes), full + 8 * s);
      } else {
        for (int k = lane; k < npieces; k += 32) {
          const FwdPiece pc = hd.piece[k];
          bulk_load(smem_addr(dst + pc.srow * row_bytes), feats + static_cast<int64_t>(pc.grow) * channels,
                    static_cast<uint32_t>(pc.rows * row_bytes), full + 8 * s);
        }
      }
    }
    ++t_pub;
    npieces = nsegs = nzeros = 0;
    last_closes = one_span = true;
  };

  bool owned_run = false;  // the run in progress (cur_cell's) is this block's
  bool run_rows = false;   // and it has rows in the stream
  bool any_run = false;    // this block owns a run
  bool reached_end = false;
  for (int64_t j = first;; j += 32) {
    const int64_t idx = j + lane;
    const bool valid = idx < ni;
    const int64_t start = valid ? starts[idx] : np;
    const int64_t len = valid ? lengths[idx] : 0;
    const int64_t cell = valid ? bev_cell_at(geom, start, g) : -1;
    const bool kept = cell >= 0, in_tile = valid && start < p1;  // start >= p0 from `first` on
    // The kept cell before this interval, and whether this interval opens a run.
    const unsigned kept_below = __ballot_sync(all, kept) & below;
    const int64_t prev_in = __shfl_sync(all, cell, kept_below ? 31 - __clz(kept_below) : lane);
    const int64_t prev = kept_below ? prev_in : cur_cell;
    const bool run_start = kept && cell != prev;
    // Whether the run in progress after this interval is this block's: its
    // opening interval starts in the tile (or, with none in the batch, the carried state).
    const unsigned starts_upto = __ballot_sync(all, run_start) & (below | (1u << lane));
    const bool opener_in_tile = __shfl_sync(all, in_tile, starts_upto ? 31 - __clz(starts_upto) : lane);
    const bool own = starts_upto ? opener_in_tile : owned_run;
    // This block's intervals end at the first one past the tile that is not
    // in its run, or at the last interval.
    const unsigned stop = __ballot_sync(all, !valid || (!in_tile && !own));
    const int count = stop ? __ffs(stop) - 1 : 32;
    const bool mine = lane < count, opens = mine && run_start && own;
    // Zeros to the cells between each owned run's cell and the kept cell before it.
    zero_later(opens && cell > prev + 1, prev + 1, cell);
    // The owned intervals with rows, and the events that close the run in
    // progress: an owned run opening, and the end of the block's intervals.
    const int64_t end = min64(start + (len > 0 ? len : 0), np);
    const bool emits = mine && kept && own && end > start;
    const unsigned emit_mask = __ballot_sync(all, emits), open_mask = __ballot_sync(all, opens);
    const unsigned events = open_mask | (count < 32 ? 1u << count : 0u);
    // A run that closes without rows gets its cell's zeros here: the run in
    // progress at the batch's start (owned, rows so far: run_rows), and each
    // run opening in the batch whose next event comes before its next rows.
    zero_later(lane == 0 && owned_run && !run_rows && next_bit(events, 0) <= next_bit(emit_mask, 0) &&
                   next_bit(events, 0) < 32,
               cur_cell, cur_cell + 1);
    zero_later(opens && next_bit(events, lane + 1) < 32 && next_bit(events, lane + 1) <= next_bit(emit_mask, lane),
               cell, cell + 1);
    // Whether an interval's rows open its run: the first rows since the run
    // opened (its opening interval may have none).
    const unsigned opened_upto = open_mask & (below | (1u << lane));
    const int r0 = opened_upto ? 31 - __clz(opened_upto) : -1;
    const bool opens_rows = (emit_mask & below & (r0 < 0 ? all : ~((1u << r0) - 1))) == 0 && (r0 >= 0 || !run_rows);
    // Whether they close it: an event comes before the next interval with
    // rows. The last such interval before no event is undecided.
    const int next_event = next_bit(events, lane + 1), next_emit = next_bit(emit_mask, lane + 1);
    const bool decided = next_event < 32 || next_emit < 32;
    const bool closes = next_event < 32 && next_event <= next_emit;
    // The pending piece from an earlier batch is settled the same way.
    if (pending >= 0) {
      const int e0 = next_bit(events, 0), m0 = next_bit(emit_mask, 0);
      if (e0 < 32 || m0 < 32) {
        FwdHeader& hd = headers[t_pub % (stages + 1)];
        if (e0 < 32 && e0 <= m0) {
          if (lane == 0) hd.piece[pending].flags |= kCloseRun;
          last_closes = true;  // the pending piece is the stage's last
        }
        pending = -1;
        __syncwarp();
        if (streamed == (t_pub + 1) * sr) publish(false);  // its stage was full
      }
    }
    // The rows of this batch's intervals in the stream, stage by stage.
    const int64_t n = emits ? end - start : 0;
    int64_t incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t x = __shfl_up_sync(all, incl, o);
      if (lane >= o) incl += x;
    }
    const int64_t pos = streamed + incl - n, batch_end = streamed + __shfl_sync(all, incl, 31);
    const int last_emit = emit_mask ? 31 - __clz(emit_mask) : -1;
    while (emit_mask) {
      const int64_t lo = t_pub * sr, hi = lo + sr;
      const int64_t a = pos > lo ? pos : lo, b = min64(pos + n, hi);
      const bool here = emits && a < b;
      const unsigned here_mask = __ballot_sync(all, here);
      // A piece opens a segment when the piece before it closes its run (or
      // it is the stage's first); the stage is one span while each piece
      // starts where the one before ended.
      const int64_t grow = start + (a - pos);
      const bool piece_closes = b == pos + n && closes;
      const unsigned lower = here_mask & below;
      const int src = lower ? 31 - __clz(lower) : lane;
      const bool lower_closes = __shfl_sync(all, piece_closes, src);
      const int64_t lower_end = __shfl_sync(all, grow + (b - a), src);
      const bool opens_seg = lower ? lower_closes : npieces == 0 || last_closes;
      const bool joins = lower ? lower_end == grow : npieces == 0 || span_end == grow;
      const unsigned seg_mask = __ballot_sync(all, here && opens_seg);
      FwdHeader& hd = headers[t_pub % (stages + 1)];
      if (here) {
        FwdPiece pc;
        pc.grow = static_cast<int32_t>(grow);
        pc.cell = static_cast<int32_t>(cell);
        pc.srow = static_cast<int16_t>(a - lo);
        pc.rows = static_cast<int16_t>(b - a);
        pc.flags = static_cast<int16_t>((a == pos ? kOpenInterval | (opens_rows ? kOpenRun : 0) : 0) |
                                        (piece_closes ? kCloseInterval | kCloseRun : b == pos + n ? kCloseInterval : 0));
        pc.pad = 0;
        hd.piece[npieces + __popc(lower)] = pc;
        if (opens_seg) hd.seg_start[nsegs + __popc(seg_mask & below)] = static_cast<int16_t>(npieces + __popc(lower));
      }
      if (here_mask) {
        const int top = 31 - __clz(here_mask);
        if (npieces == 0) span_begin = __shfl_sync(all, grow, __ffs(here_mask) - 1);
        one_span &= __ballot_sync(all, here && !joins) == 0;
        last_closes = __shfl_sync(all, piece_closes, top);
        span_end = __shfl_sync(all, grow + (b - a), top);
      }
      npieces += __popc(here_mask);
      nsegs += __popc(seg_mask);
      __syncwarp();
      if (batch_end < hi) {  // the stage stays open for the next batch
        if (!__shfl_sync(all, decided, last_emit)) pending = npieces - 1;
        break;
      }
      streamed = hi;
      if (batch_end == hi && !__shfl_sync(all, decided, last_emit)) {  // full, its last piece undecided
        pending = npieces - 1;
        break;
      }
      publish(false);
    }
    streamed = batch_end;
    any_run |= open_mask != 0;
    // The state after this batch's last interval, on every lane.
    if (open_mask) {
      run_rows = (emit_mask & ~((1u << (31 - __clz(open_mask))) - 1)) != 0;
    } else {
      run_rows |= emit_mask != 0;
    }
    if (count > 0) owned_run = __shfl_sync(all, own, count - 1);
    const unsigned kept_mine = __ballot_sync(all, mine && kept);
    if (kept_mine) cur_cell = __shfl_sync(all, cell, 31 - __clz(kept_mine));
    if (count < 32) {
      reached_end = __shfl_sync(all, !valid, count);
      break;
    }
  }
  zero_later(lane == 0 && reached_end && owned_run && cur_cell + 1 < grid_rows, cur_cell + 1, grid_rows);  // the tail
  if (blockIdx.x == 0 && !any_run) {
    // Block 0 owns no run: with no kept interval at all, it zeros the grid.
    // (The tile's and earlier intervals hold none; look at the rest.)
    bool none = true;
    for (int64_t j = first; j < ni && none; j += 32) {
      const int64_t idx = j + lane;
      none = __ballot_sync(all, idx < ni && bev_cell(geom, starts, idx, g) >= 0) == 0;
    }
    zero_later(lane == 0 && none, 0, grid_rows);
  }
  publish(true);  // the open stage (its pieces all decided: the last batch held the end), the last
}

// --- K13b ---------------------------------------------------------------------

constexpr int kBevBwdWarps = 8;                                   // warps a block
constexpr int kBevBwdBlockPoints = 32 * kBevBwdWarps;             // a point a lane

template <typename T, int V>
__global__ void __launch_bounds__(kBevBwdWarps * 32) bev_pool_bwd_kernel(const T* __restrict__ grad,
                                                                        const int32_t* __restrict__ geom,
                                                                        const int32_t* __restrict__ starts,
                                                                        const int32_t* __restrict__ lengths,
                                                                        T* __restrict__ out, BevGrid g) {
  // A warp's 32 points, a lane each: the interval starting at each (its
  // slot; -1: none), that interval's end and cell, then each point's source
  // row (-1: zeros).
  __shared__ int32_t slot_sh[kBevBwdWarps][32];
  __shared__ int64_t end_sh[kBevBwdWarps][32];
  __shared__ int64_t cell_sh[kBevBwdWarps][32];
  __shared__ int64_t src_sh[kBevBwdWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t p0 = (static_cast<int64_t>(blockIdx.x) * kBevBwdWarps + warp) * 32;  // lane l resolves p0 + l
  if (p0 >= g.num_points) return;  // warp-uniform
  const int64_t ni = g.num_intervals;
  const int64_t next = first_start_at_or_after(starts, ni, p0, lane);
  // The last non-empty interval before it: of those that start before p0,
  // the only one that can hold p0.
  int64_t cur = -1;
  for (int64_t base = next - 1; base >= 0; base -= 32) {
    const int64_t idx = base - lane;
    const unsigned nonempty = __ballot_sync(0xffffffffu, idx >= 0 && lengths[idx] > 0);
    if (nonempty) {
      cur = base - (__ffs(nonempty) - 1);
      break;
    }
  }
  int32_t* slots = slot_sh[warp];
  int64_t *ends = end_sh[warp], *cells = cell_sh[warp], *src = src_sh[warp];
  slots[lane] = -1;
  __syncwarp();
  // The non-empty intervals that start at the warp's points (ascending
  // starts: a prefix of the 32 from next on) mark their first point.
  for (int64_t first = next; first < ni;) {
    const int64_t idx = first + lane;
    const int64_t start = idx < ni ? starts[idx] : 0;
    const unsigned in_tile = __ballot_sync(0xffffffffu, idx < ni && start < p0 + 32);
    const int count = in_tile == 0xffffffffu ? 32 : __ffs(~in_tile) - 1;
    if (lane < count && lengths[idx] > 0 && start >= p0) {
      const int s = static_cast<int>(start - p0);
      slots[s] = s;
      ends[s] = start + lengths[idx];
      cells[s] = bev_cell(geom, starts, idx, g);
    }
    first += count;
    if (count < 32) break;
  }
  __syncwarp();
  // Each point's interval: the prefix maximum of the slots (-1: the one
  // before the warp's points, cur).
  int s = slots[lane];
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, s, offset);
    if (lane >= offset) s = max(s, x);
  }
  int64_t end = -1, cell = -1;  // no interval: no point inside
  if (s >= 0) {
    end = ends[s];
    cell = cells[s];
  } else if (cur >= 0) {
    end = static_cast<int64_t>(starts[cur]) + lengths[cur];
    cell = bev_cell(geom, starts, cur, g);
  }
  src[lane] = p0 + lane < end ? cell : -1;
  __syncwarp();
  // The warp's rows, in consecutive vectors of up to 16 bytes across its lanes.
  using R = typename RawVec<sizeof(T) * V>::type;  // zero bits are +0 in every float type
  const int vecs = g.channels / V;
  const int points = static_cast<int>(min64(32, g.num_points - p0));
  const int point_step = 32 / vecs, col_step = 32 % vecs;
  const R* rows = reinterpret_cast<const R*>(grad);
  R* dst = reinterpret_cast<R*>(out) + p0 * vecs;
  int point = lane / vecs, c = lane - point * vecs;
  for (int v = lane; v < points * vecs; v += 32) {
    const int64_t row = src[point];
    R x = {};
    if (row >= 0) x = rows[row * vecs + c];
    __stcs(dst + v, x);  // streamed: the cells' rows keep L2
    point += point_step;
    c += col_step;
    if (c >= vecs) {
      c -= vecs;
      ++point;
    }
  }
}

// K13a's shared memory: its dynamic bytes, and the SM's whole shared
// memory for its carveout, so that three blocks of BEVFusion's plan fit an SM.
template <typename Kernel>
cudaError_t fwd_attributes(Kernel kernel, int smem_bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
}

// Calls go(TypeTag<T>{}, integral_constant<V>{}) for a dtype code and a
// vector width the kernels take (16 bytes at most); false for any other.
template <typename Go>
bool dispatch_bev(int dtype, int vec, Go&& go) {
  bool known = true;
  auto with_vec = [&](auto tag) {
    switch (vec) {
      case 1: go(tag, std::integral_constant<int, 1>{}); break;
      case 2: go(tag, std::integral_constant<int, 2>{}); break;
      case 4: go(tag, std::integral_constant<int, 4>{}); break;
      case 8:  // 16 bytes of a 2-byte type only
        if constexpr (sizeof(typename decltype(tag)::type) == 2) {
          go(tag, std::integral_constant<int, 8>{});
        } else {
          known = false;
        }
        break;
      default: known = false;
    }
  };
  switch (dtype) {
    case kFloat32: with_vec(TypeTag<float>{}); break;
    case kBFloat16: with_vec(TypeTag<__nv_bfloat16>{}); break;
    case kFloat16: with_vec(TypeTag<__half>{}); break;
    default: known = false;
  }
  return known;
}

}  // namespace conch

// feats: (num_points, channels) f32 / bf16 / f16; geom: (num_points, 4)
// int32, 16-byte aligned; starts, lengths: (num_intervals,) int32, in the
// contract's order; out: (batch*gz*gx*gy, channels), every row written (no
// fill needed); vec: elements per vector, a divisor of channels, every row
// base aligned to vec elements. The plan (kernels/vision/bev_pool.py:
// bev_forward_plan): `blocks` tiles of `tile_points` points; `tma` (rows by
// TMA bulk copies; vec * element size must be 16) into `stages` stages of
// `stage_rows` rows (`stage_bytes` bytes); `smem_bytes` of dynamic shared
// memory.
extern "C" int conch_bev_pool_forward(const void* feats, const void* geom, const void* starts, const void* lengths,
                                      void* out, int64_t num_points, int64_t num_intervals, int channels, int batch,
                                      int gz, int gx, int gy, int dtype, int vec, int64_t tile_points, int tma,
                                      int stages, int64_t stage_rows, int64_t stage_bytes, int smem_bytes,
                                      int64_t blocks, void* stream) {
  const conch::BevGrid g{num_points, num_intervals, channels, batch, gz, gx, gy};
  if (num_intervals == 0 || channels == 0) return static_cast<int>(cudaSuccess);
  if (blocks < 1 || tile_points < 1 || blocks * tile_points < num_points || stages < 1 || stage_rows < 1 ||
      (tma && stage_bytes < 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const conch::FwdPlan plan{tile_points, stage_rows, tma ? stage_bytes : 0, stages};
  cudaError_t err = cudaSuccess;
  const bool known = conch::dispatch_bev(dtype, vec, [&](auto tag, auto vtag) {
    using T = typename decltype(tag)::type;
    constexpr int V = decltype(vtag)::value;
    auto run = [&](auto kernel) {
      err = conch::fwd_attributes(kernel, smem_bytes);
      if (err != cudaSuccess) return;
      kernel<<<static_cast<unsigned>(blocks), conch::kFwdThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(feats), static_cast<const int32_t*>(geom), static_cast<const int32_t*>(starts),
          static_cast<const int32_t*>(lengths), static_cast<T*>(out), g, plan);
      err = cudaGetLastError();
    };
    if (!tma) {
      run(conch::bev_pool_fwd_kernel<T, V, false>);
    } else if constexpr (sizeof(T) * V == 16) {
      run(conch::bev_pool_fwd_kernel<T, V, true>);
    } else {
      err = cudaErrorInvalidValue;  // a TMA stage's rows are 16-byte vectors
    }
  });
  return static_cast<int>(known ? err : cudaErrorInvalidValue);
}

// K13a's blocks resident on an SM at a plan's shared memory (cudaOccupancy
// MaxActiveBlocksPerMultiprocessor), or -1 for a dtype / vec it does not take.
extern "C" int conch_bev_pool_forward_occupancy(int dtype, int vec, int tma, int smem_bytes) {
  int blocks = -1;
  conch::dispatch_bev(dtype, vec, [&](auto tag, auto vtag) {
    using T = typename decltype(tag)::type;
    constexpr int V = decltype(vtag)::value;
    auto query = [&](auto kernel) {
      if (conch::fwd_attributes(kernel, smem_bytes) != cudaSuccess ||
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, conch::kFwdThreads, smem_bytes) != cudaSuccess)
        blocks = -1;
    };
    if (!tma) {
      query(conch::bev_pool_fwd_kernel<T, V, false>);
    } else if constexpr (sizeof(T) * V == 16) {
      query(conch::bev_pool_fwd_kernel<T, V, true>);
    }
  });
  return blocks;
}

// grad: (batch*gz*gx*gy, channels); out: (num_points, channels), every row
// written (no fill needed); starts ascending and the intervals disjoint;
// `blocks` blocks of 256 points (bev_backward_blocks); the rest as
// conch_bev_pool_forward.
extern "C" int conch_bev_pool_backward(const void* grad, const void* geom, const void* starts, const void* lengths,
                                       void* out, int64_t num_points, int64_t num_intervals, int channels, int batch,
                                       int gz, int gx, int gy, int dtype, int vec, int64_t blocks, void* stream) {
  const conch::BevGrid g{num_points, num_intervals, channels, batch, gz, gx, gy};
  if (num_points == 0 || channels == 0) return static_cast<int>(cudaSuccess);
  if (blocks < 1 || blocks * conch::kBevBwdBlockPoints < num_points) return static_cast<int>(cudaErrorInvalidValue);
  const bool known = conch::dispatch_bev(dtype, vec, [&](auto tag, auto vtag) {
    using T = typename decltype(tag)::type;
    constexpr int V = decltype(vtag)::value;
    conch::bev_pool_bwd_kernel<T, V><<<static_cast<unsigned>(blocks), conch::kBevBwdWarps * 32, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(grad), static_cast<const int32_t*>(geom), static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(lengths), static_cast<T*>(out), g);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
