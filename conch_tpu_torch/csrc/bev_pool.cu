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
// here a warp reads the rows it needs directly.
//
// Contract (cells_sorted=True, as BEVFusion builds the intervals): the
// intervals come in ascending flat-cell order, so intervals that share a
// cell are neighbours (dropped intervals aside), and they are disjoint. A
// cell is ((b*Z + z)*X + x)*Y + y from the interval's first point, geom row
// (x, y, z, b); a cell with any coordinate outside its range, or an
// interval that starts outside the points, is dropped (forward) and gives
// its points a zero gradient (backward). No kernel reads or writes outside
// its tensors.
//
// K13a: one warp per interval. The warp of an interval that starts a run
// of equal cells walks the run's intervals and their points in order, its
// lanes splitting the channels in vectors of up to 16 bytes; each lane sums
// an interval's points one after the other in f32 registers, adds that sum
// into the run's, and writes the cell's row once, cast to the output type.
// No atomics, and the order of the sums is the plain version's
// (reference/vision/vision.py), so the result is deterministic and equal
// to it. The output is zero-filled by the caller. Bound on the H100:
// bytes (every feature row read once, 638 MB at BEVFusion's nuScenes size
// in f32); eight rows are loaded ahead of their adds to keep loads in
// flight. A long run is walked by one warp: the tail is the longest run.
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

#include "common.cuh"

namespace conch {

constexpr int kBevWarps = 8;  // warps (intervals) per block
constexpr int kBevUnroll = 8;  // feature rows loaded ahead of their adds

struct BevGrid {
  int64_t num_points;
  int64_t num_intervals;
  int channels;
  int batch, gz, gx, gy;
};

// The flat cell of interval i, or -1 when it is dropped.
__device__ __forceinline__ int64_t bev_cell(const int32_t* __restrict__ geom, const int32_t* __restrict__ starts,
                                            int64_t i, const BevGrid& g) {
  const int64_t start = starts[i];
  if (start < 0 || start >= g.num_points) return -1;
  const int4 p = reinterpret_cast<const int4*>(geom)[start];  // (x, y, z, b)
  if (p.x < 0 || p.x >= g.gx || p.y < 0 || p.y >= g.gy || p.z < 0 || p.z >= g.gz || p.w < 0 || p.w >= g.batch)
    return -1;
  return ((static_cast<int64_t>(p.w) * g.gz + p.z) * g.gx + p.x) * g.gy + p.y;
}

// [begin, end) of interval i's points, clamped to the points.
__device__ __forceinline__ void bev_range(const int32_t* __restrict__ starts, const int32_t* __restrict__ lengths,
                                          int64_t i, int64_t num_points, int64_t* begin, int64_t* end) {
  const int64_t s = starts[i];
  const int64_t len = lengths[i] > 0 ? lengths[i] : 0;
  *begin = s < 0 ? 0 : (s > num_points ? num_points : s);
  const int64_t e = s + len;
  *end = e < *begin ? *begin : (e > num_points ? num_points : e);
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

template <typename T, int V>
__global__ void __launch_bounds__(kBevWarps * 32) bev_pool_fwd_kernel(const T* __restrict__ feats,
                                                                     const int32_t* __restrict__ geom,
                                                                     const int32_t* __restrict__ starts,
                                                                     const int32_t* __restrict__ lengths,
                                                                     T* __restrict__ out, BevGrid g) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBevWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= g.num_intervals) return;
  const int64_t cell = bev_cell(geom, starts, i, g);
  if (cell < 0) return;  // dropped
  // A run is the intervals of one cell, dropped ones between them skipped;
  // its first interval's warp does the run.
  int64_t prev = i - 1;
  while (prev >= 0 && bev_cell(geom, starts, prev, g) < 0) --prev;
  if (prev >= 0 && bev_cell(geom, starts, prev, g) == cell) return;
  const int vecs = g.channels / V;
  for (int c = lane; c < vecs; c += 32) {
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
    for (int64_t j = i; j < g.num_intervals; ++j) {
      const int64_t cj = j == i ? cell : bev_cell(geom, starts, j, g);
      if (cj < 0) continue;
      if (cj != cell) break;
      int64_t p, end;
      bev_range(starts, lengths, j, g.num_points, &p, &end);
      float s[V];
#pragma unroll
      for (int k = 0; k < V; ++k) s[k] = 0.0f;
      const Vec<T, V>* rows = reinterpret_cast<const Vec<T, V>*>(feats) + c;
      for (; p + kBevUnroll <= end; p += kBevUnroll) {
        Vec<T, V> x[kBevUnroll];
#pragma unroll
        for (int u = 0; u < kBevUnroll; ++u) x[u] = rows[(p + u) * vecs];
#pragma unroll
        for (int u = 0; u < kBevUnroll; ++u) add_row(s, x[u]);  // in point order
      }
      for (; p < end; ++p) add_row(s, rows[p * vecs]);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] += s[k];
    }
    Vec<T, V> y;
#pragma unroll
    for (int k = 0; k < V; ++k) y.v[k] = to_type<T>(acc[k]);
    reinterpret_cast<Vec<T, V>*>(out)[cell * vecs + c] = y;
  }
}

constexpr int kBevBwdWarps = 8;                                   // warps a block
constexpr int kBevBwdBlockPoints = 32 * kBevBwdWarps;             // a point a lane

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

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
  // next: the first interval that starts at or after p0. Lane l probes the
  // last index of the l-th of 32 equal parts of [lo, hi).
  int64_t lo = 0, hi = ni;
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t probe = lo + (lane + 1) * step - 1;
    const unsigned at_or_after = __ballot_sync(0xffffffffu, probe >= hi || starts[probe] >= p0);
    if (at_or_after == 0) {
      lo = hi;
    } else {
      const int f = __ffs(at_or_after) - 1;
      hi = min64(hi, lo + (f + 1) * step - 1);
      lo += f * step;
    }
  }
  const int64_t next = lo;
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

// The forward over intervals (kBevWarps a block), or the backward over
// `blocks` blocks of kBevBwdBlockPoints points.
template <bool kForward>
bool launch_bev(int dtype, int vec, const void* in, const void* geom, const void* starts, const void* lengths,
                void* out, const BevGrid& g, int64_t blocks, cudaStream_t stream) {
  bool known = true;
  auto go = [&](auto tag, auto vtag) {
    using T = typename decltype(tag)::type;
    constexpr int V = decltype(vtag)::value;
    const auto* src = static_cast<const T*>(in);
    const auto *geom_i = static_cast<const int32_t*>(geom), *starts_i = static_cast<const int32_t*>(starts),
               *lengths_i = static_cast<const int32_t*>(lengths);
    if constexpr (kForward) {
      bev_pool_fwd_kernel<T, V><<<static_cast<unsigned>((g.num_intervals + kBevWarps - 1) / kBevWarps),
                                  kBevWarps * 32, 0, stream>>>(src, geom_i, starts_i, lengths_i,
                                                               static_cast<T*>(out), g);
    } else {
      bev_pool_bwd_kernel<T, V><<<static_cast<unsigned>(blocks), kBevBwdWarps * 32, 0, stream>>>(
          src, geom_i, starts_i, lengths_i, static_cast<T*>(out), g);
    }
  };
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
// int32, 16-byte aligned; starts, lengths: (num_intervals,) int32; out:
// (batch*gz*gx*gy, channels), zero-filled; vec: elements per lane load, a
// divisor of channels, every row base aligned to vec elements.
extern "C" int conch_bev_pool_forward(const void* feats, const void* geom, const void* starts, const void* lengths,
                                      void* out, int64_t num_points, int64_t num_intervals, int channels, int batch,
                                      int gz, int gx, int gy, int dtype, int vec, void* stream) {
  const conch::BevGrid g{num_points, num_intervals, channels, batch, gz, gx, gy};
  if (num_intervals == 0 || channels == 0) return static_cast<int>(cudaSuccess);
  if (!conch::launch_bev<true>(dtype, vec, feats, geom, starts, lengths, out, g, 0,
                               static_cast<cudaStream_t>(stream)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// grad: (batch*gz*gx*gy, channels); out: (num_points, channels), every row
// written (no fill needed); starts ascending and the intervals disjoint;
// `blocks` blocks of 256 points (bev_backward_plan); the rest as
// conch_bev_pool_forward.
extern "C" int conch_bev_pool_backward(const void* grad, const void* geom, const void* starts, const void* lengths,
                                       void* out, int64_t num_points, int64_t num_intervals, int channels, int batch,
                                       int gz, int gx, int gy, int dtype, int vec, int64_t blocks, void* stream) {
  const conch::BevGrid g{num_points, num_intervals, channels, batch, gz, gx, gy};
  if (num_points == 0 || channels == 0) return static_cast<int>(cudaSuccess);
  if (blocks < 1 || blocks * conch::kBevBwdBlockPoints < num_points) return static_cast<int>(cudaErrorInvalidValue);
  if (!conch::launch_bev<false>(dtype, vec, grad, geom, starts, lengths, out, g, blocks,
                                static_cast<cudaStream_t>(stream)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
