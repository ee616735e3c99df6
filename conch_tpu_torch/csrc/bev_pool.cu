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
// K13b: one warp per interval reads its cell's row once (it stays in
// registers; a row of C <= 32 * vector elements per pass) and stores it to
// each of the interval's points: a pure copy, equal bit for bit to the
// plain version. The output is zero-filled by the caller, so points in no
// interval are zero. Bound: bytes (the point rows written).

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

template <typename T, int V>
__global__ void __launch_bounds__(kBevWarps * 32) bev_pool_bwd_kernel(const T* __restrict__ grad,
                                                                     const int32_t* __restrict__ geom,
                                                                     const int32_t* __restrict__ starts,
                                                                     const int32_t* __restrict__ lengths,
                                                                     T* __restrict__ out, BevGrid g) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBevWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= g.num_intervals) return;
  const int64_t cell = bev_cell(geom, starts, i, g);
  if (cell < 0) return;  // its points keep the caller's zeros
  int64_t begin, end;
  bev_range(starts, lengths, i, g.num_points, &begin, &end);
  const int vecs = g.channels / V;
  for (int c = lane; c < vecs; c += 32) {
    const Vec<T, V> row = reinterpret_cast<const Vec<T, V>*>(grad)[cell * vecs + c];
    Vec<T, V>* dst = reinterpret_cast<Vec<T, V>*>(out) + c;
    for (int64_t p = begin; p < end; ++p) dst[p * vecs] = row;
  }
}

template <bool kForward>
bool launch_bev(int dtype, int vec, const void* in, const void* geom, const void* starts, const void* lengths,
                void* out, const BevGrid& g, cudaStream_t stream) {
  const int64_t blocks = (g.num_intervals + kBevWarps - 1) / kBevWarps;
  bool known = true;
  auto go = [&](auto tag, auto vtag) {
    using T = typename decltype(tag)::type;
    constexpr int V = decltype(vtag)::value;
    auto kernel = kForward ? bev_pool_fwd_kernel<T, V> : bev_pool_bwd_kernel<T, V>;
    kernel<<<static_cast<unsigned>(blocks), kBevWarps * 32, 0, stream>>>(
        static_cast<const T*>(in), static_cast<const int32_t*>(geom), static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(lengths), static_cast<T*>(out), g);
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
  if (!conch::launch_bev<true>(dtype, vec, feats, geom, starts, lengths, out, g,
                                                     static_cast<cudaStream_t>(stream)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// grad: (batch*gz*gx*gy, channels); out: (num_points, channels), zero-filled;
// the rest as conch_bev_pool_forward.
extern "C" int conch_bev_pool_backward(const void* grad, const void* geom, const void* starts, const void* lengths,
                                       void* out, int64_t num_points, int64_t num_intervals, int channels, int batch,
                                       int gz, int gx, int gy, int dtype, int vec, void* stream) {
  const conch::BevGrid g{num_points, num_intervals, channels, batch, gz, gx, gy};
  if (num_intervals == 0 || channels == 0) return static_cast<int>(cudaSuccess);
  if (!conch::launch_bev<false>(dtype, vec, grad, geom, starts, lengths, out, g,
                                                     static_cast<cudaStream_t>(stream)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
