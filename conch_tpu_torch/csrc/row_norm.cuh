// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// RMS norm of rows held in registers, shared by K4 (rms_norm.cu, Llama's
// norm) and K10a (gemma_rms_norm.cu, Gemma's). The two differ only in a
// policy (Norm): the type the squares are summed in, how the row's rsqrt
// is formed from the sum, and the value stored before its one rounding to
// x's dtype.
//
// Bound on the H100: bytes (x read, out written, w read; a few operations
// an element). A decode step (8 x 4096 bf16, 16 x 2304) moves 0.13 to 0.15
// MB, about 45 ns at 3.35 TB/s, so the launch and one DRAM round trip set
// its time; a 512-row prefill chunk of 4096 moves 8.4 MB (2.5 us).
//
// Design (the launch plan is Python's: kernels/normalization/row_norm.py:
// row_norm_plan, passed through the entry point). A row belongs to
// threads_per_row threads (blockDim.x; a power of two below 32, else whole
// warps) and a block holds rows_per_block rows (blockDim.y). Register
// path: each thread loads up to kMaxItems vectors of its row (4 of 16
// bytes or 8 scalars; vector j of the row is thread j % threads_per_row's
// item j / threads_per_row) and the weight's in the same vectors, all
// before its first use; it sums the squares, the row's sum is reduced by
// warp shuffles (through shared memory only when a row spans several
// warps), and the row is written from the same registers: x is read from
// memory once. Vectors are 16 bytes (V = 8 bf16 or f16, 4 f32) when every
// row start of x and out and the weight are 16-byte aligned; a row's last
// hidden % V elements (only a single row can have them) are a scalar tail.
// Otherwise V = 1 (the scalar path). A block holds up to 512 threads on
// the register paths and 1024 on the looped ones (kBlockThreads); rows
// wider than 512 threads times kMaxItems vectors take the looped path: one
// block a row sums the squares in a strided loop and a second loop reads x
// again (from L2) to write. The kernel is launched as a programmatic
// dependent when pdl is set: it loads and stores only after
// griddepcontrol.wait, and lets the next kernel launch once its loads are
// issued.

#pragma once

#include "common.cuh"

namespace conch {
namespace {

struct NormParams {
  const void* x;
  const void* w;
  void* out;
  int64_t x_row_stride;
  int rows;
  int hidden;
  int items;
  float epsilon;
};

constexpr int kMaxThreads = 1024;
// Vectors a thread holds on the register path: 4 of 16 bytes (x's and
// w's: 32 registers, their addresses and the unpacked floats within the
// 128 registers of a 512-thread block without spills), 8 scalars.
template <int V>
inline constexpr int kMaxItems = V > 1 ? 4 : 8;

// Threads a block may have: 512 on the register paths (128 registers a
// thread), 1024 on the looped ones.
template <bool LOOPED>
inline constexpr int kBlockThreads = LOOPED ? kMaxThreads : 512;

// V elements of T at p, as floats (V = 1: one element; else 16 bytes).
template <typename T, int V>
struct Vec {
  using Raw = std::conditional_t<V == 1, T, uint4>;
  static __device__ __forceinline__ Raw load(const T* p) { return *reinterpret_cast<const Raw*>(p); }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[V]) {
    if constexpr (V == 1) f[0] = to_float(r);
    else unpack16<T>(r, f);
  }
  static __device__ __forceinline__ void store(T* p, const float (&f)[V]) {
    if constexpr (V == 1) *p = from_float<T>(f[0]);
    else *reinterpret_cast<uint4*>(p) = pack16<T>(f);
  }
};

// The sum of sq over the threads of one row; every thread of the block
// calls it. Rows of whole warps sum a warp with constant offsets.
template <typename Acc>
__device__ __forceinline__ Acc row_sum(Acc sq, Acc* warp_sums) {
  const int tpr = blockDim.x;
  if (tpr <= 32) {
    for (int offset = tpr >> 1; offset > 0; offset >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, offset);
    return sq;
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, offset);
  const int warps = tpr >> 5;
  Acc* mine = warp_sums + threadIdx.y * warps;
  if ((threadIdx.x & 31) == 0) mine[threadIdx.x >> 5] = sq;
  __syncthreads();
  Acc total = 0;
  for (int i = 0; i < warps; ++i) total += mine[i];
  return total;
}

// Norm: Norm::Acc, the type the squares are summed in; Norm::add(sq, f)
// adds f's square; Norm::inv(total, hidden, eps), the row's rsqrt;
// Norm::value<T>(x, inv, w), the output before its rounding to T.
template <typename Norm, typename T, int V, bool LOOPED>
__global__ void __launch_bounds__(kBlockThreads<LOOPED>) row_norm_kernel(const __grid_constant__ NormParams p) {
  using Vx = Vec<T, V>;
  using Acc = typename Norm::Acc;
  __shared__ Acc warp_sums[kMaxThreads / 32];
  const int tpr = blockDim.x;
  const int lane = threadIdx.x;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  const bool live = row < p.rows;
  const T* xr = static_cast<const T*>(p.x) + row * p.x_row_stride;
  const T* w = static_cast<const T*>(p.w);
  T* outr = static_cast<T*>(p.out) + row * p.hidden;
  const int nvec = p.hidden / V;
  const int t0 = nvec * V;  // the scalar tail's first element
  const bool has_tail = live && t0 + lane < p.hidden;
  if constexpr (LOOPED) {
    griddep_wait();  // x may be the previous kernel's output
    Acc sq = 0;
    for (int j = lane; live && j < nvec; j += tpr) {
      float f[V];
      Vx::unpack(Vx::load(xr + j * V), f);
#pragma unroll
      for (int e = 0; e < V; ++e) Norm::add(sq, f[e]);
    }
    if (has_tail) Norm::add(sq, to_float(xr[t0 + lane]));
    const float inv = Norm::inv(row_sum(sq, warp_sums), p.hidden, p.epsilon);
    for (int j = lane; live && j < nvec; j += tpr) {
      float f[V], g[V];
      Vx::unpack(Vx::load(xr + j * V), f);
      Vx::unpack(Vx::load(w + j * V), g);
#pragma unroll
      for (int e = 0; e < V; ++e) f[e] = Norm::template value<T>(f[e], inv, g[e]);
      Vx::store(outr + j * V, f);
    }
    if (has_tail) {
      outr[t0 + lane] = from_float<T>(Norm::template value<T>(to_float(xr[t0 + lane]), inv, to_float(w[t0 + lane])));
    }
    griddep_launch();
  } else {
    constexpr int kItems = kMaxItems<V>;
    typename Vx::Raw xv[kItems], wv[kItems];
    T xt, wt;
    // x may be the previous kernel's output. w is loaded with it, after
    // the wait: loads issued before griddepcontrol.wait finish before it
    // returns, so they would add a round trip to a launch that nothing
    // overlaps (tools/row_plan_sweep.py --diagnostics).
    griddep_wait();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = lane + k * tpr;
      if (live && k < p.items && j < nvec) {
        xv[k] = Vx::load(xr + j * V);
        wv[k] = Vx::load(w + j * V);
      }
    }
    if (has_tail) xt = xr[t0 + lane], wt = w[t0 + lane];
    griddep_launch();
    Acc sq = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (live && k < p.items && lane + k * tpr < nvec) {
        float f[V];
        Vx::unpack(xv[k], f);
#pragma unroll
        for (int e = 0; e < V; ++e) Norm::add(sq, f[e]);
      }
    }
    if (has_tail) Norm::add(sq, to_float(xt));
    const float inv = Norm::inv(row_sum(sq, warp_sums), p.hidden, p.epsilon);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = lane + k * tpr;
      if (live && k < p.items && j < nvec) {
        float f[V], g[V];
        Vx::unpack(xv[k], f);
        Vx::unpack(wv[k], g);
#pragma unroll
        for (int e = 0; e < V; ++e) f[e] = Norm::template value<T>(f[e], inv, g[e]);
        Vx::store(outr + j * V, f);
      }
    }
    if (has_tail) outr[t0 + lane] = from_float<T>(Norm::template value<T>(to_float(xt), inv, to_float(wt)));
  }
}

template <typename Norm, typename T>
cudaError_t launch_path(const NormParams& p, int path, dim3 grid, dim3 block, bool pdl, cudaStream_t stream) {
  constexpr int V = kVec16<T>;
  switch (path) {
    case 0: return launch_maybe_pdl(row_norm_kernel<Norm, T, V, false>, grid, block, stream, pdl, p);
    case 1: return launch_maybe_pdl(row_norm_kernel<Norm, T, 1, false>, grid, block, stream, pdl, p);
    case 2: return launch_maybe_pdl(row_norm_kernel<Norm, T, V, true>, grid, block, stream, pdl, p);
    case 3: return launch_maybe_pdl(row_norm_kernel<Norm, T, 1, true>, grid, block, stream, pdl, p);
    default: return cudaErrorInvalidValue;
  }
}

// One launch of the plan (row_norm_plan): path 0 vector, 1 scalar, 2
// looped in vectors, 3 looped in scalars; block (threads_per_row,
// rows_per_block), grid_x blocks, items vectors a thread (register paths);
// pdl launches the kernel as a programmatic dependent. f32, bf16 and f16.
template <typename Norm>
int launch_row_norm(const NormParams& p, int dtype, int path, int threads_per_row, int rows_per_block, int grid_x,
                    int pdl, cudaStream_t s) {
  if (p.rows == 0) return static_cast<int>(cudaSuccess);
  const int max_items = path == 0 ? kMaxItems<8> : kMaxItems<1>;
  const int max_threads = path < 2 ? kBlockThreads<false> : kBlockThreads<true>;
  if ((path < 2 && p.items > max_items) || threads_per_row * rows_per_block > max_threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(grid_x), block(threads_per_row, rows_per_block);
  cudaError_t status;
  switch (dtype) {
    case kBFloat16: status = launch_path<Norm, __nv_bfloat16>(p, path, grid, block, pdl != 0, s); break;
    case kFloat16: status = launch_path<Norm, __half>(p, path, grid, block, pdl != 0, s); break;
    case kFloat32: status = launch_path<Norm, float>(p, path, grid, block, pdl != 0, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (status != cudaSuccess) return static_cast<int>(status);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace conch
