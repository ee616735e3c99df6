// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Gemma RMS norm over the last axis (K10a).
//
// Replaces conch_tpu/kernels/normalization/gemma_rms_norm.py:_gemma_rms_norm_kernel.
// out = x * rsqrt(mean(x^2) + eps) * (1 + w), the whole product in f32 and
// rounded to x's dtype once at the end (K4, Llama's norm, rounds the
// normalized value before the weight multiply; this kernel must not).
//
// Bound on the H100: bytes (x read, out written, w read; a few operations
// an element). Gemma-2-2B's decode step (16 x 2304 bf16) moves 0.15 MB,
// 44 ns at 3.35 TB/s, so the launch and one DRAM round trip set its time;
// a 512-row prefill chunk moves 4.72 MB (1.41 us).
//
// Design (the launch plan is Python's: kernels/normalization/
// gemma_rms_norm.py:gemma_norm_plan, passed through the entry point). A
// row belongs to threads_per_row threads (blockDim.x; a power of two below
// 32, else whole warps) and a block holds rows_per_block rows
// (blockDim.y). Register path: each thread loads up to kMaxItems vectors
// of its row (4 of 16 bytes or 8 scalars; vector j of the row is thread
// j % threads_per_row's item j / threads_per_row) and the weight's in the
// same vectors, all before its first use; it sums the squares, the row's
// sum is reduced by warp shuffles (through shared memory only when a row
// spans several warps), and the row is written from
// the same registers: x is read from memory once. Vectors are 16 bytes
// (V = 8 bf16 or f16, 4 f32) when every row start of x and out and the
// weight are 16-byte aligned; a row's last hidden % V elements (only a
// single row can have them) are a scalar tail. Otherwise V = 1 (the scalar
// path). A block holds up to 512 threads on the register paths and 1024
// on the looped ones (kBlockThreads); rows wider than 512 threads times
// kMaxItems vectors take the looped path: one block a row sums the squares
// in a strided loop and a second loop reads x again (from L2) to write.
// The kernel is launched as a programmatic dependent when pdl is set: it
// loads and stores only after griddepcontrol.wait, and lets the next
// kernel launch once its loads are issued.

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

__device__ __forceinline__ float norm_value(float x, float inv, float w) { return x * inv * (1.0f + w); }

// The sum of sq over the threads of one row; every thread of the block
// calls it.
__device__ __forceinline__ float row_sum(float sq, float* warp_sums) {
  const int tpr = blockDim.x;
  if (tpr <= 32) {
    for (int offset = tpr >> 1; offset > 0; offset >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, offset);
    return sq;
  }
  sq = warp_sum(sq);
  const int warps = tpr >> 5;
  float* mine = warp_sums + threadIdx.y * warps;
  if ((threadIdx.x & 31) == 0) mine[threadIdx.x >> 5] = sq;
  __syncthreads();
  float total = 0.0f;
  for (int i = 0; i < warps; ++i) total += mine[i];
  return total;
}

// Threads a block may have: 512 on the register paths (128 registers a
// thread), 1024 on the looped ones.
template <bool LOOPED>
inline constexpr int kBlockThreads = LOOPED ? kMaxThreads : 512;

template <typename T, int V, bool LOOPED>
__global__ void __launch_bounds__(kBlockThreads<LOOPED>)
    gemma_rms_norm_kernel(const __grid_constant__ NormParams p) {
  using Vx = Vec<T, V>;
  __shared__ float warp_sums[kMaxThreads / 32];
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
    float sq = 0.0f;
    for (int j = lane; live && j < nvec; j += tpr) {
      float f[V];
      Vx::unpack(Vx::load(xr + j * V), f);
#pragma unroll
      for (int e = 0; e < V; ++e) sq += f[e] * f[e];
    }
    if (has_tail) {
      const float f = to_float(xr[t0 + lane]);
      sq += f * f;
    }
    const float inv = rsqrtf(row_sum(sq, warp_sums) / static_cast<float>(p.hidden) + p.epsilon);
    for (int j = lane; live && j < nvec; j += tpr) {
      float f[V], g[V];
      Vx::unpack(Vx::load(xr + j * V), f);
      Vx::unpack(Vx::load(w + j * V), g);
#pragma unroll
      for (int e = 0; e < V; ++e) f[e] = norm_value(f[e], inv, g[e]);
      Vx::store(outr + j * V, f);
    }
    if (has_tail) outr[t0 + lane] = from_float<T>(norm_value(to_float(xr[t0 + lane]), inv, to_float(w[t0 + lane])));
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
    float sq = 0.0f;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (live && k < p.items && lane + k * tpr < nvec) {
        float f[V];
        Vx::unpack(xv[k], f);
#pragma unroll
        for (int e = 0; e < V; ++e) sq += f[e] * f[e];
      }
    }
    if (has_tail) sq += to_float(xt) * to_float(xt);
    const float inv = rsqrtf(row_sum(sq, warp_sums) / static_cast<float>(p.hidden) + p.epsilon);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = lane + k * tpr;
      if (live && k < p.items && j < nvec) {
        float f[V], g[V];
        Vx::unpack(xv[k], f);
        Vx::unpack(wv[k], g);
#pragma unroll
        for (int e = 0; e < V; ++e) f[e] = norm_value(f[e], inv, g[e]);
        Vx::store(outr + j * V, f);
      }
    }
    if (has_tail) outr[t0 + lane] = from_float<T>(norm_value(to_float(xt), inv, to_float(wt)));
  }
}

template <typename T>
cudaError_t launch(const NormParams& p, int path, dim3 grid, dim3 block, bool pdl, cudaStream_t stream) {
  constexpr int V = kVec16<T>;
  switch (path) {
    case 0: return launch_maybe_pdl(gemma_rms_norm_kernel<T, V, false>, grid, block, stream, pdl, p);
    case 1: return launch_maybe_pdl(gemma_rms_norm_kernel<T, 1, false>, grid, block, stream, pdl, p);
    case 2: return launch_maybe_pdl(gemma_rms_norm_kernel<T, V, true>, grid, block, stream, pdl, p);
    case 3: return launch_maybe_pdl(gemma_rms_norm_kernel<T, 1, true>, grid, block, stream, pdl, p);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace conch

// x (rows, hidden) with row stride x_row_stride, w (hidden,), out (rows,
// hidden) contiguous; all of one dtype. The plan (gemma_norm_plan): path
// 0 vector, 1 scalar, 2 looped in vectors, 3 looped in scalars; block
// (threads_per_row, rows_per_block), grid_x blocks, items vectors a thread
// (register paths); pdl launches the kernel as a programmatic dependent.
extern "C" int conch_gemma_rms_norm(const void* x, const void* w, void* out, int rows, int hidden,
                                    int64_t x_row_stride, float epsilon, int dtype, int path, int threads_per_row,
                                    int rows_per_block, int items, int grid_x, int pdl, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const int max_items = path == 0 ? conch::kMaxItems<8> : conch::kMaxItems<1>;
  const int max_threads = path < 2 ? conch::kBlockThreads<false> : conch::kBlockThreads<true>;
  if ((path < 2 && items > max_items) || threads_per_row * rows_per_block > max_threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const conch::NormParams p{x, w, out, x_row_stride, rows, hidden, items, epsilon};
  const dim3 grid(grid_x), block(threads_per_row, rows_per_block);
  cudaError_t status;
  switch (dtype) {
    case conch::kBFloat16: status = conch::launch<__nv_bfloat16>(p, path, grid, block, pdl != 0, s); break;
    case conch::kFloat16: status = conch::launch<__half>(p, path, grid, block, pdl != 0, s); break;
    case conch::kFloat32: status = conch::launch<float>(p, path, grid, block, pdl != 0, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (status != cudaSuccess) return static_cast<int>(status);
  return static_cast<int>(cudaGetLastError());
}
