// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Gated activations, out = round(act(gate)) * up: the device template of
// K6 (SwiGLU, csrc/silu_and_mul.cu) and K10b (GeGLU, csrc/gelu_tanh_and_mul.cu).
//
// Per element the gate is read in f32, its activation computed in f32
// (the functor's expression, operation for operation: no fast exp, no
// reordering), rounded to the dtype, multiplied by up in f32 and rounded
// once more. For bf16 and f16 the f32 product of two values of the dtype
// is exact, so this is the product in the dtype, as the TPU kernels and
// the plain versions compute it.
//
// Bound on the H100: bytes (gate and up read once, out written once; about
// 10 operations an element, far below the card's ~295 a byte). Llama-3-8B's
// decode step (8 rows, d 14336, bf16) moves 688 KB, 0.2 us at 3.35 TB/s:
// the launch and one DRAM round trip set its time.
//
// Design (the launch plan is Python's: kernels/activation/gated_act.py:
// gated_act_plan, passed through the entry points). A step is rows x d / V
// units: vectors of V elements, 4 at a small step (16 bytes of f32, 8 of
// bf16 or f16: the IEEE division in each activation is a chain of
// dependent instructions with a branch, so a thread's elements barely
// overlap and fewer a thread finish sooner) and 16 bytes at a large one,
// or single elements on the scalar path (a base, a row stride or d that
// breaks 16-byte alignment). Unit u is row u / (d / V), column (u % (d /
// V)) * V: one divide a unit, and out, contiguous, is unit u itself. A
// block of `threads` threads takes ITEMS units a thread, unit base + i *
// threads + threadIdx.x (coalesced for every i), and the grid walks the
// step in rounds of gridDim.x blocks (one round unless the step is past
// the plan's grid cap). A thread issues all its loads of gate and up
// before its first activation, and stores each unit at once. The fused
// halves form passes up = x + d: the (T, 2d) [gate|up] input is read in
// place. The kernel is launched as a programmatic dependent when pdl is
// set: every load of gate and up comes after griddepcontrol.wait (the
// gate|up GEMM before it writes them), and it lets the next kernel launch
// once a round's loads are issued.

#pragma once

#include "common.cuh"

namespace conch {

struct GatedActParams {
  const void* gate;
  const void* up;
  void* out;
  int64_t gate_row_stride;  // elements
  int64_t up_row_stride;
  unsigned units;      // rows * row_units
  unsigned row_units;  // d / V
};

constexpr int kGatedActMaxThreads = 256;

// silu(g) = g * sigmoid(g).
struct SiluAct {
  static __device__ __forceinline__ float apply(float g) { return g / (1.0f + expf(-g)); }
};

// gelu_tanh(g) = g * sigmoid(2 beta (g + kappa g^3)), beta = sqrt(2 / pi),
// kappa = 0.044715 (equal to 0.5 g (1 + tanh(beta (g + kappa g^3)))).
struct GeluTanhAct {
  static constexpr float kBeta = 0.7978845608028654f;
  static constexpr float kKappa = 0.044715f;
  static __device__ __forceinline__ float apply(float g) {
    const float inner = kBeta * (g + kKappa * g * g * g);
    return g / (1.0f + expf(-2.0f * inner));
  }
};

// round(act(g)) * u in f32, before the final rounding to T.
template <typename T, typename Act>
__device__ __forceinline__ float gated(float g, float u) {
  return to_float(from_float<T>(Act::apply(g))) * u;
}

// A unit: V consecutive elements of T, loaded or stored at once (16 or 8
// bytes, or one element).
template <typename T, int V>
using Chunk = std::conditional_t<V == 1, T, std::conditional_t<V * sizeof(T) == 16, uint4, uint2>>;

// A unit widened to f32 (exact) and narrowed back, each value rounded to
// nearest even as from_float does.
template <typename T, int V>
__device__ __forceinline__ void widen(const Chunk<T, V>& c, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = to_float(c);
  } else if constexpr (std::is_same_v<T, float>) {
#pragma unroll
    for (int e = 0; e < V; ++e) f[e] = reinterpret_cast<const float*>(&c)[e];
  } else {
    using T2 = std::conditional_t<std::is_same_v<T, __half>, __half2, __nv_bfloat162>;
#pragma unroll
    for (int e = 0; e < V / 2; ++e) {
      const T2 h = reinterpret_cast<const T2*>(&c)[e];
      float2 v;
      if constexpr (std::is_same_v<T, __half>) v = __half22float2(h);
      else v = __bfloat1622float2(h);
      f[2 * e] = v.x, f[2 * e + 1] = v.y;
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ Chunk<T, V> narrow(const float (&f)[V]) {
  Chunk<T, V> c;
  if constexpr (V == 1) {
    c = from_float<T>(f[0]);
  } else if constexpr (std::is_same_v<T, float>) {
#pragma unroll
    for (int e = 0; e < V; ++e) reinterpret_cast<float*>(&c)[e] = f[e];
  } else {
#pragma unroll
    for (int e = 0; e < V / 2; ++e) {
      if constexpr (std::is_same_v<T, __half>) {
        reinterpret_cast<__half2*>(&c)[e] = __floats2half2_rn(f[2 * e], f[2 * e + 1]);
      } else {
        reinterpret_cast<__nv_bfloat162*>(&c)[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
      }
    }
  }
  return c;
}

template <typename T, typename Act, int V, int ITEMS>
__global__ void __launch_bounds__(kGatedActMaxThreads) gated_act_kernel(const __grid_constant__ GatedActParams p) {
  using C = Chunk<T, V>;
  const unsigned stride = gridDim.x * blockDim.x * ITEMS;
  griddep_wait();  // gate and up are the previous kernel's output
  for (unsigned base = blockIdx.x * blockDim.x * ITEMS + threadIdx.x; base < p.units; base += stride) {
    C g[ITEMS], u[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const unsigned unit = base + i * blockDim.x;
      if (unit < p.units) {
        const unsigned row = unit / p.row_units;
        const unsigned col = (unit - row * p.row_units) * V;
        g[i] = *reinterpret_cast<const C*>(static_cast<const T*>(p.gate) + row * p.gate_row_stride + col);
        u[i] = *reinterpret_cast<const C*>(static_cast<const T*>(p.up) + row * p.up_row_stride + col);
      }
    }
    griddep_launch();
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const unsigned unit = base + i * blockDim.x;
      if (unit >= p.units) continue;
      float gf[V], uf[V];
      widen<T, V>(g[i], gf);
      widen<T, V>(u[i], uf);
#pragma unroll
      for (int e = 0; e < V; ++e) gf[e] = gated<T, Act>(gf[e], uf[e]);
      reinterpret_cast<C*>(p.out)[unit] = narrow<T, V>(gf);
    }
  }
}

template <typename T, typename Act, int V>
cudaError_t launch_items(GatedActParams p, int d, int items, dim3 grid, dim3 block, bool pdl, cudaStream_t s) {
  p.row_units = d / V;
  p.units *= p.row_units;
  switch (items) {
    case 1: return launch_maybe_pdl(gated_act_kernel<T, Act, V, 1>, grid, block, s, pdl, p);
    case 2: return launch_maybe_pdl(gated_act_kernel<T, Act, V, 2>, grid, block, s, pdl, p);
    case 4: return launch_maybe_pdl(gated_act_kernel<T, Act, V, 4>, grid, block, s, pdl, p);
    case 8: return launch_maybe_pdl(gated_act_kernel<T, Act, V, 8>, grid, block, s, pdl, p);
    default: return cudaErrorInvalidValue;
  }
}

// vec elements a unit: 1, or a vector of 8 or 16 bytes.
template <typename T, typename Act>
cudaError_t launch_vec(const GatedActParams& p, int d, int vec, int items, dim3 grid, dim3 block, bool pdl,
                       cudaStream_t s) {
  if (vec < 1 || d % vec) return cudaErrorInvalidValue;
  if (vec == 1) return launch_items<T, Act, 1>(p, d, items, grid, block, pdl, s);
  constexpr int kVec8 = 8 / static_cast<int>(sizeof(T));
  if (vec == kVec8) return launch_items<T, Act, kVec8>(p, d, items, grid, block, pdl, s);
  if (vec == kVec16<T>) return launch_items<T, Act, kVec16<T>>(p, d, items, grid, block, pdl, s);
  return cudaErrorInvalidValue;
}

// gate and up (rows, d) with their own row strides (elements), out (rows,
// d) contiguous; the plan (gated_act_plan): vec elements a unit, threads a
// block, items a thread, grid blocks; pdl launches the kernel as a
// programmatic dependent.
template <typename Act>
int gated_act(const void* gate, const void* up, void* out, int rows, int d, int64_t gate_row_stride,
              int64_t up_row_stride, int dtype, int vec, int threads, int items, int grid, int pdl, void* stream) {
  if (rows == 0 || d == 0) return static_cast<int>(cudaSuccess);
  if (threads < 1 || threads > kGatedActMaxThreads || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  const GatedActParams p{gate, up, out, gate_row_stride, up_row_stride, static_cast<unsigned>(rows), 0};
  const dim3 g(grid), b(threads);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t status;
  switch (dtype) {
    case kFloat32: status = launch_vec<float, Act>(p, d, vec, items, g, b, pdl != 0, s); break;
    case kBFloat16: status = launch_vec<__nv_bfloat16, Act>(p, d, vec, items, g, b, pdl != 0, s); break;
    case kFloat16: status = launch_vec<__half, Act>(p, d, vec, items, g, b, pdl != 0, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (status != cudaSuccess) return static_cast<int>(status);
  return static_cast<int>(cudaGetLastError());
}

// The fused halves of x (rows, 2d) at row stride x_row_stride: gate =
// x[:, :d], up = x[:, d:], read in place.
template <typename Act>
int gated_act_halves(const void* x, void* out, int rows, int d, int64_t x_row_stride, int dtype, int vec,
                     int threads, int items, int grid, int pdl, void* stream) {
  const size_t elem = dtype == kFloat32 ? sizeof(float) : sizeof(__half);
  const void* up = static_cast<const char*>(x) + static_cast<size_t>(d) * elem;
  return gated_act<Act>(x, up, out, rows, d, x_row_stride, x_row_stride, dtype, vec, threads, items, grid, pdl,
                        stream);
}

}  // namespace conch
