// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// NeoX rotary embedding (K5).
//
// Replaces conch_tpu/kernels/embedding/rotary_embedding.py:_rope_kernel.
// For each token and head of q (T, QH*D) and k (T, KH*D) it rotates the
// pairs (x[i], x[i + rot/2]), i < rot/2, by the f32 row
// cos_sin[clamp(pos)] = [cos | sin]: x1*cos - x2*sin and x2*cos + x1*sin,
// each product and the sum rounded in f32 (as the plain version's separate
// multiplies and add), one rounding to the dtype on store; elements past
// rot_dim are copied. Outputs are written contiguous.
//
// Bound on the H100: bytes. Per token it reads q and k once, one f32 row
// of the cache and a position, and writes q and k once: about one
// operation a byte, far below the card's ~295. At a decode step of 8
// tokens that is 0.17 MB, 50 ns at 3.35 TB/s: the launch and one DRAM
// round trip set the time.
//
// Design (the launch plan is Python's: kernels/embedding/
// rotary_embedding.py:rope_plan, passed through the entry point). The grid
// runs over (token, group of heads), so a decode step of 8 tokens spreads
// over the card's SMs. Vector path: a thread owns one chunk of one head,
// threadIdx.x the chunk and threadIdx.y the head within the group, so no
// thread divides: chunk c < rot/2 / V rotates V = 16 / sizeof(T)
// consecutive pairs (one 16-byte load of x1's V elements, one of x2's, and
// V floats each of cos and sin as float4s, every load issued before the
// first multiply; two 16-byte stores); a chunk past them copies V elements
// of the tail past rot_dim. The plan takes it only when every address is
// 16-byte aligned. Scalar path (a row stride, rot/2 or a tail that breaks
// that alignment): a thread walks the head's pairs and tail elements with a
// stride of blockDim.x. The kernel is launched as a programmatic dependent
// when pdl is set: it reads q, k and positions, and stores, only after
// griddepcontrol.wait (the cache is read after the position it needs), and
// lets the next kernel launch once its loads are issued.

#include "common.cuh"

namespace conch {
namespace {

struct RopeParams {
  const void* q;
  const void* k;
  void* q_out;
  void* k_out;
  const float* cos_sin;
  const int32_t* positions;
  int64_t q_row_stride;
  int64_t k_row_stride;
  int num_q_heads;
  int num_k_heads;
  int head_size;
  int rot_dim;
  int max_position;
};

constexpr int kMaxThreads = 1024;

template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxThreads) rope_kernel(const __grid_constant__ RopeParams p) {
  const int h = blockIdx.y * blockDim.y + threadIdx.y;
  if (h >= p.num_q_heads + p.num_k_heads) return;
  const int64_t t = blockIdx.x;
  const bool is_q = h < p.num_q_heads;
  const int hh = is_q ? h : h - p.num_q_heads;
  const T* src = static_cast<const T*>(is_q ? p.q : p.k) + t * (is_q ? p.q_row_stride : p.k_row_stride) +
                 static_cast<int64_t>(hh) * p.head_size;
  T* dst = static_cast<T*>(is_q ? p.q_out : p.k_out) +
           (t * (is_q ? p.num_q_heads : p.num_k_heads) + hh) * static_cast<int64_t>(p.head_size);
  const int half = p.rot_dim >> 1;
  griddep_wait();  // q, k and positions may be the previous kernel's output
  int pos = p.positions[t];
  pos = pos < 0 ? 0 : (pos >= p.max_position ? p.max_position - 1 : pos);
  const float* cs = p.cos_sin + static_cast<int64_t>(pos) * p.rot_dim;
  if constexpr (VEC) {
    constexpr int V = kVec16<T>;
    const int c = threadIdx.x;
    if (c * V < half) {
      const int i = c * V;
      const uint4 a = *reinterpret_cast<const uint4*>(src + i);
      const uint4 b = *reinterpret_cast<const uint4*>(src + half + i);
      float4 cv[V / 4], sv[V / 4];
#pragma unroll
      for (int u = 0; u < V / 4; ++u) {
        cv[u] = __ldg(reinterpret_cast<const float4*>(cs + i) + u);
        sv[u] = __ldg(reinterpret_cast<const float4*>(cs + half + i) + u);
      }
      griddep_launch();
      float x1[V], x2[V], o1[V], o2[V];
      unpack16<T>(a, x1);
      unpack16<T>(b, x2);
      const float* cf = reinterpret_cast<const float*>(cv);
      const float* sf = reinterpret_cast<const float*>(sv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        o1[e] = __fsub_rn(__fmul_rn(x1[e], cf[e]), __fmul_rn(x2[e], sf[e]));
        o2[e] = __fadd_rn(__fmul_rn(x2[e], cf[e]), __fmul_rn(x1[e], sf[e]));
      }
      *reinterpret_cast<uint4*>(dst + i) = pack16<T>(o1);
      *reinterpret_cast<uint4*>(dst + half + i) = pack16<T>(o2);
    } else {
      const int j = c * V + half;  // chunk c - half / V of the tail, from rot_dim on
      const uint4 a = *reinterpret_cast<const uint4*>(src + j);
      griddep_launch();
      *reinterpret_cast<uint4*>(dst + j) = a;
    }
  } else {
    const int tail = p.head_size - p.rot_dim;
    for (int i = threadIdx.x; i < half + tail; i += blockDim.x) {
      if (i < half) {
        const float x1 = to_float(src[i]);
        const float x2 = to_float(src[i + half]);
        const float c = __ldg(cs + i);
        const float s = __ldg(cs + half + i);
        dst[i] = from_float<T>(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
        dst[i + half] = from_float<T>(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s)));
      } else {
        const int j = i + half;  // tail element i - half, from rot_dim on
        dst[j] = src[j];
      }
    }
    griddep_launch();
  }
}

template <typename T>
cudaError_t launch(const RopeParams& p, bool vec, dim3 grid, dim3 block, bool pdl, cudaStream_t stream) {
  return vec ? launch_maybe_pdl(rope_kernel<T, true>, grid, block, stream, pdl, p)
             : launch_maybe_pdl(rope_kernel<T, false>, grid, block, stream, pdl, p);
}

}  // namespace
}  // namespace conch

// q (T, QH*D) and k (T, KH*D) with row strides; q_out, k_out contiguous;
// cos_sin (max_position, rot_dim) f32; positions (T,) int32. The plan
// (rope_plan): path 0 vector or 1 scalar, block (block_x, block_y), grid
// (T, grid_y); pdl launches the kernel as a programmatic dependent.
extern "C" int conch_rotary_embedding(const void* q, const void* k, void* q_out, void* k_out, const void* cos_sin,
                                      const void* positions, int num_tokens, int64_t q_row_stride,
                                      int64_t k_row_stride, int num_q_heads, int num_k_heads, int head_size,
                                      int rot_dim, int max_position, int dtype, int path, int block_x, int block_y,
                                      int grid_y, int pdl, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (num_tokens == 0) return static_cast<int>(cudaSuccess);
  if (path != 0 && path != 1) return static_cast<int>(cudaErrorInvalidValue);
  const conch::RopeParams p{q,           k,           q_out,       k_out,       static_cast<const float*>(cos_sin),
                            static_cast<const int32_t*>(positions), q_row_stride, k_row_stride, num_q_heads,
                            num_k_heads, head_size,   rot_dim,     max_position};
  const dim3 grid(num_tokens, grid_y), block(block_x, block_y);
  const bool vec = path == 0;
  cudaError_t status;
  switch (dtype) {
    case conch::kBFloat16: status = conch::launch<__nv_bfloat16>(p, vec, grid, block, pdl != 0, s); break;
    case conch::kFloat16: status = conch::launch<__half>(p, vec, grid, block, pdl != 0, s); break;
    case conch::kFloat32: status = conch::launch<float>(p, vec, grid, block, pdl != 0, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (status != cudaSuccess) return static_cast<int>(status);
  return static_cast<int>(cudaGetLastError());
}
