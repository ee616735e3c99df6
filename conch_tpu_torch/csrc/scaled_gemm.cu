// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Scaled GEMM of int8 (or float8_e4m3fn) operands with row and column
// scales (K8).
//
// Replaces conch_tpu/kernels/quantization/gemm.py:_scaled_gemm_kernel
// (launcher scaled_gemm_launcher). out[M, N] = float(a @ b) * sa[m] * sb[n],
// in that order, rounded to the output dtype; a scalar sa or sb broadcasts.
//
// Bound on the H100: bytes at decode (M <= 32: K*N bytes of b, 16.8 MB
// for 4096 x 4096), operations at a 512-row prefill chunk.
//
// int8: the shared mainloop of quant_gemm_mainloop.cuh with an s8 policy
// (ScaledLayout), transposed as the weight-only GEMMs are: outT = bT . aT,
// so that b's N fills wgmma.m64nBNk32.s32.s8.s8's 64-row side and a's rows
// are its N (BN = 32, 64 or 128). A slice is 128 k: a's rows K-major in
// one 128-byte swizzled TMA box (B from shared memory), and b's 128 rows of
// the block's 128 columns in another, in b's own (K, N) layout (no
// repack). A thread reads, for each k32 step, the 2-byte pair of its two
// columns (wgmma rows g and g + 8) in each of its 8 k rows (4t .. 4t+3 and
// 16 + 4t .. 16 + 4t+3) and turns them around with byte permutes, so that
// each register holds 4 k values of one column: wgmma's A fragment. The
// sums are exact in s32 (the largest served one, 127 * 127 * 14336, fits);
// a split writes them to an int32 workspace (an f32 one would round sums
// above 2^24), and the reduction kernel, or the block itself with one
// split, applies fmul_rn(fmul_rn(float(v), sa[m]), sb[n]) and rounds once.
// The launch plan is quant_gemm_plan's, layout "scaled".
//
// float8_e4m3fn (E4m3Layout): the same geometry and fragments (an e4m3 byte
// lands where an s8 byte does), on wgmma.m64nBNk32.f32.e4m3.e4m3. Hopper's
// fp8 wgmma keeps only about 14 bits of its f32 sum (the DeepSeek-V3
// report), so each slice's four k32 steps sum from zero into a slice sum,
// and retire adds that into the f32 running sum on the CUDA cores
// (promotion, one FADD an output a slice). On the H100 it costs 4.6% at 512
// rows (tools/parent_compare.py --mutant k8_e4m3_not_promoted); without it
// an all-positive sum over K 14336 is off by 3% of itself, so it stays.
// Retiring slice s under slice s + 1's wgmmas (a slice sum in each
// fragment set) was 10% slower: ptxas serializes wgmmas whose accumulators
// are read inside the pipeline stage (C7514). A split writes its f32 sums to
// an f32 workspace, and the reduction adds them in split order, then applies
// fmul_rn(fmul_rn(sum, sa[m]), sb[n]) and rounds once, as the block does
// itself with one split. The plan is quant_gemm_plan's, layout "e4m3":
// TMA needs a's and b's row strides and bases 16-byte aligned (a is
// realigned by the wrapper, so N % 16 == 0), and takes any K >= 1 (the last
// slice zero-filled past K). Shapes it cannot take (N % 16 != 0, b's layer
// off 16 bytes, K 0) run the loop kernel below: every value converted to
// f32 (exact, as bf16 is), the products summed in f32 by a plain loop, one
// thread an output; the wrapper chooses it by shape (bn 0), before the
// launch.

#include <cuda_fp8.h>

#include "quant_gemm_mainloop.cuh"

namespace conch {
namespace {

using qgemm::Params;
using qgemm::Stage;

struct ScaledLayout {
  using Acc = int;                       // wgmma sums int8 in s32
  static constexpr bool kScaledOut = true;  // outputs take sa[m] and sb[n]
  static constexpr int XB = 1;           // bytes of an x (a) value
  static constexpr int EPP = 4;
  static constexpr int KS = 128;         // k of a slice: one 128-byte swizzle atom of a's rows, and b's rows
  static constexpr int WR = KS / 4;      // b's KS rows of kCols bytes, counted as 4-byte words
  static constexpr int STEPS = KS / 32;  // k32 step j: k 32j .. 32j + 31 of the slice
  static constexpr int SR = 0;           // no scales staged: they apply in the epilogue
  static constexpr bool kGroupTable = false;

  template <int BN>
  struct Frag {
    uint32_t a[STEPS][4];
  };
  template <int BN>
  struct State {};

  const Params& p;

  __device__ ScaledLayout(const Params& params, float*) : p(params) {}

  __device__ int word_row(int s) const { return KS * s; }  // b's tensor map counts rows of k
  __device__ int scale_row(int) const { return 0; }
  template <int BN>
  __device__ void load_x(uint32_t dst, uint32_t bar, int s, int m0) const {
    qgemm::tma_2d(dst, p.tm_x, bar, KS * s, m0);
  }
  template <int BN>
  __device__ static uint64_t x_desc(uint32_t x, int j) {
    return qgemm::desc_sw128(x + 32 * j);
  }

  // The bytes of columns c, c + 1 (c even) in row k of the staged b tile:
  // 128-byte rows under the 128-byte swizzle (16-byte chunk i of row k at
  // chunk i ^ (k % 8)).
  __device__ static uint32_t column_pair(const uint8_t* w, int k, int c) {
    return *reinterpret_cast<const uint16_t*>(w + k * 128 + ((((c >> 4) ^ (k & 7)) << 4) | (c & 15)));
  }

  template <int BN, class S>
  __device__ void decode(Frag<BN>& fr, S&, const Stage& st, int, float*) const {
    const int t = threadIdx.x & 3;
    const int c = qgemm::pair_column();
    const uint8_t* w = reinterpret_cast<const uint8_t*>(st.w);
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      uint32_t r[8];  // rows 4t + q (q < 4) and 16 + 4t + q - 4: byte 0 column c, byte 1 column c + 1
#pragma unroll
      for (int q = 0; q < 8; ++q) r[q] = column_pair(w, 32 * j + 4 * t + (q & 3) + 16 * (q >> 2), c);
      const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
      const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
      const uint32_t hi01 = __byte_perm(r[4], r[5], 0x5140);
      const uint32_t hi23 = __byte_perm(r[6], r[7], 0x5140);
      fr.a[j][0] = __byte_perm(lo01, lo23, 0x5410);  // column c, k 4t .. 4t+3
      fr.a[j][1] = __byte_perm(lo01, lo23, 0x7632);  // column c + 1
      fr.a[j][2] = __byte_perm(hi01, hi23, 0x5410);  // column c, k 16+4t .. 16+4t+3
      fr.a[j][3] = __byte_perm(hi01, hi23, 0x7632);
    }
  }

  template <int BN>
  __device__ void mma(Frag<BN>& fr, State<BN>&, int (&acc)[BN / 2], const Stage& stage) const {
    qgemm::fence_operands(acc);
    qgemm::wgmma_fence();
#pragma unroll
    for (int j = 0; j < STEPS; ++j) qgemm::wgmma_rs_s8<BN>(acc, fr.a[j], x_desc<BN>(stage.x, j), 1);
    qgemm::wgmma_commit();
  }

  template <int BN>
  __device__ void retire(Frag<BN>&, State<BN>&, int (&)[BN / 2], float*) const {}
};

// float8_e4m3fn on ScaledLayout's slices and fragments, summed in f32.
struct E4m3Layout : ScaledLayout {
  using Acc = float;
  // Promotion: each slice's wgmmas sum from zero into State::part, added into
  // acc by retire. False: every slice into acc, the tensor cores' own sum.
  static constexpr bool kPromote = true;

  template <int BN>
  struct State {
    float part[BN / 2];  // the slice's sum
  };

  __device__ E4m3Layout(const Params& params, float* extra) : ScaledLayout(params, extra) {}

  template <int BN>
  __device__ void mma(Frag<BN>& fr, State<BN>& st, float (&acc)[BN / 2], const Stage& stage) const {
    float(&d)[BN / 2] = *(kPromote ? &st.part : &acc);
    qgemm::fence_operands(d);
    qgemm::wgmma_fence();
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      qgemm::wgmma_rs_e4m3<BN>(d, fr.a[j], x_desc<BN>(stage.x, j), kPromote && j == 0 ? 0 : 1);
    }
    qgemm::wgmma_commit();
  }

  template <int BN>
  __device__ void retire(Frag<BN>&, State<BN>& st, float (&acc)[BN / 2], float*) const {
    if constexpr (kPromote) {
      qgemm::fence_operands(st.part);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += st.part[i];
    }
  }
};

template <typename O>
__device__ __forceinline__ O cast_out(float v);
template <>
__device__ __forceinline__ float cast_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 cast_out<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

template <typename O>
__global__ void scaled_gemm_fp8_kernel(const __nv_fp8_e4m3* __restrict__ a, const __nv_fp8_e4m3* __restrict__ b,
                                       const float* __restrict__ sa, int sa_scalar, const float* __restrict__ sb,
                                       int sb_scalar, O* __restrict__ out, int m, int n, int k, int64_t lda) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  if (col >= n) return;
  float acc = 0.0f;
  for (int kk = 0; kk < k; ++kk) {
    acc += static_cast<float>(a[row * lda + kk]) * static_cast<float>(b[static_cast<int64_t>(kk) * n + col]);
  }
  const float ra = sa_scalar ? sa[0] : sa[row];
  const float cb = sb_scalar ? sb[0] : sb[col];
  out[static_cast<int64_t>(row) * n + col] = cast_out<O>(__fmul_rn(__fmul_rn(acc, ra), cb));
}

template <typename O>
cudaError_t launch_fp8(const void* a, const void* b, const void* sa, int sa_scalar, const void* sb, int sb_scalar,
                       void* out, int m, int n, int k, int64_t lda, cudaStream_t stream) {
  const dim3 grid((n + 127) / 128, m);
  scaled_gemm_fp8_kernel<O><<<grid, 128, 0, stream>>>(
      static_cast<const __nv_fp8_e4m3*>(a), static_cast<const __nv_fp8_e4m3*>(b), static_cast<const float*>(sa),
      sa_scalar, static_cast<const float*>(sb), sb_scalar, static_cast<O*>(out), m, n, k, lda);
  return cudaGetLastError();
}

// Checks the plan against layout L (ScaledLayout or E4m3Layout), encodes
// a's and b's tensor maps and launches.
template <class L>
cudaError_t run(Params& p, const void* a, int64_t lda, const void* b, int bn, int ks, cudaStream_t stream) {
  if (!qgemm::plan_ok<L>(p, bn, ks)) return cudaErrorInvalidValue;
  // a: (M, K) bytes with row stride lda, in boxes of 128 k x bn rows; b: (K, N) bytes, boxes of 128 x 128.
  // Both maps end at K, so the last slice reads zeros past it.
  const cuuint64_t k_end = static_cast<cuuint64_t>(p.k);
  const cuuint64_t adims[2] = {k_end, static_cast<cuuint64_t>(p.m)};
  const cuuint64_t astride[1] = {static_cast<cuuint64_t>(lda)};
  const cuuint32_t abox[2] = {L::KS, static_cast<cuuint32_t>(bn)};
  const cuuint64_t bdims[2] = {static_cast<cuuint64_t>(p.n), k_end};
  const cuuint64_t bstride[1] = {static_cast<cuuint64_t>(p.n)};
  const cuuint32_t bbox[2] = {qgemm::kCols, L::KS};
  if (!qgemm::encode(&p.tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, a, adims, astride, abox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !qgemm::encode(&p.tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, b, bdims, bstride, bbox, CU_TENSOR_MAP_SWIZZLE_128B)) {
    return cudaErrorInvalidValue;
  }
  return qgemm::launch_bn<L>(p, bn, stream);
}

}  // namespace
}  // namespace conch

// a (M, K) with row stride lda, b (K, N) contiguous, both int8 (fp8 0) or
// both float8_e4m3fn (fp8 1); sa (M) or one value (sa_scalar 1), sb (N) or
// one value, f32; out (M, N) contiguous, f32 (out_dtype 0) or bf16 (1).
// The plan (quant_gemm_plan, layout "scaled" for int8, "e4m3" for
// float8_e4m3fn): bn (32, 64 or 128 rows a block), ks (128), slices
// (cdiv(K, 128)), unit (1) and splits; ws, with splits > 1, (splits, M, N)
// int32 (int8) or f32 (e4m3). int8 needs K a multiple of 32, N of 32; e4m3
// K >= 1 and N a multiple of 16; both lda a multiple of 16 and a and b
// 16-byte aligned (TMA). float8_e4m3fn with bn 0 runs the loop kernel,
// which takes any shape and ignores the rest of the plan.
extern "C" int conch_scaled_gemm(const void* a, const void* b, const void* sa, int sa_scalar, const void* sb,
                                 int sb_scalar, void* out, int out_dtype, int m, int n, int k, int64_t lda, int fp8,
                                 int bn, int ks, int slices, int unit, int splits, void* ws, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  if (out_dtype != conch::kFloat32 && out_dtype != conch::kBFloat16) return static_cast<int>(cudaErrorInvalidValue);
  const bool bf16 = out_dtype == conch::kBFloat16;
  if (fp8 && bn == 0) {
    return static_cast<int>(bf16 ? conch::launch_fp8<__nv_bfloat16>(a, b, sa, sa_scalar, sb, sb_scalar, out, m, n, k, lda, s)
                                 : conch::launch_fp8<float>(a, b, sa, sa_scalar, sb, sb_scalar, out, m, n, k, lda, s));
  }
  const bool shape_ok = fp8 ? k >= 1 && n % 16 == 0 : k % 32 == 0 && n % 32 == 0;
  if (!shape_ok || lda % 16 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  conch::qgemm::Params p{};
  p.sa = static_cast<const float*>(sa);
  p.sb = static_cast<const float*>(sb);
  p.sa_scalar = sa_scalar;
  p.sb_scalar = sb_scalar;
  p.out = out;
  p.ws = static_cast<float*>(ws);
  p.m = m, p.n = n, p.k = k;
  p.group = conch::ScaledLayout::KS;  // no groups: a split unit is one slice
  p.num_groups = (k + p.group - 1) / p.group;
  p.out_f32 = !bf16;
  p.slices = slices;
  p.unit = unit;
  p.splits = splits;
  return static_cast<int>(fp8 ? conch::run<conch::E4m3Layout>(p, a, lda, b, bn, ks, s)
                               : conch::run<conch::ScaledLayout>(p, a, lda, b, bn, ks, s));
}
