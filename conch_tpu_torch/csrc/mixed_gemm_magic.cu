// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// int4 weight-only GEMM over the "magic" packing, stacked per layer (K1).
//
// Replaces conch_tpu/kernels/quantization/gemm.py:_mixed_gemm_magic_kernel
// (launcher mixed_precision_gemm_launcher, with layer_index).
// out[M, N] = x[M, K] @ W, W[k, n] = (code[k, n] - bias) * scale[k / G, n],
// x bf16, the sum in f32, for a group size G of 32, 64 or 128 (a template
// parameter; quant_gemm_plan refuses any other group and names it).
//
// Layout (conch_tpu_torch/utils/quant_utils.py:pack_rows_magic): in group
// g, word row r (0..G/8-1) and column n, bits 4j + 16h hold logical row
// g*G + j*G/4 + 2r + h. So word rows r0 .. r0+7 of one field j hold 16
// contiguous k, and a thread's A pairs of wgmma's k16 step, k slots (2t,
// 2t+1) and (2t+8, 2t+9), are field j of word rows r0 + t and r0 + 4 + t:
// one word feeds four k16 steps, one a field, and the x values of step j
// of a group are x[16j .. 16j+15] of the group, in plain order. Field j of
// a word, masked to the low nibble of each 16-bit half and OR'd with
// 0x4300 (one LOP3), is the bf16 pair (128 + c, 128 + c'); one HSUB2 of
// 128 + bias gives the exact values c - bias (-8..7 for uint4b8). At G 32
// a field of the group's 4 word rows holds 8 contiguous k (rows 8j + 2r +
// h), so k slots (2t, 2t+1) of a k16 step are field 2i of word row t and
// slots (2t+8, 2t+9) field 2i + 1 of the same word: one word feeds two k16
// steps, and step j of a group again takes x[16j .. 16j+15]. (The TPU
// kernel instead computes x@(128+c) - 136*sum(x), which loses digits to
// cancellation; that form is not copied here.)
//
// Bound on the H100: bytes at decode (M <= 32: K*N/2 bytes of codes plus
// the scales, 8.4 MB for 4096 x 4096, 2.5 us), operations at a 512-row
// prefill chunk. The design is the shared mainloop of
// quant_gemm_mainloop.cuh (swap AB: the decoded weight is wgmma's register
// A, x its shared B; TMA stages on mbarriers; deterministic split-K with a
// programmatic-dependent reduction): a slice is one group, G/8 word rows of
// the block's 128 columns and G x values a row (one 128-byte swizzled box,
// two at G 128); at G 32 a slice is two groups, 8 word rows and two scale
// rows, so that its x box, barrier and k16 steps are G 64's (a slice of
// four groups would leave DeepSeek-V2-Lite's K 2048 too few splits to fill
// the card at its narrow N: quant_gemm_plan). A
// thread loads its words once a slice (word rows 8b + t and 8b + 4 + t of
// each 8-row block b; at G 32 word row 4q + t of each group q; its two
// neighbouring columns: 8-byte loads) and decodes each into four (G 32:
// two) fragments. A slice past K (K an odd multiple of 32) reads zeros
// from TMA's fill: zero x, zero scales. The group's scale
// goes before the product: one HMUL2 a decoded pair, so the weight enters
// the tensor cores as bf16((c - bias) * s), rounded once, and one chain of
// wgmmas runs over the whole of K with no per-group fold. (Scaling each
// group's exact f32 sums after the product, as K1b does, was timed on the
// card and was never faster: PERF.md.)

#include "quant_gemm_mainloop.cuh"

namespace conch {
namespace {

using qgemm::kCols;
using qgemm::Params;
using qgemm::Stage;

template <int G>
struct MagicLayout {
  static_assert(G == 32 || G == 64 || G == 128, "a magic slice is one group of 64 or 128, or two of 32");
  using Acc = float;  // wgmma sums bf16 x in f32
  static constexpr int XB = 2;  // bytes of an x value
  static constexpr int EPP = 8;
  static constexpr int KS = G < 64 ? 64 : G;   // k of a slice: one group (G 32: two)
  static constexpr int SR = KS / G;            // groups (scale rows) of a slice
  static constexpr int WR = KS / 8;            // word rows of a slice
  static constexpr int NB = WR / 8;            // 8-word-row blocks: k16 steps of one field (G >= 64)
  static constexpr int STEPS = KS / 16;  // k16 step j: x values 16j .. 16j+15 (G >= 64: field j / NB, block j % NB)
  static constexpr bool kGroupTable = false;

  template <int BN>
  struct Frag {
    uint32_t a[STEPS][4];
  };
  template <int BN>
  struct State {};

  const Params& p;
  __nv_bfloat162 offset;  // 128 + bias, twice

  __device__ MagicLayout(const Params& params, float*)
      : p(params), offset(__bfloat162bfloat162(__float2bfloat16_rn(128.0f + params.bias))) {}

  __device__ int word_row(int s) const { return WR * s; }
  __device__ int scale_row(int s) const { return SR * s; }
  template <int BN>
  __device__ void load_x(uint32_t dst, uint32_t bar, int s, int m0) const {
    qgemm::tma_2d(dst, p.tm_x, bar, KS * s, m0);
    if constexpr (KS == 128) qgemm::tma_2d(dst + BN * 128, p.tm_x, bar, KS * s + 64, m0);
  }
  template <int BN>
  __device__ static uint64_t x_desc(uint32_t x, int j) {
    return qgemm::desc_sw128(x + (j >> 2) * (BN * 128) + 32 * (j & 3));
  }

  // Field f of `word` as the bf16 pair ((c_lo - bias) * s, (c_hi - bias) * s)
  // for the scale pair `s2`.
  __device__ uint32_t pair(uint32_t word, int f, __nv_bfloat162 s2) const {
    uint32_t magic = ((word >> (4 * f)) & 0x000F000Fu) | 0x43004300u;  // bf16 pair 128 + code
    __nv_bfloat162 v = __hmul2(__hsub2(*reinterpret_cast<__nv_bfloat162*>(&magic), offset), s2);
    return *reinterpret_cast<uint32_t*>(&v);
  }

  template <int BN>
  __device__ void decode(Frag<BN>& fr, State<BN>&, const Stage& st, int, float*) const {
    const int t = threadIdx.x & 3;
    const int c = qgemm::pair_column();
    const __nv_bfloat16* s = reinterpret_cast<const __nv_bfloat16*>(st.s);
    if constexpr (G == 32) {
      // Group q of the slice: word row 4q + t, scale row q; its k16 steps
      // 2q and 2q + 1 take fields (0, 1) and (2, 3).
      uint2 w[SR];
      __nv_bfloat162 s2[SR][2];
#pragma unroll
      for (int q = 0; q < SR; ++q) {
        w[q] = *reinterpret_cast<const uint2*>(st.w + (4 * q + t) * kCols + c);
        s2[q][0] = __bfloat162bfloat162(s[q * kCols + c]);
        s2[q][1] = __bfloat162bfloat162(s[q * kCols + c + 1]);
      }
#pragma unroll
      for (int j = 0; j < STEPS; ++j) {
        const int q = j / 2;
        const int f = 2 * (j & 1);
        fr.a[j][0] = pair(w[q].x, f, s2[q][0]);      // column c, k 2t, 2t+1
        fr.a[j][1] = pair(w[q].y, f, s2[q][1]);      // column c + 1
        fr.a[j][2] = pair(w[q].x, f + 1, s2[q][0]);  // column c, k 2t+8, 2t+9
        fr.a[j][3] = pair(w[q].y, f + 1, s2[q][1]);
      }
    } else {
      uint2 w[NB][2];
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          w[b][q] = *reinterpret_cast<const uint2*>(st.w + (8 * b + t + 4 * q) * kCols + c);
        }
      const __nv_bfloat162 s2[2] = {__bfloat162bfloat162(s[c]), __bfloat162bfloat162(s[c + 1])};
#pragma unroll
      for (int j = 0; j < STEPS; ++j) {
        const int f = j / NB;
        const uint2* v = w[j % NB];
        fr.a[j][0] = pair(v[0].x, f, s2[0]);  // column c, k 2t, 2t+1
        fr.a[j][1] = pair(v[0].y, f, s2[1]);  // column c + 1
        fr.a[j][2] = pair(v[1].x, f, s2[0]);  // column c, k 2t+8, 2t+9
        fr.a[j][3] = pair(v[1].y, f, s2[1]);
      }
    }
  }

  template <int BN>
  __device__ void mma(Frag<BN>& fr, State<BN>&, float (&acc)[BN / 2], const Stage& stage) const {
    qgemm::fence_operands(acc);
    qgemm::wgmma_fence();
#pragma unroll
    for (int j = 0; j < STEPS; ++j) qgemm::wgmma_rs<BN>(acc, fr.a[j], x_desc<BN>(stage.x, j), 1);
    qgemm::wgmma_commit();
  }

  template <int BN>
  __device__ void retire(Frag<BN>&, State<BN>&, float (&)[BN / 2], float*) const {}
};

// Checks the plan against MagicLayout<G>, encodes the tensor maps and
// launches.
template <int G>
cudaError_t run(Params& p, const void* x, int64_t ldx, const void* packed, const void* scales, int bn, int ks,
                cudaStream_t stream) {
  using L = MagicLayout<G>;
  if (!qgemm::plan_ok<L>(p, bn, ks)) return cudaErrorInvalidValue;
  // x: (M, K) with row stride ldx, read in boxes of 64 k x bn rows.
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(p.k), static_cast<cuuint64_t>(p.m)};
  const cuuint64_t xstride[1] = {static_cast<cuuint64_t>(ldx) * 2};
  const cuuint32_t xbox[2] = {64, static_cast<cuuint32_t>(bn)};
  if (!qgemm::encode(&p.tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xdims, xstride, xbox,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !qgemm::encode_weights<L>(p, packed, scales)) {
    return cudaErrorInvalidValue;
  }
  return qgemm::launch_bn<L>(p, bn, stream);
}

}  // namespace
}  // namespace conch

// x (M, K) bf16 with row stride ldx (a multiple of 8, 16-byte aligned:
// TMA); packed (K / 8, N) int32 and scales (K / group, N) bf16 of ONE layer
// (the wrapper offsets the stack's pointers); out (M, N) bf16 (out_dtype 1)
// or f32 (0), contiguous. group 32, 64 or 128, K a multiple of it, N of
// 32. The plan (quant_gemm_plan, layout "magic"): bn (32, 64 or 128 rows a
// block), ks (the group: one group a slice; 64 at group 32), slices (K /
// ks, rounded up), unit (1) and splits (1 .. the slices); ws, with splits
// > 1, (splits, M, N) f32.
extern "C" int conch_mixed_gemm_magic(const void* x, const void* packed, const void* scales, void* out,
                                      int out_dtype, int m, int n, int k, int group, int64_t ldx, int bias,
                                      int bn, int ks, int slices, int unit, int splits, void* ws,
                                      void* stream) {
  if (m == 0) return static_cast<int>(cudaSuccess);
  if ((group != 32 && group != 64 && group != 128) || k % group != 0 || n % 32 != 0 || ldx % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || (out_dtype != conch::kFloat32 && out_dtype != conch::kBFloat16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  conch::qgemm::Params p{};
  p.out = out;
  p.ws = static_cast<float*>(ws);
  p.m = m, p.n = n, p.k = k;
  p.group = group;
  p.num_groups = k / group;
  p.bias = static_cast<float>(bias);
  p.f32_scales = 0;
  p.out_f32 = out_dtype == conch::kFloat32;
  p.slices = slices;
  p.unit = unit;
  p.splits = splits;
  auto s = static_cast<cudaStream_t>(stream);
  using conch::run;
  switch (group) {
    case 128: return static_cast<int>(run<128>(p, x, ldx, packed, scales, bn, ks, s));
    case 64: return static_cast<int>(run<64>(p, x, ldx, packed, scales, bn, ks, s));
    default: return static_cast<int>(run<32>(p, x, ldx, packed, scales, bn, ks, s));
  }
}
