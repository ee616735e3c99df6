// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// int4 weight-only GEMM over the "magic" packing, stacked per layer (K1).
//
// Replaces conch_tpu/kernels/quantization/gemm.py:_mixed_gemm_magic_kernel
// (launcher mixed_precision_gemm_launcher, with layer_index).
// out[M, N] = x[M, K] @ W, W[k, n] = (code[k, n] - bias) * scale[k / G, n],
// x bf16 or f16 (T, a template parameter), the sum in f32, for a group
// size G of 32, 64 or 128 (a template parameter; quant_gemm_plan refuses
// any other group and names it).
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
// 128 + bias gives the exact values c - bias (-8..7 for uint4b8). Under f16
// x the same packing is OR'd with 0x6400, the f16 pair (1024 + c, 1024 +
// c'), less 1024 + bias: as exact. At G 32
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
// the tensor cores as T((c - bias) * s), rounded once, and one chain of
// wgmmas runs over the whole of K with no per-group fold. (Scaling each
// group's exact f32 sums after the product, as K1b does, was timed on the
// card and was never faster: PERF.md.) In f16 a bf16 scale converts
// exactly, and its product with c - bias (8 + 3 significant bits) is exact
// too, unless it falls below f16's normal range (6.1e-5): then it rounds
// to a subnormal, as an f16 or f32 scale's product rounds to 11 bits. The
// option sweep's groups of scales near 1e-5 hold that error (about 4e-4 x
// max |ref| in a host model of the rounding) against the 1e-2 tolerance.

#include "quant_gemm_mainloop.cuh"

namespace conch {
namespace {

using qgemm::kCols;
using qgemm::Params;
using qgemm::Stage;

// The x type's pair type and the magic base: a power of two whose unit in
// the last place is 1 in T (128 in bf16, 1024 in f16), so a 4-bit code OR'd
// into the low bits of its pair (kBits) reads as base + code, exactly.
template <typename T>
struct Magic;
template <>
struct Magic<__nv_bfloat16> {
  using T2 = __nv_bfloat162;
  static constexpr uint32_t kBits = 0x43004300u;
  static constexpr float kBase = 128.0f;
};
template <>
struct Magic<__half> {
  using T2 = __half2;
  static constexpr uint32_t kBits = 0x64006400u;
  static constexpr float kBase = 1024.0f;
};

template <int G, typename T>
struct MagicLayout {
  static_assert(G == 32 || G == 64 || G == 128, "a magic slice is one group of 64 or 128, or two of 32");
  using Acc = float;  // wgmma sums x (bf16 or f16, T) in f32
  using T2 = typename Magic<T>::T2;
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
  T2 offset;  // the magic base + bias, twice (exact in T)

  __device__ MagicLayout(const Params& params, float*) : p(params), offset(pair_of(Magic<T>::kBase + params.bias)) {}

  __device__ static T2 pair_of(float v) {
    if constexpr (std::is_same_v<T, __half>) return __float2half2_rn(v);
    else return __bfloat162bfloat162(__float2bfloat16_rn(v));
  }

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

  // Field f of `word` as the T pair ((c_lo - bias) * s, (c_hi - bias) * s)
  // for the scale pair `s2`.
  __device__ uint32_t pair(uint32_t word, int f, T2 s2) const {
    uint32_t magic = ((word >> (4 * f)) & 0x000F000Fu) | Magic<T>::kBits;  // T pair base + code
    T2 v = __hmul2(__hsub2(*reinterpret_cast<T2*>(&magic), offset), s2);
    return *reinterpret_cast<uint32_t*>(&v);
  }

  // Scale row r of the stage at tile column c, twice, in T. bf16 x takes
  // bf16 scales as they are; f16 x takes f16 scales as they are and bf16
  // or f32 ones rounded to f16 (exact for bf16 ones in f16's normal range).
  __device__ T2 scale2(const uint8_t* rows, int r, int c) const {
    const int i = r * kCols + c;
    if constexpr (std::is_same_v<T, __half>) {
      if (p.f16_scales) return __half2half2(reinterpret_cast<const __half*>(rows)[i]);
      if (p.f32_scales) return __float2half2_rn(reinterpret_cast<const float*>(rows)[i]);
      return __float2half2_rn(__bfloat162float(reinterpret_cast<const __nv_bfloat16*>(rows)[i]));
    } else {
      return __bfloat162bfloat162(reinterpret_cast<const __nv_bfloat16*>(rows)[i]);
    }
  }

  template <int BN>
  __device__ void decode(Frag<BN>& fr, State<BN>&, const Stage& st, int, float*) const {
    const int t = threadIdx.x & 3;
    const int c = qgemm::pair_column();
    if constexpr (G == 32) {
      // Group q of the slice: word row 4q + t, scale row q; its k16 steps
      // 2q and 2q + 1 take fields (0, 1) and (2, 3).
      uint2 w[SR];
      T2 s2[SR][2];
#pragma unroll
      for (int q = 0; q < SR; ++q) {
        w[q] = *reinterpret_cast<const uint2*>(st.w + (4 * q + t) * kCols + c);
        s2[q][0] = scale2(st.s, q, c);
        s2[q][1] = scale2(st.s, q, c + 1);
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
      const T2 s2[2] = {scale2(st.s, 0, c), scale2(st.s, 0, c + 1)};
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
    for (int j = 0; j < STEPS; ++j) qgemm::wgmma_rs<BN, T>(acc, fr.a[j], x_desc<BN>(stage.x, j), 1);
    qgemm::wgmma_commit();
  }

  template <int BN>
  __device__ void retire(Frag<BN>&, State<BN>&, float (&)[BN / 2], float*) const {}
};

// Checks the plan against MagicLayout<G, T>, encodes the tensor maps and
// launches.
template <int G, typename T>
cudaError_t run(Params& p, const void* x, int64_t ldx, const void* packed, const void* scales, int bn, int ks,
                cudaStream_t stream) {
  using L = MagicLayout<G, T>;
  if (!qgemm::plan_ok<L>(p, bn, ks)) return cudaErrorInvalidValue;
  // x: (M, K) with row stride ldx, read in boxes of 64 k x bn rows.
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(p.k), static_cast<cuuint64_t>(p.m)};
  const cuuint64_t xstride[1] = {static_cast<cuuint64_t>(ldx) * 2};
  const cuuint32_t xbox[2] = {64, static_cast<cuuint32_t>(bn)};
  const auto xtype = std::is_same_v<T, __half> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!qgemm::encode(&p.tm_x, xtype, 2, x, xdims, xstride, xbox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !qgemm::encode_weights<L>(p, packed, scales)) {
    return cudaErrorInvalidValue;
  }
  return qgemm::launch_bn<L>(p, bn, stream);
}

}  // namespace
}  // namespace conch

// x (M, K) bf16 or f16 (x_dtype) with row stride ldx (a multiple of 8,
// 16-byte aligned: TMA); packed (K / 8, N) int32 and scales (K / group, N)
// of ONE layer (the wrapper offsets the stack's pointers): bf16 under bf16
// x; bf16, f16 or f32 (scale_dtype) under f16 x; out (M, N) bf16, f16 or
// f32 (out_dtype), contiguous. group 32, 64 or 128, K a multiple of it, N
// of 32. The plan (quant_gemm_plan, layout "magic"): bn (32, 64 or 128
// rows a block), ks (the group: one group a slice; 64 at group 32), slices
// (K / ks, rounded up), unit (1) and splits (1 .. the slices); ws, with
// splits > 1, (splits, M, N) f32.
extern "C" int conch_mixed_gemm_magic(const void* x, int x_dtype, const void* packed, const void* scales,
                                      int scale_dtype, void* out, int out_dtype, int m, int n, int k, int group,
                                      int64_t ldx, int bias, int bn, int ks, int slices, int unit, int splits,
                                      void* ws, void* stream) {
  using conch::kBFloat16, conch::kFloat16, conch::kFloat32;
  if (m == 0) return static_cast<int>(cudaSuccess);
  const bool f16_x = x_dtype == kFloat16;
  if ((group != 32 && group != 64 && group != 128) || k % group != 0 || n % 32 != 0 || ldx % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || (x_dtype != kBFloat16 && !f16_x) ||
      (scale_dtype != kBFloat16 && !(f16_x && (scale_dtype == kFloat16 || scale_dtype == kFloat32))) ||
      (out_dtype != kFloat32 && out_dtype != kBFloat16 && out_dtype != kFloat16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  conch::qgemm::Params p{};
  p.out = out;
  p.ws = static_cast<float*>(ws);
  p.m = m, p.n = n, p.k = k;
  p.group = group;
  p.num_groups = k / group;
  p.bias = static_cast<float>(bias);
  p.f32_scales = scale_dtype == kFloat32;
  p.f16_scales = scale_dtype == kFloat16;
  p.out_f32 = out_dtype == kFloat32;
  p.out_f16 = out_dtype == kFloat16;
  p.slices = slices;
  p.unit = unit;
  p.splits = splits;
  auto s = static_cast<cudaStream_t>(stream);
  auto with_type = [&](auto tag) {
    using T = typename decltype(tag)::type;
    using conch::run;
    switch (group) {
      case 128: return run<128, T>(p, x, ldx, packed, scales, bn, ks, s);
      case 64: return run<64, T>(p, x, ldx, packed, scales, bn, ks, s);
      default: return run<32, T>(p, x, ldx, packed, scales, bn, ks, s);
    }
  };
  return static_cast<int>(f16_x ? with_type(conch::TypeTag<__half>{}) : with_type(conch::TypeTag<__nv_bfloat16>{}));
}
