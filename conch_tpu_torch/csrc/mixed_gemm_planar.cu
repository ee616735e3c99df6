// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Weight-only GEMM over the planar packing, stacked per layer (K1b).
//
// Replaces conch_tpu/kernels/quantization/gemm.py:_mixed_gemm_planar_kernel
// (launcher mixed_precision_gemm_launcher, layout "planar", with
// layer_index). out[M, N] = x[M, K] @ W with 2-, 4- or 8-bit codes c and
// W[k, n] = (c[k, n] - z) * s[k / group, n], where z is a per-group
// zero-point, one scalar zero-point, or the type's bias. As in the TPU
// kernel the dequantization comes after the product: for each group
// G, acc += (x_G @ c_G - z * sum(x_G)) * s_G in f32. The raw codes are
// exact in bf16 and go straight into the tensor cores.
//
// Layout (conch_tpu_torch/utils/quant_utils.py:pack_rows_planar): in a
// group of `group` rows, word row r holds logical row i * (group / epp) + r
// in bit field i (epp = 32 / bits fields).
//
// Bound on the H100: bytes at decode (M <= 32: K*N*bits/8 bytes of codes
// plus the scales, 16.8 MB for an int8 4096 x 4096, 5.0 us), operations at
// a 512-row prefill chunk. The design is the shared mainloop of
// quant_gemm_mainloop.cuh. For a group of 128 with 4- or 8-bit codes (the
// served int8 format) a slice is the whole group: its 128 x values are
// contiguous, two 128-byte swizzled TMA boxes, and k16 step j is x values
// 16j .. 16j+15. Otherwise a slice is 16 word rows of one group (group %
// (16 * epp) == 0), 16 * epp logical k, whose field f is the 16 x values at
// f * (group / epp) + 16 * sub: k16 step f, staged by one 4-d TMA box as
// wgmma's core matrices without swizzle; or, where a group's word rows are
// an odd multiple of 8 (int8 at group 32, 4-bit at 64, 2-bit at 128: group
// % (8 * epp) == 0), 8 word rows, 8 * epp k, whose fields 2j and 2j + 1
// (8 x values each, at f * (group / epp) + 8 * sub) are k16 step j, by the
// same 4-d box one 8-value block deep. A thread loads its words once a
// slice (word rows 2t, 2t+1, 2t+8, 2t+9 of each 16-row block, or 2t and
// 2t+1 of the 8 rows, for its two neighbouring columns: 8-byte loads) and
// takes the step's field (fields) of each;
// a code becomes bf16 through the float 2^23 + c (one PRMT or
// shift-and-mask, one FADD) and one cvt.rn.bf16x2.f32 a pair, exact. Each
// group's products go to their own accumulators (the group's first wgmma
// overwrites them); once the group's last wgmma has completed the thread
// folds acc += (part - z * sum) * s in f32. The x rows' sums over the
// group come, at 128 rows a block, from group_row_sums_kernel (once for all
// the N / 128 column blocks); else each block takes them from its staged
// x while it decodes the slice. A split takes whole groups. 2- and 4-bit
// codes take at most 64 rows a block (their 8 and 16 k16 steps'
// fragments, twice, beside two sets of accumulators).

#include "quant_gemm_mainloop.cuh"

namespace conch {
namespace {

using qgemm::kCols;
using qgemm::kThreads;
using qgemm::Params;
using qgemm::Stage;

// SUB 0 (WHOLE): a slice is a whole group of 128 (4- and 8-bit codes; the
// served int8 format), whose 128 x values are contiguous: two 128-byte
// swizzled boxes, as for GPTQ rows. Otherwise a slice is SUB (16 or 8) word
// rows of one group.
template <int BITS, int SUB>
struct PlanarLayout {
  static_assert(SUB == 0 || SUB == 16 || SUB == 8, "a slice is a whole group of 128, or 16 or 8 word rows of one");
  static constexpr bool WHOLE = SUB == 0;
  using Acc = float;  // wgmma sums bf16 x in f32
  static constexpr int XB = 2;  // bytes of an x value
  static constexpr int EPP = 32 / BITS;
  static constexpr int WR = WHOLE ? 128 / EPP : SUB;  // word rows of a slice
  static constexpr int KS = WR * EPP;                 // k of a slice
  static constexpr int NB = WR / 16;                  // 16-word-row blocks of a slice (0 at SUB 8)
  static constexpr int STEPS = KS / 16;               // k16 step j: bit field j / NB, block j % NB (SUB 8: 2j, 2j + 1)
  static constexpr int SR = 1;                        // a slice lies in one group
  static constexpr bool kGroupTable = false;
  static constexpr uint32_t MASK = (1u << BITS) - 1u;
  static_assert(!WHOLE || BITS >= 4, "a whole group of 128 holds 16-word-row blocks only for 4- and 8-bit codes");

  template <int BN>
  struct Frag {
    uint32_t a[STEPS][4];
    float s[2], z[2];  // the group's scales and zero-points at the thread's columns
    bool first, last;  // the slice opens / closes its group
    const float* xs;   // the x rows' sums over the group (last slice)
  };
  template <int BN>
  struct State {
    float part[BN / 2];  // the current group's x_G @ c_G
    float xs_run = 0.0f; // running sum of one x row over the group (one row a 256 / BN lanes)
  };

  const Params& p;
  int spg;   // slices a group
  float z1;  // the zero-point of zp_mode 1, or the bias (zp_mode 0)

  __device__ PlanarLayout(const Params& params, float*)
      : p(params), spg(params.group / KS), z1(params.zp_mode == 1 ? __ldg(params.zp) : params.bias) {}

  __device__ int word_row(int s) const { return WR * s; }
  __device__ int scale_row(int s) const { return s / spg; }
  // WHOLE: k16 step j is x values 16j .. 16j+15 of the group. Otherwise
  // field f's SUB x values, f * (group / epp) + SUB * sub + 0..SUB-1 of the
  // group, are k-blocks (SUB / 8) f .. (BN x 8 values each): one 4-d box of
  // x seen as (8 values, rows, 8-value blocks, runs of group / epp values)
  // lays the slice out as wgmma's K-major core matrices without swizzle,
  // each k-block BN * 16 bytes after the one before; k16 step j takes
  // k-blocks 2j and 2j + 1 (field j at SUB 16; fields 2j and 2j + 1 at SUB 8).
  template <int BN>
  __device__ void load_x(uint32_t dst, uint32_t bar, int s, int m0) const {
    if constexpr (WHOLE) {
      qgemm::tma_2d(dst, p.tm_x, bar, KS * s, m0);
      qgemm::tma_2d(dst + BN * 128, p.tm_x, bar, KS * s + 64, m0);
    } else {
      qgemm::tma_4d(dst, p.tm_x, bar, 0, m0, (SUB / 8) * (s % spg), (s / spg) * EPP);
    }
  }
  // Byte offset of x row r's 16-byte chunk ch (values 8ch .. 8ch+7 of the slice).
  template <int BN>
  __device__ static int x_chunk(int r, int ch) {
    return WHOLE ? (ch >> 3) * (BN * 128) + r * 128 + (((ch & 7) ^ (r & 7)) << 4) : ch * (BN * 16) + r * 16;
  }
  template <int BN>
  __device__ static uint64_t x_desc(uint32_t x, int j) {
    return WHOLE ? qgemm::desc_sw128(x + (j >> 2) * (BN * 128) + 32 * (j & 3))
                 : qgemm::desc_plain(x + 2 * j * (BN * 16), BN * 16, 128);
  }

  // Row sums of group buffer b (x rows of the block).
  __device__ static float* row_sums(float* extra, int b) { return extra + 16 + b * kCols; }

  __device__ static float code(uint32_t word, int f) {
    if constexpr (BITS == 8) {
      return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440 | f)) - 8388608.0f;
    } else {
      return qgemm::code_minus((word >> (BITS * f)) & MASK, 0.0f);
    }
  }

  template <int BN>
  __device__ void decode(Frag<BN>& fr, State<BN>& st, const Stage& stage, int s, float* extra) const {
    const int sub = s % spg;
    fr.first = sub == 0;
    fr.last = sub == spg - 1;
    if (p.xs_pre) {
      fr.xs = stage.xs;  // staged with the slice, read before the stage is refilled
    } else {
      // This slice's share of each x row's sum over the group.
      constexpr int TPR = kThreads / BN;  // threads a row
      constexpr int CHUNKS = KS / 8;      // 16-byte chunks of a row (fewer than TPR for int8 at SUB 8)
      const int r = threadIdx.x / TPR;
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < (CHUNKS + TPR - 1) / TPR; ++i) {
        if (r >= p.m - static_cast<int>(blockIdx.y) * BN) break;  // rows past M are zero
        const int ch = threadIdx.x % TPR + TPR * i;
        if (CHUNKS % TPR != 0 && ch >= CHUNKS) break;
        const uint4 v = *reinterpret_cast<const uint4*>(stage.xp + x_chunk<BN>(r, ch));
        sum += ((bf16_lo(v.x) + bf16_hi(v.x)) + (bf16_lo(v.y) + bf16_hi(v.y))) +
               ((bf16_lo(v.z) + bf16_hi(v.z)) + (bf16_lo(v.w) + bf16_hi(v.w)));
      }
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (fr.first) st.xs_run = 0.0f;
      st.xs_run += sum;
      fr.xs = row_sums(extra, (s / spg) & 1);
      if (fr.last && threadIdx.x % TPR == 0) row_sums(extra, (s / spg) & 1)[r] = st.xs_run;
    }

    const int t = threadIdx.x & 3;
    const int c = qgemm::pair_column();
#pragma unroll
    for (int ci = 0; ci < 2; ++ci) {
      fr.s[ci] = qgemm::scale_at(p, stage.s, 0, c + ci);
      fr.z[ci] = p.zp_mode == 2 ? stage.z[c + ci] : z1;
    }
    if constexpr (SUB == 8) {
      // Word rows 2t, 2t+1 of the thread's columns c, c + 1: k slots (2t,
      // 2t+1) of step j in field 2j, slots (2t+8, 2t+9) in field 2j + 1.
      uint2 v[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) v[q] = *reinterpret_cast<const uint2*>(stage.w + (2 * t + q) * kCols + c);
#pragma unroll
      for (int j = 0; j < STEPS; ++j) {
        const int f = 2 * j;
        fr.a[j][0] = pack_bf16x2(code(v[0].x, f), code(v[1].x, f));  // column c, k 2t, 2t+1
        fr.a[j][1] = pack_bf16x2(code(v[0].y, f), code(v[1].y, f));  // column c + 1
        fr.a[j][2] = pack_bf16x2(code(v[0].x, f + 1), code(v[1].x, f + 1));  // column c, k 2t+8, 2t+9
        fr.a[j][3] = pack_bf16x2(code(v[0].y, f + 1), code(v[1].y, f + 1));
      }
    } else {
      // Word rows 16b + 2t, +1, +8, +9 of the thread's columns c, c + 1.
      uint2 w[NB][4];
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          w[b][q] = *reinterpret_cast<const uint2*>(stage.w + (16 * b + 2 * t + (q & 1) + 8 * (q >> 1)) * kCols + c);
        }
#pragma unroll
      for (int j = 0; j < STEPS; ++j) {
        const int f = j / NB;
        const uint2* v = w[j % NB];
        fr.a[j][0] = pack_bf16x2(code(v[0].x, f), code(v[1].x, f));  // column c, k 2t, 2t+1
        fr.a[j][1] = pack_bf16x2(code(v[0].y, f), code(v[1].y, f));  // column c + 1
        fr.a[j][2] = pack_bf16x2(code(v[2].x, f), code(v[3].x, f));  // column c, k 2t+8, 2t+9
        fr.a[j][3] = pack_bf16x2(code(v[2].y, f), code(v[3].y, f));
      }
    }
  }

  template <int BN>
  __device__ void mma(Frag<BN>& fr, State<BN>& st, float (&)[BN / 2], const Stage& stage) const {
    qgemm::fence_operands(st.part);
    qgemm::wgmma_fence();
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      qgemm::wgmma_rs<BN>(st.part, fr.a[j], x_desc<BN>(stage.x, j), fr.first && j == 0 ? 0 : 1);
    }
    qgemm::wgmma_commit();
  }

  // After the group's last slice: acc += (part - z * sum) * s, in f32.
  template <int BN>
  __device__ void retire(Frag<BN>& fr, State<BN>& st, float (&acc)[BN / 2], float* extra) const {
    qgemm::fence_operands(st.part);
    if (!fr.last) return;
    const float* xs = fr.xs;
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sum = xs[8 * j + 2 * t + (e & 1)];
        acc[4 * j + e] += (st.part[4 * j + e] - fr.z[e >> 1] * sum) * fr.s[e >> 1];
      }
    }
  }
};

// xs[g][row] = the f32 sum of x[row, g * group .. (g + 1) * group), one
// warp a (row, group), lanes in a fixed order: the zero-point term of K1b,
// summed once for all the column blocks (rows 16-byte aligned, group a
// multiple of 8).
__global__ void __launch_bounds__(256) group_row_sums_kernel(const __nv_bfloat16* __restrict__ x, int64_t ldx, int m,
                                                             int group, int groups, float* __restrict__ xs,
                                                             int ldm) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= m * groups) return;
  const int row = warp % m;
  const int g = warp / m;
  const __nv_bfloat16* src = x + row * ldx + static_cast<int64_t>(g) * group;
  float sum = 0.0f;
  for (int i = 8 * lane; i < group; i += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(src + i);
    sum += ((bf16_lo(v.x) + bf16_hi(v.x)) + (bf16_lo(v.y) + bf16_hi(v.y))) +
           ((bf16_lo(v.z) + bf16_hi(v.z)) + (bf16_lo(v.w) + bf16_hi(v.w)));
  }
  sum = warp_sum(sum);
  if (lane == 0) xs[static_cast<int64_t>(g) * ldm + row] = sum;
}

// Checks the plan against PlanarLayout<BITS, SUB>, encodes the tensor
// maps, runs the row-sum pre-pass when xs is given, and launches.
template <int BITS, int SUB>
cudaError_t run(Params& p, const void* x, int64_t ldx, const void* packed, const void* scales, void* xs, int bn,
                int ks, cudaStream_t stream) {
  using L = PlanarLayout<BITS, SUB>;
  constexpr bool WHOLE = L::WHOLE;
  constexpr int kMaxBn = BITS == 8 ? 128 : 64;  // 2- and 4-bit codes: at most 64 rows a block
  if (!qgemm::plan_ok<L, kMaxBn>(p, bn, ks)) return cudaErrorInvalidValue;
  bool maps;
  if constexpr (WHOLE) {  // x as (M, K): boxes of 64 values x bn rows, two a slice
    const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(p.k), static_cast<cuuint64_t>(p.m)};
    const cuuint64_t xstride[1] = {static_cast<cuuint64_t>(ldx) * 2};
    const cuuint32_t xbox[2] = {64, static_cast<cuuint32_t>(bn)};
    maps = qgemm::encode(&p.tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xdims, xstride, xbox,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  } else {  // x as (8 values, M rows, run / 8 blocks, K / run runs): boxes of 8 x bn x SUB / 8 x epp
    const int run = p.group / L::EPP;  // x values of one bit field in a group
    const cuuint64_t xdims[4] = {8, static_cast<cuuint64_t>(p.m), static_cast<cuuint64_t>(run / 8),
                                 static_cast<cuuint64_t>(p.k / run)};
    const cuuint64_t xstride[3] = {static_cast<cuuint64_t>(ldx) * 2, 16, static_cast<cuuint64_t>(run) * 2};
    const cuuint32_t xbox[4] = {8, static_cast<cuuint32_t>(bn), SUB / 8, L::EPP};
    maps = qgemm::encode(&p.tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, xdims, xstride, xbox,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (!maps || !qgemm::encode_weights<L>(p, packed, scales)) return cudaErrorInvalidValue;
  if (xs != nullptr) {  // the x rows' group sums, once for every column block
    const int ldm = (p.m + 3) / 4 * 4;
    const cuuint64_t sdims[2] = {static_cast<cuuint64_t>(p.m), static_cast<cuuint64_t>(p.num_groups)};
    const cuuint64_t sstride[1] = {static_cast<cuuint64_t>(ldm) * 4};
    const cuuint32_t sbox[2] = {static_cast<cuuint32_t>(bn), 1};
    if (!qgemm::encode(&p.tm_xs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, xs, sdims, sstride, sbox,
                       CU_TENSOR_MAP_SWIZZLE_NONE)) {
      return cudaErrorInvalidValue;
    }
    p.xs_pre = 1;
    const int64_t threads = static_cast<int64_t>(p.m) * p.num_groups * 32;
    group_row_sums_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), ldx, p.m, p.group, p.num_groups, static_cast<float*>(xs), ldm);
  }
  return qgemm::launch_bn<L, kMaxBn>(p, bn, stream);
}

}  // namespace
}  // namespace conch

// x (M, K) bf16 with row stride ldx (a multiple of 8, 16-byte aligned: TMA);
// packed (K / (32 / bits), N) int32, scales (K / group, N) bf16
// (scale_dtype 1) or f32 (0), and per-group zero-points (K / group, N) f32
// (zp_mode 2), one f32 zero-point (1) or none (0: the bias), of ONE layer
// (the wrapper offsets the stack's pointers); out (M, N) bf16 (out_dtype 1)
// or f32 (0), contiguous. N must be a multiple of 32, group a multiple of
// 8 * (32 / bits), and K a multiple of group. The plan (quant_gemm_plan):
// bn (32, 64 or, for 8-bit codes, 128 rows a block), ks (k of a slice: a
// whole group of 128 for 4- and 8-bit codes at group 128, else 16 * (32 /
// bits) where that divides the group, else 8 * (32 / bits)), slices (K /
// ks), unit (slices a split unit: whole groups) and
// splits (1 .. the units); ws, with splits > 1, (splits, M, N) f32; xs, or
// null, (K / group, M rounded up to 4) f32 for the x rows' group sums (then
// computed once by group_row_sums_kernel, not by every column block).
extern "C" int conch_mixed_gemm_planar(const void* x, const void* packed, const void* scales, int scale_dtype,
                                       const void* zp, int zp_mode, void* out, int out_dtype, int m, int n, int k,
                                       int64_t ldx, int bits, int group, int bias, int bn, int ks, int slices,
                                       int unit, int splits, void* ws, void* xs, void* stream) {
  if (m == 0) return static_cast<int>(cudaSuccess);
  if ((bits != 2 && bits != 4 && bits != 8) || n % 32 != 0 || ldx % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || group <= 0 ||
      group % (8 * (32 / bits)) != 0 || k % group != 0 || (out_dtype != conch::kFloat32 &&
      out_dtype != conch::kBFloat16) || zp_mode < 0 || zp_mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  conch::qgemm::Params p{};
  p.zp = static_cast<const float*>(zp);
  p.out = out;
  p.ws = static_cast<float*>(ws);
  p.m = m, p.n = n, p.k = k;
  p.group = group;
  p.num_groups = k / group;
  p.bias = static_cast<float>(bias);
  p.zp_mode = zp_mode;
  p.f32_scales = scale_dtype == conch::kFloat32;
  p.out_f32 = out_dtype == conch::kFloat32;
  p.slices = slices;
  p.unit = unit;
  p.splits = splits;
  auto s = static_cast<cudaStream_t>(stream);
  using conch::run;
  // A slice is the whole group (PlanarLayout's SUB 0) for 4- and 8-bit
  // codes at group 128, else 16 word rows of a group where the group's word
  // rows are a multiple of 16, else 8.
  const bool sub16 = group % (16 * (32 / bits)) == 0;
  switch (bits) {
    case 2:
      return static_cast<int>(sub16 ? run<2, 16>(p, x, ldx, packed, scales, xs, bn, ks, s)
                                    : run<2, 8>(p, x, ldx, packed, scales, xs, bn, ks, s));
    case 4:
      return static_cast<int>(group == 128 ? run<4, 0>(p, x, ldx, packed, scales, xs, bn, ks, s)
                              : sub16      ? run<4, 16>(p, x, ldx, packed, scales, xs, bn, ks, s)
                                           : run<4, 8>(p, x, ldx, packed, scales, xs, bn, ks, s));
    default:
      return static_cast<int>(group == 128 ? run<8, 0>(p, x, ldx, packed, scales, xs, bn, ks, s)
                              : sub16      ? run<8, 16>(p, x, ldx, packed, scales, xs, bn, ks, s)
                                           : run<8, 8>(p, x, ldx, packed, scales, xs, bn, ks, s));
  }
}
