// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Weight-only GEMM over GPTQ rows, with an optional 16-entry codebook,
// stacked per layer (K1c).
//
// Replaces conch_tpu/kernels/quantization/gemm.py:_mixed_gemm_kernel
// (launcher mixed_precision_gemm_launcher, layout "gptq", with
// layer_index). out[M, N] = x[M, K] @ W, with 2-, 4- or 8-bit codes c and,
// as in the TPU kernel, the weight dequantized BEFORE the product:
// W[k, n] = bf16(fmul_rn(T[c] [- z], s)), with T[c] = book[c] (NF4, FP4)
// or c - bias, s (absmax for NF4) and the optional zero-point z of group
// k / group; the products are summed in f32 and rounded once.
//
// Layout (conch_tpu_torch/utils/quant_utils.py:pack_rows): word r holds
// logical rows r * epp + i in bit field i (epp = 32 / bits).
//
// Bound on the H100: bytes at decode (M <= 32: K*N*bits/8 bytes of codes
// plus the scales; 8.4 MB of NF4 codes and 1 MB of f32 absmax for
// 4096 x 4096, 2.8 us), operations at a 512-row prefill chunk. The design
// is the shared mainloop of quant_gemm_mainloop.cuh: a slice is 64 k (one
// 128-byte swizzle row of x, 64 / epp word rows), staged 3 slices ahead,
// split over K on group boundaries for narrow shapes. Each thread decodes
// the two columns and 8 k of its wgmma A fragment per k16 step: in the
// natural k order, k slots 2t, 2t+1 (and 2t+8, 2t+9) are two neighbouring
// fields of one word, so a thread shifts its word once and takes two
// fields; the value comes from a 16-entry f32 table in shared memory (the
// codebook, or c - bias; 16 distinct banks, so no conflicts) or, for
// 8-bit codes, from one FADD on the float 2^23 + c; then fsub z, __fmul_rn
// by s, and one cvt.rn.bf16x2.f32 for the pair: bit for bit the old
// per-element f32 dequantization and round to nearest even. A thread's two
// columns are neighbours, so one 8-byte load brings both words. Groups that
// are a multiple of 64 give one scale row a slice (a template flag);
// smaller or odd groups stage up to 17 rows and a table of each 4-k run's
// row.

#include "quant_gemm_mainloop.cuh"

namespace conch {
namespace {

using qgemm::kCols;
using qgemm::Params;
using qgemm::Stage;

template <int BITS, bool ONE_GROUP>
struct RowsLayout {
  using Acc = float;  // wgmma sums bf16 x in f32
  static constexpr int XB = 2;  // bytes of an x value
  static constexpr int EPP = 32 / BITS;
  static constexpr int KS = qgemm::kKSlice;     // k of a slice
  static constexpr int STEPS = KS / 16;         // wgmma k16 steps a slice
  static constexpr int WR = KS / EPP;           // word rows of a slice
  static constexpr int SR = ONE_GROUP ? 1 : 17; // scale rows a slice touches (group >= 4)
  static constexpr bool kGroupTable = !ONE_GROUP;
  static constexpr uint32_t MASK = (1u << BITS) - 1u;

  template <int BN>
  struct Frag {
    uint32_t a[STEPS][4];
  };
  template <int BN>
  struct State {};

  const Params& p;
  float* book;  // shared: T[c] for 2- and 4-bit codes (a static shared table made the multi-wave shapes slower)
  float z1;     // the one zero-point (zp_mode 1)

  __device__ RowsLayout(const Params& params, float* extra)
      : p(params), book(extra), z1(params.zp_mode == 1 ? __ldg(params.zp) : 0.0f) {
    if (BITS <= 4 && threadIdx.x < 16) {
      book[threadIdx.x] = p.codebook != nullptr ? p.codebook[threadIdx.x] : static_cast<float>(threadIdx.x) - p.bias;
    }
  }

  __device__ int word_row(int s) const { return s * WR; }
  __device__ int scale_row(int s) const { return s * KS / p.group; }
  template <int BN>
  __device__ void load_x(uint32_t dst, uint32_t bar, int s, int m0) const {
    qgemm::tma_2d(dst, p.tm_x, bar, s * KS, m0);
  }

  __device__ float value(uint32_t c) const {
    if constexpr (BITS == 8) {
      return qgemm::code_minus(c, p.bias);
    } else {
      return book[c];
    }
  }

  // bf16x2 of the dequantized fields 0 and 1 of `word` (s, z their group's
  // scale and zero-point).
  __device__ uint32_t pair(uint32_t word, float s, float z) const {
    float v0 = value(word & MASK);
    float v1 = value((word >> BITS) & MASK);
    if (p.zp_mode != 0) {
      v0 = v0 - z;
      v1 = v1 - z;
    }
    return pack_bf16x2(__fmul_rn(v0, s), __fmul_rn(v1, s));
  }

  __device__ float zero_point(const Stage& st, int r, int c) const {
    return p.zp_mode == 2 ? st.z[r * kCols + c] : z1;
  }

  // The thread's A fragments of the slice: columns c, c + 1 (wgmma rows g,
  // g + 8) at k slots 2t, 2t+1 (registers 0, 1) and 2t+8, 2t+9 (2, 3) of
  // each k16 step, in the natural k order of the staged x.
  template <int BN>
  __device__ void decode(Frag<BN>& f, State<BN>&, const Stage& st, int, float*) const {
    const int t = threadIdx.x & 3;
    const int c = qgemm::pair_column();
    float s_one[2] = {0.0f, 0.0f};
    float z_one[2] = {0.0f, 0.0f};
    if constexpr (ONE_GROUP) {
#pragma unroll
      for (int ci = 0; ci < 2; ++ci) {
        s_one[ci] = qgemm::scale_at(p, st.s, 0, c + ci);
        z_one[ci] = zero_point(st, 0, c + ci);
      }
    }
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = 16 * j + 2 * t + 8 * h;
        const int shift = BITS * (kk % EPP);
        const uint2 w = *reinterpret_cast<const uint2*>(st.w + (kk / EPP) * kCols + c);
#pragma unroll
        for (int ci = 0; ci < 2; ++ci) {
          float s = s_one[ci];
          float z = z_one[ci];
          if constexpr (!ONE_GROUP) {
            const int r = st.tab[kk >> 2];
            s = qgemm::scale_at(p, st.s, r, c + ci);
            z = zero_point(st, r, c + ci);
          }
          f.a[j][2 * h + ci] = pair((ci == 0 ? w.x : w.y) >> shift, s, z);
        }
      }
    }
  }

  template <int BN>
  __device__ void mma(Frag<BN>& f, State<BN>&, float (&acc)[BN / 2], const Stage& st) const {
    qgemm::fence_operands(acc);
    qgemm::wgmma_fence();
#pragma unroll
    for (int j = 0; j < STEPS; ++j) qgemm::wgmma_rs<BN>(acc, f.a[j], qgemm::desc_sw128(st.x + 32 * j), 1);
    qgemm::wgmma_commit();
  }

  template <int BN>
  __device__ void retire(Frag<BN>&, State<BN>&, float (&)[BN / 2], float*) const {}
};

// Checks the plan against RowsLayout<BITS, ONE_GROUP>, encodes the tensor
// maps and launches.
template <int BITS, bool ONE_GROUP>
cudaError_t run(Params& p, const void* x, int64_t ldx, const void* packed, const void* scales, int bn, int ks,
                cudaStream_t stream) {
  using L = RowsLayout<BITS, ONE_GROUP>;
  if (!qgemm::plan_ok<L>(p, bn, ks)) return cudaErrorInvalidValue;
  // x: (M, K) with row stride ldx, read in boxes of 64 k x bn rows.
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(p.k), static_cast<cuuint64_t>(p.m)};
  const cuuint64_t xstride[1] = {static_cast<cuuint64_t>(ldx) * 2};
  const cuuint32_t xbox[2] = {L::KS, static_cast<cuuint32_t>(bn)};
  if (!qgemm::encode(&p.tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xdims, xstride, xbox,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !qgemm::encode_weights<L>(p, packed, scales)) {
    return cudaErrorInvalidValue;
  }
  return qgemm::launch_bn<L>(p, bn, stream);
}

// Groups that are a multiple of a slice's 64 k take the one-scale-row template.
template <int BITS>
cudaError_t dispatch(Params& p, const void* x, int64_t ldx, const void* packed, const void* scales, int bn, int ks,
                     cudaStream_t stream) {
  return p.group % qgemm::kKSlice == 0 ? run<BITS, true>(p, x, ldx, packed, scales, bn, ks, stream)
                                       : run<BITS, false>(p, x, ldx, packed, scales, bn, ks, stream);
}

}  // namespace
}  // namespace conch

// x (M, K) bf16 with row stride ldx (a multiple of 8, 16-byte aligned: TMA);
// packed (K / (32 / bits), N) int32, scales (ceil(K / group), N) bf16
// (scale_dtype 1) or f32 (0), per-group zero-points of the same shape in
// f32 (zp_mode 2), one f32 zero-point (1) or none (0), and codebook (16
// f32 on the device, 4-bit codes only) or null, of ONE layer (the wrapper
// offsets the stack's pointers); out (M, N) bf16 (out_dtype 1) or f32 (0),
// contiguous. N must be a multiple of 32 and group of 4. The plan
// (quant_gemm_plan): bn (32, 64 or 128 rows a block), ks (64 k a slice),
// slices (ceil(K / 64)), unit (slices a split unit, ending on a group
// boundary: lcm(group, 64) / 64) and splits (1 .. the units); ws, with
// splits > 1, (splits, M, N) f32.
extern "C" int conch_mixed_gemm_rows(const void* x, const void* packed, const void* scales, int scale_dtype,
                                     const void* zp, int zp_mode, const void* codebook, void* out, int out_dtype,
                                     int m, int n, int k, int64_t ldx, int bits, int group, int bias, int bn, int ks,
                                     int slices, int unit, int splits, void* ws, void* stream) {
  if (m == 0) return static_cast<int>(cudaSuccess);
  if ((bits != 2 && bits != 4 && bits != 8) || n % 32 != 0 || ldx % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || group <= 0 || group % 4 != 0 ||
      k % (32 / bits) != 0 || (codebook != nullptr && bits != 4) || (out_dtype != conch::kFloat32 &&
      out_dtype != conch::kBFloat16) || zp_mode < 0 || zp_mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  conch::qgemm::Params p{};
  p.zp = static_cast<const float*>(zp);
  p.codebook = static_cast<const float*>(codebook);
  p.out = out;
  p.ws = static_cast<float*>(ws);
  p.m = m, p.n = n, p.k = k;
  p.group = group;
  p.num_groups = (k + group - 1) / group;
  p.bias = static_cast<float>(bias);
  p.zp_mode = zp_mode;
  p.f32_scales = scale_dtype == conch::kFloat32;
  p.out_f32 = out_dtype == conch::kFloat32;
  p.slices = slices;
  p.unit = unit;
  p.splits = splits;
  auto s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return static_cast<int>(conch::dispatch<2>(p, x, ldx, packed, scales, bn, ks, s));
    case 4: return static_cast<int>(conch::dispatch<4>(p, x, ldx, packed, scales, bn, ks, s));
    default: return static_cast<int>(conch::dispatch<8>(p, x, ldx, packed, scales, bn, ks, s));
  }
}
