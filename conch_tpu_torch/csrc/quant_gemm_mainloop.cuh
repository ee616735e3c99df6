// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// The pipelined tensor-core mainloop shared by the weight-only GEMMs K1
// (mixed_gemm_magic.cu), K1b (mixed_gemm_planar.cu) and K1c
// (mixed_gemm_rows.cu), and by the scaled GEMM K8 (scaled_gemm.cu).
// Each layout plugs in as a small policy: where a K slice's codes, scales
// and x values lie, and how a thread turns its words into wgmma's A
// fragment. The weight-only GEMMs take bf16 x (K1 also f16 x) and sum in
// f32 (wgmma.m64nBNk16.f32.bf16, .f32.f16); K8 takes int8 x and sums in s32
// (wgmma.m64nBNk32.s32.s8.s8, its int32 split workspace added exactly), or
// float8_e4m3fn x summed a slice at a time in f32
// (wgmma.m64nBNk32.f32.e4m3.e4m3) and promoted into an f32 running sum on
// the CUDA cores (its split workspace f32), then scales each output by its
// row's and column's scales.
//
// out[M, N] = x[M, K] @ W[K, N] is computed transposed ("swap AB"):
// outT = WT . xT, so that the weight's N fills the 64-row side of
// wgmma.m64nBNk16 and the batch rows become its N (BN = 32, 64 or 128).
// A block owns 128 weight columns (two warpgroups of 64) and BN x rows,
// and walks its share of K in slices:
//  - a ring of up to 5 stages in shared memory; each holds one slice's
//    packed words (the block's 128 columns), its scale and zero-point
//    rows, and the slice's x values (BN rows, K-major, in a layout
//    wgmma's B descriptor reads). One thread issues the slice's TMA copies
//    (tensor maps built by the entry point; zero-filled past M, N and K)
//    for slice s + 4 while slice s + 1 is decoded; they complete on the
//    stage's mbarrier. Three slices are in flight and no global load
//    stays in the inner loop (per-thread cp.async, tried first, could not
//    keep enough bytes in flight: the copies' latency set the pace);
//  - a software pipeline over the slices: the warpgroups' wgmmas on slice
//    s (A from registers, B = the staged x) run while the threads decode
//    slice s + 1's A fragments (2 neighbouring columns x 8 k a k16 step)
//    from the staged words into a second set of registers; then the
//    threads wait for slice s's wgmmas and retire it. Each code is decoded
//    once per block: at M <= 32 one block covers every row, at 512 rows
//    its row tile is 128. The 32-row template runs two blocks an SM (at
//    most 128 registers, half the shared memory each), so that one block's
//    waits hide behind the other's decoding;
//  - a deterministic split-K fills the SMs for narrow shapes: split z
//    takes whole units of slices (a unit ends on a group boundary), and
//    writes f32 partial sums to a workspace that a second kernel, launched
//    as a programmatic dependent (its launch overlaps this grid's end),
//    adds in a fixed order and rounds once into the output; with one
//    split the block rounds and stores itself. No atomics: two calls on
//    the same inputs give the same bits, and no host state changes between
//    calls.
// The launch plan (BN, the K slice, slices, unit, splits) comes from the
// Python wrapper (kernels/quantization/gemm.py: quant_gemm_plan, layouts
// "magic", "planar", "gptq", "scaled" and "e4m3"); the entry points refuse a
// plan their template cannot run (plan_ok) and run the rest as it is.
// Tried on the card and dropped (PERF.md): pairs of column blocks sharing x
// by TMA multicast in a cluster, split-K added up through distributed
// shared memory, a value table in static shared memory, and K orders
// rotated per column block; each was slower. K1b's fold between a group's
// last wgmma and the next group's first (tools/k1b_prefill_fold.py times
// it) was not hidden by either of: issuing a 128-row block's wgmmas as two
// commit groups of 64 rows, one half folded while the other runs (ptxas
// then serializes the wgmmas, C7512: accumulators read inside the
// pipeline stage), or warpgroup 1 issuing after the block's barrier.

#pragma once

#include <cuda.h>

#include <type_traits>

#include "gemm_common.cuh"

namespace conch {
namespace qgemm {

constexpr int kThreads = 256;             // two warpgroups
constexpr int kCols = 128;                // weight (output) columns per block, 64 a warpgroup
constexpr int kMaxStages = 5;             // the ring: slices s + 2 .. s + 4 in flight while s + 1 is decoded
constexpr int kSmemLimit = 232448;        // dynamic shared memory a block may use (227 KB)
constexpr int kExtraBytes = 2048;         // value table (16 f32), x row sums (2 x 128 f32), mbarriers
constexpr int kKSlice = 64;               // K of a GPTQ-row slice (one 128-byte swizzle atom of x)

struct Params {
  CUtensorMap tm_x;  // x (bf16, or f16 for K1; K8: int8 or e4m3), in the layout's box and wgmma layout
  CUtensorMap tm_w;  // the layer's words: (K / epp, N) int32, box (128, WR); K8: (K, N) bytes, box (128, 128)
  CUtensorMap tm_s;  // its scales: (groups, N) bf16, f16 or f32, box (128, SR)
  CUtensorMap tm_z;  // its per-group zero-points (zp_mode 2): f32, box (128, SR)
  CUtensorMap tm_xs; // x's row sums per group (xs_pre): (groups, M) f32, box (BN, 1)
  const float* zp;
  const float* codebook;  // 16 f32 (K1c codebooks) or null
  const float* sa;        // K8: row scales (m, or one value when sa_scalar)
  const float* sb;        // K8: column scales (n, or one value when sb_scalar)
  void* out;
  float* ws;  // (splits, m, n) partial sums when splits > 1: f32, or int32 for an s32 layout
  int m, n, k;
  int group, num_groups;
  float bias;
  int zp_mode;     // 0 none, 1 one value, 2 per group
  int f32_scales;  // 1 f32 scales, else 16-bit: bf16, or f16 with f16_scales (K1 only)
  int f16_scales;
  int out_f32;     // 1 f32 output, else 16-bit: bf16, or f16 with out_f16 (K1 only)
  int out_f16;
  int slices;      // K slices in all
  int unit;        // slices per split unit
  int splits;
  int xs_pre;      // the row sums come from group_row_sums_kernel (K1b at 128 rows a block)
  int sa_scalar, sb_scalar;
};

// Slices [s0, s1) of split `split`: whole units, split as evenly as integer
// division allows (quant_gemm_plan's split_slices).
__device__ __forceinline__ void split_range(const Params& p, int split, int& s0, int& s1) {
  const int units = (p.slices + p.unit - 1) / p.unit;
  const int u0 = static_cast<int>(static_cast<int64_t>(split) * units / p.splits);
  const int u1 = static_cast<int>(static_cast<int64_t>(split + 1) * units / p.splits);
  s0 = u0 * p.unit;
  s1 = min(u1 * p.unit, p.slices);
}

// -- PTX -----------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// One arrival that also expects `bytes` of TMA copies.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  }
}
// A box of `map` at coordinates (innermost first) to shared memory; its
// bytes complete on `bar`.
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap& map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap& map, uint32_t bar, int c0, int c1, int c2,
                                       int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_operands(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma's descriptor of a K-major bf16 tile with the 128-byte swizzle:
// rows of 64 values (128 bytes), 8-row groups 1024 bytes apart (SBO); the
// tile's atoms are 1024-byte aligned, so a k16 step inside a row is a
// plain offset of 32 bytes on the start address.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// The same for a K-major tile without swizzle: 8-row x 16-byte core
// matrices of 128 contiguous bytes, `lbo` bytes apart along K and `sbo`
// bytes apart along the rows.
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d[BN/2] += A[64 x 16] . B[16 x BN] with f32 sums over operands of T
// (bf16, or f16 for K1 under f16 x): A from registers (the mma.m16n8k16
// A layout, warp w of the warpgroup holding rows 16w .. 16w+15), B from
// shared memory through `desc`; scale_d 0 overwrites d. wgmma_rs_bf16 and
// wgmma_rs_f16 differ only in the instruction's type.
template <int BN>
__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t desc, int scale_d);
template <int BN>
__device__ __forceinline__ void wgmma_rs_f16(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t desc, int scale_d);

#define CONCH_WGMMA_RS_32(NAME, AB)                                                                                \
  template <>                                                                                                      \
  __device__ __forceinline__ void NAME<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc, int scale_d) {   \
    asm volatile(                                                                                                  \
        "{\n.reg .pred p;\n"                                                                                       \
        "setp.ne.b32 p, %21, 0;\n"                                                                                 \
        "wgmma.mma_async.sync.aligned.m64n32k16.f32." AB "." AB " "                                                \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "                                \
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"                                                              \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),           \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])      \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));                                   \
  }

#define CONCH_WGMMA_RS_64(NAME, AB)                                                                                \
  template <>                                                                                                      \
  __device__ __forceinline__ void NAME<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc, int scale_d) {   \
    asm volatile(                                                                                                  \
        "{\n.reg .pred p;\n"                                                                                       \
        "setp.ne.b32 p, %37, 0;\n"                                                                                 \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " "                                                \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                 \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "                        \
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"                                                              \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),           \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),   \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])    \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));                                   \
  }

#define CONCH_WGMMA_RS_128(NAME, AB)                                                                               \
  template <>                                                                                                      \
  __device__ __forceinline__ void NAME<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc, int scale_d) {  \
    asm volatile(                                                                                                  \
        "{\n.reg .pred p;\n"                                                                                       \
        "setp.ne.b32 p, %69, 0;\n"                                                                                 \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " "                                               \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                 \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                         \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                         \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                        \
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"                                                              \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),           \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),   \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),   \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),   \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),   \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),   \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])    \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));                                   \
  }

CONCH_WGMMA_RS_32(wgmma_rs_bf16, "bf16")
CONCH_WGMMA_RS_64(wgmma_rs_bf16, "bf16")
CONCH_WGMMA_RS_128(wgmma_rs_bf16, "bf16")
CONCH_WGMMA_RS_32(wgmma_rs_f16, "f16")
CONCH_WGMMA_RS_64(wgmma_rs_f16, "f16")
CONCH_WGMMA_RS_128(wgmma_rs_f16, "f16")
#undef CONCH_WGMMA_RS_32
#undef CONCH_WGMMA_RS_64
#undef CONCH_WGMMA_RS_128

template <int BN, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  if constexpr (std::is_same_v<T, __half>) wgmma_rs_f16<BN>(d, a, desc, scale_d);
  else wgmma_rs_bf16<BN>(d, a, desc, scale_d);
}

// d[BN/2] += A[64 x 32] . B[32 x BN] in s32, int8 operands: A from
// registers (warp w of the warpgroup holding rows 16w .. 16w+15; register
// i of a thread: row g + 8 (i & 1), k 4t .. 4t+3 + 16 (i >> 1), the lowest
// k in the lowest byte, as mma.m16n8k32's A), B from shared memory through
// `desc`; scale_d 0 overwrites d.
template <int BN>
__device__ __forceinline__ void wgmma_rs_s8(int (&d)[BN / 2], const uint32_t (&a)[4], uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs_s8<32>(int (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_s8<64>(int (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_s8<128>(int (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d[BN/2] += A[64 x 32] . B[32 x BN] in f32, float8_e4m3fn operands: A from
// registers in wgmma_rs_s8's fragment layout (an e4m3 byte where an s8 byte
// is), B from shared memory through `desc`; scale_d 0 overwrites d. The
// tensor cores keep fewer bits of the sum than f32 (about 14, DeepSeek-V3's
// report), so a caller sums a few k32 steps here and adds them up itself.
template <int BN>
__device__ __forceinline__ void wgmma_rs_e4m3(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t desc,
                                              int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs_e4m3<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.f32.e4m3.e4m3 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_e4m3<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.f32.e4m3.e4m3 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_e4m3<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// A code c < 2^23 as f32, exactly, minus `offset` (exact for the biases and
// code ranges of 2- to 8-bit codes): 2^23 + c is the float with bits
// 0x4B000000 | c, so one FADD replaces I2F.
__device__ __forceinline__ float code_minus(uint32_t c, float offset) {
  return __uint_as_float(0x4B000000u | c) - (8388608.0f + offset);
}

// -- the ring ------------------------------------------------------------------

// One stage: x (BN rows x KS values of XB bytes, K-major, in the layout's wgmma
// layout, 1024-byte aligned, first), the words (WR rows of kCols), SR scale rows and SR
// zero-point rows (kCols values each, room for f32), a 16-byte group
// table (GPTQ rows with small groups) and the x rows' sums over the group
// (K1b with xs_pre).
template <class L, int BN>
struct Ring {
  static constexpr int kX = BN * L::KS * L::XB;
  static constexpr int kWOff = kX;
  static constexpr int kRow = kCols * 4;
  static constexpr int kSOff = kWOff + L::WR * kCols * 4;
  static constexpr int kZOff = kSOff + L::SR * kRow;
  static constexpr int kTOff = kZOff + L::SR * kRow;
  static constexpr int kXsOff = kTOff + 128;  // TMA writes 128-byte aligned shared memory
  static constexpr int kStage = (kXsOff + BN * 4 + 1023) / 1024 * 1024;
  static constexpr int kBlocksPerSm = BN <= 32 ? 2 : 1;  // decode: two blocks an SM hide each other's waits
  static constexpr int kFit = (kSmemLimit / kBlocksPerSm - kExtraBytes - 1024) / kStage;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kBytes = kStages * kStage + kExtraBytes + 1024;  // + 1024: aligning the base
  static_assert(kStages >= 3, "a stage does not fit three times in shared memory");
};

// A stage's pieces as the compute step reads them.
struct Stage {
  uint32_t x;          // shared address of the x tile
  const uint8_t* xp;   // the same, as a pointer
  const uint32_t* w;   // words
  const uint8_t* s;    // scale rows
  const float* z;      // zero-point rows
  const uint8_t* tab;  // group table
  const float* xs;     // x row sums (xs_pre)
};

template <class L, int BN>
__device__ __forceinline__ Stage stage_at(uint8_t* base) {
  using R = Ring<L, BN>;
  return {smem_u32(base), base, reinterpret_cast<const uint32_t*>(base + R::kWOff), base + R::kSOff,
          reinterpret_cast<const float*>(base + R::kZOff), base + R::kTOff,
          reinterpret_cast<const float*>(base + R::kXsOff)};
}

// The thread's column pair c, c + 1 in the block's tile: wgmma rows g and
// g + 8 of warp w in warpgroup wg are tile columns 64 wg + 16 w + 2g and
// + 1, so that a thread reads both columns' words with one 8-byte load.
__device__ __forceinline__ int pair_column() {
  return 64 * (threadIdx.x >> 7) + 16 * ((threadIdx.x >> 5) & 3) + 2 * ((threadIdx.x & 31) >> 2);
}

// Scale row r (of the stage) at tile column c, as f32 (K1b and K1c: f32 or bf16 scales).
__device__ __forceinline__ float scale_at(const Params& p, const uint8_t* rows, int r, int c) {
  return p.f32_scales ? reinterpret_cast<const float*>(rows)[r * kCols + c]
                      : __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(rows)[r * kCols + c]);
}

// Issue the copies of slice s into the stage at `base` (thread 0), on the
// stage's mbarrier `bar`; threads 0..KS/4-1 write the group table.
template <class L, int BN>
__device__ __forceinline__ void issue_slice(const Params& p, const L& lay, uint8_t* base, uint32_t bar, int s, int n0,
                                            int m0) {
  using R = Ring<L, BN>;
  const int g0 = lay.scale_row(s);
  if (L::kGroupTable && threadIdx.x < L::KS / 4) {
    // Stage row of each 4-k run (group % 4 == 0: a run never straddles a group).
    const int grp = min((s * L::KS + 4 * threadIdx.x) / p.group, p.num_groups - 1);
    base[R::kTOff + threadIdx.x] = static_cast<uint8_t>(grp - g0);
  }
  if (threadIdx.x != 0) return;
  const uint32_t sbase = smem_u32(base);
  const int sb = p.f32_scales ? 4 : 2;
  mbar_expect_tx(bar, BN * L::KS * L::XB + L::WR * kCols * 4 + L::SR * kCols * sb +
                          (p.zp_mode == 2 ? L::SR * kCols * 4 : 0) + (p.xs_pre ? BN * 4 : 0));
  lay.template load_x<BN>(sbase, bar, s, m0);
  tma_2d(sbase + R::kWOff, p.tm_w, bar, n0, lay.word_row(s));
  if (L::SR > 0) tma_2d(sbase + R::kSOff, p.tm_s, bar, n0, g0);
  if (p.zp_mode == 2) tma_2d(sbase + R::kZOff, p.tm_z, bar, n0, g0);
  if (p.xs_pre) tma_2d(sbase + R::kXsOff, p.tm_xs, bar, m0, g0);
}

// -- the kernel ----------------------------------------------------------------

// Whether layout L's sums take K8's row and column scales (L::kScaledOut):
// in the epilogue with one split, else in split_reduce_scaled_kernel.
template <class L, class = void>
struct ScaledOut : std::false_type {};
template <class L>
struct ScaledOut<L, std::void_t<decltype(L::kScaledOut)>> : std::bool_constant<L::kScaledOut> {};

// Keeps A fragments in their registers until the wgmma that reads them is
// known complete, so that the next slice is decoded into other registers.
template <int STEPS>
__device__ __forceinline__ void hold_fragments(uint32_t (&a)[STEPS][4]) {
#pragma unroll
  for (int j = 0; j < STEPS; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][i])::"memory");
}

// A layout L provides: its accumulator type Acc (float, or int for s8),
// whether its outputs take K8's scales (kScaledOut, false when absent),
// its slice geometry (XB, EPP, KS, WR, SR, kGroupTable, STEPS), Frag<BN> (the A fragments of one slice, a[STEPS][4], and what
// retiring the slice needs), State<BN> (carried across slices), word_row /
// scale_row / load_x (what issue_slice copies), decode (stage ->
// fragments), mma (fragments -> wgmma, committed) and retire (after the
// slice's wgmma completed).
template <class L, int BN>
__global__ void __launch_bounds__(kThreads, Ring<L, BN>::kBlocksPerSm) quant_gemm_kernel(const __grid_constant__ Params p) {
  using R = Ring<L, BN>;
  using Frag = typename L::template Frag<BN>;
  using Acc = typename L::Acc;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* extra = reinterpret_cast<float*>(smem + R::kStages * R::kStage);
  const uint32_t bars = smem_u32(extra + 16 + 2 * kCols);  // one mbarrier a stage
  const int n0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * BN;
  int s0, s1;
  split_range(p, blockIdx.z, s0, s1);
  const L lay(p, extra);
  auto stage = [&](int s) { return smem + ((s - s0) % R::kStages) * R::kStage; };
  auto bar = [&](int s) { return bars + 8 * ((s - s0) % R::kStages); };
  auto land = [&](int s) { mbar_wait(bar(s), ((s - s0) / R::kStages) & 1); };

  if (threadIdx.x == 0) {
    for (int i = 0; i < R::kStages; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < R::kStages - 1; ++i) {
    if (s0 + i < s1) issue_slice<L, BN>(p, lay, stage(s0 + i), bar(s0 + i), s0 + i, n0, m0);
  }
  Acc acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  typename L::template State<BN> state;
  Frag f0, f1;
  if (s0 < s1) {
    __syncthreads();  // the group tables written above
    land(s0);
    lay.template decode<BN>(f0, state, stage_at<L, BN>(stage(s0)), s0, extra);
  }
  // One step: the tensor cores take slice s (fragments `cur`) while the
  // threads decode slice s + 1 into `nxt`; the copies of slice s + kStages
  // - 1 go into the stage slice s - 1 left.
  auto step = [&](Frag& cur, Frag& nxt, int s) {
    lay.template mma<BN>(cur, state, acc, stage_at<L, BN>(stage(s)));
    if (s + 1 < s1) {
      __syncthreads();  // every thread is done with slice s - 1
      if (s + R::kStages - 1 < s1) {
        issue_slice<L, BN>(p, lay, stage(s + R::kStages - 1), bar(s + R::kStages - 1), s + R::kStages - 1, n0, m0);
      }
      land(s + 1);
      lay.template decode<BN>(nxt, state, stage_at<L, BN>(stage(s + 1)), s + 1, extra);
    } else {
      __syncthreads();  // what decoding slice s wrote to shared memory is visible to retire
    }
    wgmma_wait0();
    hold_fragments(cur.a);
    fence_operands(acc);
    lay.template retire<BN>(cur, state, acc, extra);
  };
  for (int s = s0; s < s1; s += 2) {
    step(f0, f1, s);
    if (s + 1 < s1) step(f1, f0, s + 1);
  }
  // The split reduction may start launching (it waits for this grid to
  // finish before it reads the workspace).
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // acc[4j + e] is output row m0 + 8j + 2t + (e & 1) and, with the
  // thread's column pair c, c + 1 (wgmma rows g and g + 8), column
  // c + (e >> 1): wgmma's accumulator layout, transposed back. Each row's
  // two columns go out as one 8-byte (f32) or 4-byte (bf16, f16) store. An s32
  // sum becomes fmul_rn(fmul_rn(float(v), sa[row]), sb[col]) first, or goes
  // to the int32 workspace; a scaled f32 sum (e4m3) the same with one
  // split, else it goes to the f32 workspace unscaled.
  constexpr bool kScaled = ScaledOut<L>::value;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int col = n0 + pair_column();
  if (col >= p.n) return;  // N even (16 | N for e4m3, 32 | N otherwise): both columns are in or out
  float sb0 = 0.0f, sb1 = 0.0f;
  if constexpr (kScaled) {
    sb0 = p.sb_scalar ? __ldg(p.sb) : __ldg(p.sb + col);
    sb1 = p.sb_scalar ? sb0 : __ldg(p.sb + col + 1);
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 8 * j + 2 * t + h;
      if (row >= p.m) continue;
      const int64_t at = static_cast<int64_t>(row) * p.n + col;
      float lo, hi;
      if constexpr (std::is_same_v<Acc, int>) {
        if (p.splits > 1) {
          *reinterpret_cast<int2*>(reinterpret_cast<int*>(p.ws) + static_cast<int64_t>(blockIdx.z) * p.m * p.n + at) =
              make_int2(acc[4 * j + h], acc[4 * j + 2 + h]);
          continue;
        }
        const float sa = p.sa_scalar ? __ldg(p.sa) : __ldg(p.sa + row);
        lo = __fmul_rn(__fmul_rn(static_cast<float>(acc[4 * j + h]), sa), sb0);
        hi = __fmul_rn(__fmul_rn(static_cast<float>(acc[4 * j + 2 + h]), sa), sb1);
      } else {
        lo = acc[4 * j + h];
        hi = acc[4 * j + 2 + h];
        if constexpr (kScaled) {
          if (p.splits == 1) {
            const float ra = p.sa_scalar ? __ldg(p.sa) : __ldg(p.sa + row);
            lo = __fmul_rn(__fmul_rn(lo, ra), sb0);
            hi = __fmul_rn(__fmul_rn(hi, ra), sb1);
          }
        }
      }
      if (p.splits > 1) {
        *reinterpret_cast<float2*>(p.ws + static_cast<int64_t>(blockIdx.z) * p.m * p.n + at) = make_float2(lo, hi);
      } else if (p.out_f32) {
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + at) = make_float2(lo, hi);
      } else if (p.out_f16) {
        *reinterpret_cast<uint32_t*>(static_cast<__half*>(p.out) + at) = pack_f16x2(lo, hi);
      } else {
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.out) + at) = pack_bf16x2(lo, hi);
      }
    }
  }
}

// out = the sum over the splits of ws in a fixed order, rounded once. A
// block takes 32 float4 outputs: warp g adds splits g, g + 8, g + 16, ...
// (its loads in flight together), then warp 0 adds the 8 warps' sums in
// warp order.
constexpr int kReduceWarps = 8;

template <typename O>
__global__ void __launch_bounds__(32 * kReduceWarps)
    split_reduce_kernel(const float4* __restrict__ ws, O* __restrict__ out, int64_t count4, int splits) {
  __shared__ float4 part[kReduceWarps][32];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the GEMM grid has finished and its stores are visible
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int64_t i = blockIdx.x * static_cast<int64_t>(32) + lane;
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (i < count4) {
    for (int s = g; s < splits; s += 4 * kReduceWarps) {
      float4 w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int su = s + u * kReduceWarps;
        w[u] = su < splits ? ws[su * count4 + i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) v.x += w[u].x, v.y += w[u].y, v.z += w[u].z, v.w += w[u].w;
    }
  }
  part[g][lane] = v;
  __syncthreads();
  if (g != 0 || i >= count4) return;
#pragma unroll
  for (int h = 1; h < kReduceWarps; ++h) {
    const float4 w = part[h][lane];
    v.x += w.x, v.y += w.y, v.z += w.z, v.w += w.w;
  }
  O* o = out + 4 * i;
  o[0] = from_float<O>(v.x), o[1] = from_float<O>(v.y), o[2] = from_float<O>(v.z), o[3] = from_float<O>(v.w);
}

// K8's reduction: out = the splits' sums of ws (W = int4: int32 sums, exact
// in any order; float4: e4m3's f32 sums, added in split order), times
// sa[row] then sb[col] in f32 (fmul_rn, in that order), rounded once. A
// thread takes 4 neighbouring outputs of one row (N % 16 == 0).
template <typename O, typename W>
__global__ void __launch_bounds__(256) split_reduce_scaled_kernel(const W* __restrict__ ws, O* __restrict__ out,
                                                                  int64_t count4, int splits, int n,
                                                                  const float* __restrict__ sa, int sa_scalar,
                                                                  const float* __restrict__ sb, int sb_scalar) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the GEMM grid has finished and its stores are visible
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= count4) return;
  W v{};
  for (int s = 0; s < splits; ++s) {
    const W w = ws[s * count4 + i];
    v.x += w.x, v.y += w.y, v.z += w.z, v.w += w.w;
  }
  const int64_t row = 4 * i / n;
  const int col = static_cast<int>(4 * i - row * n);
  const float ra = sa_scalar ? __ldg(sa) : __ldg(sa + row);
  auto scaled = [&](auto x, int c) {
    return from_float<O>(__fmul_rn(__fmul_rn(static_cast<float>(x), ra), sb_scalar ? __ldg(sb) : __ldg(sb + col + c)));
  };
  O* o = out + 4 * i;
  o[0] = scaled(v.x, 0), o[1] = scaled(v.y, 1), o[2] = scaled(v.z, 2), o[3] = scaled(v.w, 3);
}

template <class L, int BN>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using R = Ring<L, BN>;
  auto kernel = quant_gemm_kernel<L, BN>;
  cudaError_t status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kBytes);
  if (status != cudaSuccess) return status;
  const dim3 grid((p.n + kCols - 1) / kCols, (p.m + BN - 1) / BN, p.splits);
  kernel<<<grid, kThreads, R::kBytes, stream>>>(p);
  if (p.splits > 1) {
    // Launched as a programmatic dependent of the GEMM, so that its launch
    // overlaps the GEMM's last blocks.
    const int64_t count4 = static_cast<int64_t>(p.m) * p.n / 4;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(static_cast<unsigned>((count4 + 31) / 32));
    config.blockDim = dim3(32 * kReduceWarps);
    config.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    if constexpr (ScaledOut<L>::value) {
      using W = std::conditional_t<std::is_same_v<typename L::Acc, int>, int4, float4>;
      config.gridDim = dim3(static_cast<unsigned>((count4 + 255) / 256));
      config.blockDim = dim3(256);
      const auto* ws = reinterpret_cast<const W*>(p.ws);
      status = p.out_f32 ? cudaLaunchKernelEx(&config, split_reduce_scaled_kernel<float, W>, ws,
                                              static_cast<float*>(p.out), count4, p.splits, p.n, p.sa, p.sa_scalar,
                                              p.sb, p.sb_scalar)
                         : cudaLaunchKernelEx(&config, split_reduce_scaled_kernel<__nv_bfloat16, W>, ws,
                                              static_cast<__nv_bfloat16*>(p.out), count4, p.splits, p.n, p.sa,
                                              p.sa_scalar, p.sb, p.sb_scalar);
    } else {
      const auto* ws = reinterpret_cast<const float4*>(p.ws);
      if (p.out_f32) {
        status = cudaLaunchKernelEx(&config, split_reduce_kernel<float>, ws, static_cast<float*>(p.out), count4,
                                    p.splits);
      } else if (p.out_f16) {
        status = cudaLaunchKernelEx(&config, split_reduce_kernel<__half>, ws, static_cast<__half*>(p.out), count4,
                                    p.splits);
      } else {
        status = cudaLaunchKernelEx(&config, split_reduce_kernel<__nv_bfloat16>, ws,
                                    static_cast<__nv_bfloat16*>(p.out), count4, p.splits);
      }
    }
    if (status != cudaSuccess) return status;
  }
  return cudaGetLastError();
}

// Calls launch<L, BN> for the plan's BN (32, 64, or 128 up to MAX_BN).
template <class L, int MAX_BN = 128>
cudaError_t launch_bn(const Params& p, int bn, cudaStream_t stream) {
  switch (bn) {
    case 32: return launch<L, 32>(p, stream);
    case 64: return launch<L, 64>(p, stream);
    case 128:
      if constexpr (MAX_BN >= 128) return launch<L, 128>(p, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime (no
// link to libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t status =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t status = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return status == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(ptr)
                                                                         : nullptr;
  }();
  return fn;
}

// A tensor map over `rank` dimensions (innermost first; strides in bytes of
// dimensions 1 ..), read in boxes of `box`; elements past the edges read as
// zero.
inline bool encode(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base, const cuuint64_t* dims,
                   const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn != nullptr && fn(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(base), dims, strides, box,
                             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of the words (K / epp, N), scales and zero-points (groups, N):
// boxes of the block's 128 columns and WR or SR rows.
template <class L>
bool encode_weights(Params& p, const void* packed, const void* scales) {
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(p.n), static_cast<cuuint64_t>(p.k / L::EPP)};
  const cuuint64_t wstride[1] = {static_cast<cuuint64_t>(p.n) * 4};
  const cuuint32_t wbox[2] = {kCols, L::WR};
  const cuuint64_t sdims[2] = {static_cast<cuuint64_t>(p.n), static_cast<cuuint64_t>(p.num_groups)};
  const cuuint64_t sstride[1] = {static_cast<cuuint64_t>(p.n) * (p.f32_scales ? 4 : 2)};
  const cuuint64_t zstride[1] = {static_cast<cuuint64_t>(p.n) * 4};
  const cuuint32_t sbox[2] = {kCols, L::SR};
  return encode(&p.tm_w, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, packed, wdims, wstride, wbox, CU_TENSOR_MAP_SWIZZLE_NONE) &&
         encode(&p.tm_s,
                p.f32_scales   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                : p.f16_scales ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, scales, sdims, sstride, sbox, CU_TENSOR_MAP_SWIZZLE_NONE) &&
         (p.zp_mode != 2 || encode(&p.tm_z, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, p.zp, sdims, zstride, sbox,
                                   CU_TENSOR_MAP_SWIZZLE_NONE));
}

// Refuse a plan that template L cannot run: BN outside {32, 64, 128} or
// above MAX_BN, a K slice other than L's, slices that do not cover K
// exactly once, a unit that does not end on a group boundary, splits
// outside 1 .. units, or a missing workspace. The plan itself (slices,
// unit, splits) is the Python wrapper's, used as it is by split_range.
template <class L, int MAX_BN = 128>
bool plan_ok(const Params& p, int bn, int ks) {
  if ((bn != 32 && bn != 64 && bn != 128) || bn > MAX_BN || ks != L::KS || p.unit < 1 || p.splits < 1) return false;
  const int units = (p.slices + p.unit - 1) / p.unit;
  return p.slices == (p.k + ks - 1) / ks && (p.unit * ks) % p.group == 0 && p.splits <= units &&
         (p.splits == 1 || p.ws != nullptr);
}

}  // namespace qgemm
}  // namespace conch
