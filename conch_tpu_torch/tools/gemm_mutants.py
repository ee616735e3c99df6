# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Show that the card checks of K1, K1b, K1c, K8 and K12q can fail.

    python3 -m conch_tpu_torch.tools.gemm_mutants [NAME ...]

Run from the checkout's root on one Hopper card. For each fault below (or
the named ones), the tool copies the package to ``conch_tpu_torch/_build/mutants/<name>/``,
puts the fault into the copy's CUDA source, and runs the kernel's phase of
``chip_smoke.py`` (``check_magic_gemm_options``: K1's option sweep;
``kernel_phase_k1b``, ``_k1c``, ``_k8`` or ``_k12q``: the kernel at the
served shapes and the small cases, held against its plain version;
``check_scaled_gemm_options``: K8's option sweep, bit for bit;
``check_scaled_e4m3_options``: its float8_e4m3fn half;
``check_quant_gemm_options``: K1b's and K1c's option sweep) on the copy in
a subprocess, which builds the copy's kernels (a copy for the sweeps alone
holds only their sources, ``PHASE_SOURCES``, so it builds in seconds). The
unchanged package
must pass the faults' phases first and every faulty copy must fail a check
of its own; the tool prints each run's check lines and exits non-zero
otherwise.
The faults:

- ``k1_field_shift``: K1 decodes a word's bit fields in the wrong order
  (field f ^ 1 for k16 step j, not the field that holds its x values);

- ``k1_g32_scale_row_shifted``: K1 at group 32 scales each group of a
  slice by the next group's scale row (the slice's two rows swapped);
- ``k1_f16_bf16_magic``: K1 under f16 x decodes the codes with bf16's
  magic bits (0x4300), so the pairs read as f16 values far from 1024 + c;
- ``k1_f16_scales_read_as_bf16``: K1 under f16 x reads f16 scales as bf16
  bits;

- ``k1b_gptq_rows``: K1b takes the planar words' bit fields in GPTQ order
  (field j % epp for k16 step j, not the field that holds its x values);
- ``k1b_g32_fold_skipped``: K1b at 8 word rows a slice skips the fold of
  every odd group (its sums are overwritten by the next group's first
  wgmma);
- ``k1b_g32_row_sum_wrong_group``: K1b at 8 word rows a slice, up to 64
  rows a block, takes the zero-point term's x row sums of the group before
  (the other buffer);
- ``k1c_codebook_ignored``: K1c dequantizes codebook codes as linear
  integers (the NF4 table unused);
- ``k8_scales_swapped``: K8 scales row m by sb (index clamped to its
  length, so the copy reads in bounds), in the epilogue of a block that
  holds all of K (the 512-row prefill shapes);
- ``k8_split_workspace_f32``: K8's split sums pass through f32 on their way
  to the workspace (as an f32 workspace would hold them): sums above 2^24
  lose their low bits, which the option sweep's near-127 case shows;
- ``k8_e4m3_scales_swapped``: K8's split reduction (int8 and e4m3) scales
  row m by sb (index clamped to its length);
- ``k8_e4m3_split_dropped``: the split reduction adds the first split's
  partial sums only;
- ``k8_e4m3_tail_not_zero_filled``: a's and b's tensor maps end at K
  rounded up to the 128-k slice (at most a's row stride), so the last
  slice reads a's row past K and b's rows past its layer (the sweep's e4m3
  stack has a layer after the one it reads) in place of zeros;
- ``k8_e4m3_not_promoted``: every slice's wgmmas sum into the running
  accumulator, with no f32 promotion (the all-positive case at K 14336
  holds each output to 1e-3 of itself);
- ``k12q_nibbles_swapped``: K12q puts the even element in the low nibble;
- ``k12q_threshold_not_strict``: K12q's second bisection step compares
  with ``>=``, so a value equal to NF4's third or eleventh threshold takes
  the code above (``check_quantize4_options``: its f32 inputs hold every
  threshold exactly).
"""

from __future__ import annotations

import shutil
import sys

from conch_tpu_torch.tools.attention_mutants import BUILD_DIR, copy_package, run_phases

# name -> (source file under csrc/, text, faulty text, phase)
MUTANTS = {
    "k1_field_shift": (
        "mixed_gemm_magic.cu",
        "uint32_t magic = ((word >> (4 * f)) & 0x000F000Fu) | Magic<T>::kBits;",
        "uint32_t magic = ((word >> (4 * (f ^ 1))) & 0x000F000Fu) | Magic<T>::kBits;",
        "check_magic_gemm_options",
    ),
    "k1_g32_scale_row_shifted": (
        "mixed_gemm_magic.cu",
        "        s2[q][0] = scale2(st.s, q, c);\n"
        "        s2[q][1] = scale2(st.s, q, c + 1);",
        "        s2[q][0] = scale2(st.s, (q + 1) % SR, c);\n"
        "        s2[q][1] = scale2(st.s, (q + 1) % SR, c + 1);",
        "check_magic_gemm_options",
    ),
    "k1_f16_bf16_magic": (
        "mixed_gemm_magic.cu",
        "  static constexpr uint32_t kBits = 0x64006400u;",
        "  static constexpr uint32_t kBits = 0x43004300u;",
        "check_magic_gemm_options",
    ),
    "k1_f16_scales_read_as_bf16": (
        "mixed_gemm_magic.cu",
        "      if (p.f16_scales) return __half2half2(reinterpret_cast<const __half*>(rows)[i]);",
        "      if (p.f16_scales) return __float2half2_rn(\n"
        "          __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(rows)[i]));",
        "check_magic_gemm_options",
    ),
    "k1b_g32_fold_skipped": (
        "mixed_gemm_planar.cu",
        "    fr.last = sub == spg - 1;",
        "    fr.last = sub == spg - 1 && !(SUB == 8 && ((s / spg) & 1));",
        "check_quant_gemm_options",
    ),
    "k1b_g32_row_sum_wrong_group": (
        "mixed_gemm_planar.cu",
        "      fr.xs = row_sums(extra, (s / spg) & 1);",
        "      fr.xs = row_sums(extra, (s / spg + (SUB == 8 ? 1 : 0)) & 1);",
        "check_quant_gemm_options",
    ),
    "k1b_gptq_rows": (
        "mixed_gemm_planar.cu",
        "      const int f = j / NB;",
        "      const int f = j % EPP;",
        "kernel_phase_k1b",
    ),
    "k1c_codebook_ignored": (
        "mixed_gemm_rows.cu",
        "      return book[c];",
        "      return static_cast<float>(c) - p.bias;",
        "kernel_phase_k1c",
    ),
    "k8_scales_swapped": (
        "quant_gemm_mainloop.cuh",
        "const float sa = p.sa_scalar ? __ldg(p.sa) : __ldg(p.sa + row);",
        "const float sa = p.sb_scalar ? __ldg(p.sb) : __ldg(p.sb + min(row, p.n - 1));",
        "kernel_phase_k8",
    ),
    "k8_split_workspace_f32": (
        "quant_gemm_mainloop.cuh",
        "make_int2(acc[4 * j + h], acc[4 * j + 2 + h]);",
        "make_int2(static_cast<int>(static_cast<float>(acc[4 * j + h])),\n"
        "                        static_cast<int>(static_cast<float>(acc[4 * j + 2 + h])));",
        "check_scaled_gemm_options",
    ),
    "k8_e4m3_scales_swapped": (
        "quant_gemm_mainloop.cuh",
        "const float ra = sa_scalar ? __ldg(sa) : __ldg(sa + row);",
        "const float ra = sb_scalar ? __ldg(sb) : __ldg(sb + (row < n ? row : n - 1));",
        "check_scaled_e4m3_options",
    ),
    "k8_e4m3_split_dropped": (
        "quant_gemm_mainloop.cuh",
        "for (int s = 0; s < splits; ++s) {",
        "for (int s = 0; s < 1; ++s) {",
        "check_scaled_e4m3_options",
    ),
    "k8_e4m3_tail_not_zero_filled": (
        "scaled_gemm.cu",
        "const cuuint64_t k_end = static_cast<cuuint64_t>(p.k);",
        "const int64_t k_up = (p.k + L::KS - 1) / L::KS * L::KS;\n"
        "  const cuuint64_t k_end = static_cast<cuuint64_t>(k_up < lda ? k_up : lda);",
        "check_scaled_e4m3_options",
    ),
    "k8_e4m3_not_promoted": (
        "scaled_gemm.cu",
        "static constexpr bool kPromote = true;",
        "static constexpr bool kPromote = false;",
        "check_scaled_e4m3_options",
    ),
    "k12q_nibbles_swapped": (
        "quantize4.cu",
        "return NF4 ? (nf4_code(sa, t_s) << 4) | nf4_code(sb, t_s) : (fp4_code(sa) << 4) | fp4_code(sb);",
        "return NF4 ? (nf4_code(sb, t_s) << 4) | nf4_code(sa, t_s) : (fp4_code(sb) << 4) | fp4_code(sa);",
        "kernel_phase_k12q",
    ),
    "k12q_threshold_not_strict": (
        "quantize4.cu", "c4 += v > *reinterpret_cast<const float*>(tb + c4 + 12) ? 16u : 0u;",
        "c4 += v >= *reinterpret_cast<const float*>(tb + c4 + 12) ? 16u : 0u;",
        "check_quantize4_options",
    ),
}

# Phases whose kernels build from these sources alone: a copy that runs only
# such phases keeps only their sources.
PHASE_SOURCES = {
    "check_scaled_e4m3_options": ("scaled_gemm.cu",),
    "check_magic_gemm_options": ("mixed_gemm_magic.cu",),
    "check_quant_gemm_options": ("mixed_gemm_planar.cu", "mixed_gemm_rows.cu"),
}


def phases_script(phases: tuple[str, ...]) -> str:
    calls = "".join(f"chip_smoke.{p}(gen)\n" for p in phases)
    return (
        "import torch, chip_smoke, conch_tpu_torch\n"
        "print('package:', conch_tpu_torch.__file__, flush=True)\n"
        "gen = torch.Generator(device='cuda').manual_seed(chip_smoke.SEED)\n"
        "chip_smoke.build()\n" + calls
    )


def main() -> int:
    names = sys.argv[1:] or list(MUTANTS)
    chosen = {name: MUTANTS[name] for name in names}
    ok = True
    for name, mutant in {"unchanged": None, **chosen}.items():
        phases = tuple(dict.fromkeys(m[3] for m in chosen.values())) if mutant is None else (mutant[3],)
        root = copy_package(name, None if mutant is None else mutant[:3])
        if all(phase in PHASE_SOURCES for phase in phases):
            keep = {source for phase in phases for source in PHASE_SOURCES[phase]}
            for source in (root / "conch_tpu_torch" / "csrc").glob("*.cu"):
                if source.name not in keep:
                    source.unlink()
        code, out = run_phases(root, phases_script(phases))
        lines = [ln for ln in out.splitlines() if "package:" in ln or "max_abs_err" in ln or "differ" in ln
                 or "Error" in ln or "all-positive" in ln]
        # A faulty copy must fail a check, not its build or launch.
        failed_check = code != 0 and "AssertionError" in out and "nvcc failed" not in out
        expected = code == 0 if mutant is None else failed_check
        ok &= expected
        print(f"{name}: exit code {code}, {'as expected' if expected else 'NOT as expected'}", flush=True)
        for line in lines if expected else out.splitlines()[-40:]:
            print("   ", line, flush=True)
    shutil.rmtree(BUILD_DIR / "mutants", ignore_errors=True)
    print("every fault was caught" if ok else "a fault was not caught, or the unchanged package failed", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
