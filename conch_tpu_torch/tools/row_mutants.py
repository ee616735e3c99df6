# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Show that the card checks of K5 (RoPE), K10a (Gemma RMS norm), K4 (RMS
norm), K2 (the stacked KV-cache write) and K6 / K10b (the gated
activations) can fail.

    python3 -m conch_tpu_torch.tools.row_mutants [NAME ...]

Run from the checkout's root on one Hopper card. For each fault below (or
the named ones), the tool copies the package to
``conch_tpu_torch/_build/mutants/<name>/`` with only the two kernels'
sources under ``csrc/`` (so each copy builds in seconds), puts the fault
into the copy, and runs the fault's option sweep of ``chip_smoke.py`` on
the copy in a subprocess: ``check_rope_options`` (K5 over 2304 cases),
``check_gemma_rms_norm_options`` (K10a over 672 cases),
``check_rms_norm_options`` (K4 over 756 cases, bit for bit),
``check_cache_write_options`` (K2 over 1344 cases, byte for byte) or
``check_gated_act_options`` (K6 and K10b over 1470 cases each way, within
JAX's tolerances and bit for bit against the kernel's own rounding of its
f32 activation), each against the kernel's plain version. The unchanged copy must pass the
sweeps first,
and every faulty copy must fail its sweep: a check's AssertionError, or,
for the vector path on a misaligned row, the card's misaligned-address
fault inside the sweep (never a failed build). The tool prints each run's
result lines and exits non-zero otherwise. The faults:

- ``k10a_weight_not_plus_one``: K10a multiplies by w, not 1 + w;
- ``k10a_tail_dropped``: the row kernel K10a shares with K4 leaves out a
  row's scalar tail (the last hidden % 8 elements of a single bf16 row of
  531 take it: neither summed nor written);
- ``k5_sin_sign_flipped``: K5's vector path computes the second half as
  x2 * cos - x1 * sin;
- ``k5_tail_not_copied``: K5's vector path does not copy the elements past
  rot_dim;
- ``k5_vector_on_misaligned_stride``: ``rope_plan`` takes the vector path
  whatever the row strides, so rows that break 16-byte alignment get
  16-byte loads;
- ``k4_normalized_not_rounded``: K4 multiplies x * inv by w without first
  rounding it to x's dtype;
- ``k4_sum_in_f32``: K4 sums the squares in f32 and divides in f32;
- ``k2_entry_off_by_one``: K2 writes each token one entry past its slot;
- ``k2_idle_rows_written``: K2 drops the idle check, so a slot of -1 writes
  entry -1 of page 0;
- ``k2_int8_round_toward_zero``: K2's int8 store truncates instead of
  rounding half to even;
- ``gated_act_not_rounded``: K6 and K10b multiply the f32 activation by up
  without first rounding it to the dtype;
- ``gated_act_last_vector_skipped``: K6 and K10b store no row's last
  unit (vector, or element on the scalar path);
- ``gated_act_up_from_gate_half``: the fused entry points read up from the
  gate's half (up = x, not x + d);
- ``gated_act_gate_stride_ignored``: K6 and K10b take gate's row stride as
  d, whatever the call passes.
"""

from __future__ import annotations

import shutil
import sys

from conch_tpu_torch.tools.attention_mutants import BUILD_DIR, PACKAGE_DIR, copy_package, run_phases

ROPE, NORM = "check_rope_options", "check_gemma_rms_norm_options"
LLAMA_NORM, CACHE = "check_rms_norm_options", "check_cache_write_options"
GATED = "check_gated_act_options"
RNG = "np.random.default_rng(chip_smoke.SEED)"
PHASE_ARGS = {ROPE: f"gen, {RNG}", NORM: "gen", LLAMA_NORM: "gen", CACHE: f"gen, {RNG}", GATED: "gen"}
ROW_SOURCES = (
    "rotary_embedding.cu", "gemma_rms_norm.cu", "rms_norm.cu", "reshape_and_cache.cu", "silu_and_mul.cu",
    "gelu_tanh_and_mul.cu",
)
K4_SUM_F64 = """  using Acc = double;
  static __device__ __forceinline__ void add(double& sq, float f) { sq += static_cast<double>(f * f); }
  static __device__ __forceinline__ float inv(double total, int hidden, float eps) {
    return rsqrtf(static_cast<float>(total / hidden) + eps);"""
K4_SUM_F32 = """  using Acc = float;
  static __device__ __forceinline__ void add(float& sq, float f) { sq += f * f; }
  static __device__ __forceinline__ float inv(float total, int hidden, float eps) {
    return rsqrtf(total / static_cast<float>(hidden) + eps);"""
# name -> (file under the package, text, faulty text, the chip_smoke sweep that must catch it)
MUTANTS = {
    "k10a_weight_not_plus_one": ("csrc/gemma_rms_norm.cu", "return x * inv * (1.0f + w);", "return x * inv * w;",
                                 NORM),
    "k10a_tail_dropped": (
        "csrc/row_norm.cuh", "const bool has_tail = live && t0 + lane < p.hidden;",
        "const bool has_tail = false;", NORM,
    ),
    "k5_sin_sign_flipped": ("csrc/rotary_embedding.cu", "o2[e] = __fadd_rn(", "o2[e] = __fsub_rn(", ROPE),
    "k5_tail_not_copied": (
        "csrc/rotary_embedding.cu", "*reinterpret_cast<uint4*>(dst + j) = a;", "(void)a;", ROPE,
    ),
    "k5_vector_on_misaligned_stride": (
        "kernels/embedding/rotary_embedding.py",
        "strides = num_tokens <= 1 or (q_row_stride % vec == 0 and k_row_stride % vec == 0)", "strides = True",
        ROPE,
    ),
    "k4_normalized_not_rounded": (
        "csrc/rms_norm.cu", "return to_float(from_float<T>(x * inv)) * w;", "return x * inv * w;", LLAMA_NORM,
    ),
    "k4_sum_in_f32": ("csrc/rms_norm.cu", K4_SUM_F64, K4_SUM_F32, LLAMA_NORM),
    "k2_entry_off_by_one": (
        "csrc/reshape_and_cache.cu", "const int entry = slot - page * p.page_size;",
        "const int entry = slot - page * p.page_size + 1;", CACHE,
    ),
    "k2_idle_rows_written": ("csrc/reshape_and_cache.cu", "if (slot < 0) return;", "", CACHE),
    "k2_int8_round_toward_zero": ("csrc/reshape_and_cache.cu", "fmaxf(rintf(x)", "fmaxf(truncf(x)", CACHE),
    "gated_act_not_rounded": (
        "csrc/gated_act.cuh", "return to_float(from_float<T>(Act::apply(g))) * u;", "return Act::apply(g) * u;",
        GATED,
    ),
    "gated_act_last_vector_skipped": (
        "csrc/gated_act.cuh", "reinterpret_cast<C*>(p.out)[unit] = narrow<T, V>(gf);",
        "if ((unit + 1) % p.row_units != 0) reinterpret_cast<C*>(p.out)[unit] = narrow<T, V>(gf);", GATED,
    ),
    "gated_act_up_from_gate_half": (
        "csrc/gated_act.cuh", "const void* up = static_cast<const char*>(x) + static_cast<size_t>(d) * elem;",
        "const void* up = x;", GATED,
    ),
    "gated_act_gate_stride_ignored": (
        "csrc/gated_act.cuh", "static_cast<const T*>(p.gate) + row * p.gate_row_stride + col",
        "static_cast<const T*>(p.gate) + row * static_cast<int64_t>(p.row_units) * V + col", GATED,
    ),
}


def copy_rows(name: str, mutant: tuple[str, str, str] | None):
    """The package copied with only the row kernels' sources, the fault put in."""
    root = copy_package(name, None)
    package = root / PACKAGE_DIR.name
    for source in (package / "csrc").glob("*.cu"):
        if source.name not in ROW_SOURCES:
            source.unlink()
    if mutant is not None:
        path, text, faulty = mutant
        code = (package / path).read_text()
        if code.count(text) != 1:
            msg = f"{name}: the text to change is not in {path} exactly once"
            raise RuntimeError(msg)
        (package / path).write_text(code.replace(text, faulty))
    return root


def phases_script(*checks: str) -> str:
    calls = "".join(f"chip_smoke.{c}({PHASE_ARGS[c]})\n" for c in checks)
    return (
        "import numpy as np, torch, chip_smoke, conch_tpu_torch\n"
        "print('package:', conch_tpu_torch.__file__, flush=True)\n"
        "gen = torch.Generator(device='cuda').manual_seed(chip_smoke.SEED)\n"
        "chip_smoke.build()\n" + calls
    )


def main() -> int:
    names = sys.argv[1:] or list(MUTANTS)
    chosen = {name: MUTANTS[name] for name in names}
    ok = True
    for name, mutant in {"unchanged": None, **chosen}.items():
        checks = tuple(dict.fromkeys(m[3] for m in chosen.values())) if mutant is None else (mutant[3],)
        code, out = run_phases(copy_rows(name, None if mutant is None else mutant[:3]), phases_script(*checks))
        lines = [ln for ln in out.splitlines() if "package:" in ln or "options" in ln or "Error" in ln]
        # A faulty copy must fail its sweep, not its build.
        failed_sweep = (code != 0 and "nvcc failed" not in out
                        and ("AssertionError" in out or "misaligned address" in out))
        expected = code == 0 if mutant is None else failed_sweep
        ok &= expected
        print(f"{name}: exit code {code}, {'as expected' if expected else 'NOT as expected'}", flush=True)
        for line in lines if expected else out.splitlines()[-40:]:
            print("   ", line[:600], flush=True)
    shutil.rmtree(BUILD_DIR / "mutants", ignore_errors=True)
    print("every fault was caught" if ok else "a fault was not caught, or the unchanged package failed", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
