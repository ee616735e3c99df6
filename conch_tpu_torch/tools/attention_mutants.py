# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Show that the card checks of K3/K7's softcap and window, of K7's masks,
of K3's and K7's split merges, and of K11's merge, diagonal, padding
rows and kv_scale, can fail.

    python3 -m conch_tpu_torch.tools.attention_mutants [NAME ...]

Run from the checkout's root on one Hopper card. For each fault below (or
the named ones), the tool copies the package to
``conch_tpu_torch/_build/mutants/<name>/``, puts the fault into the copy's
CUDA source, and runs the fault's checks on the copy in a subprocess,
which builds the copy's kernels: ``chip_smoke.gemma_attention_phases`` (K3
and K7 at Gemma-2-2B's shapes, held against the plain versions) for the
softcap faults and K3's window fault,
``chip_smoke.check_paged_attention_options`` (K3's option sweep) for K3's
merge faults (a split dropped, the splits' rescale skipped),
``chip_smoke.kernel_phase_k3_served`` (K3 at the served decode steps, where
Llama's flat softmax gives small outputs) for the dropped split again, and
``chip_smoke.check_varlen_attention_options`` (K7's option sweep) for K7's
other faults: each row's window start dropped from the mask (the walk
still starts at its tile's first window start), the causal mask one key
late on the diagonal, the first tile of a windowed walk (a band tile
whose first keys the tile's first rows need) skipped, a split dropped from
the merge; ``chip_smoke.check_mla_attention_options`` (K11's option sweep)
for K11's faults: the first split dropped from the merge, the causal
limit of each row one key late, the copies of the last sequence's tokens
into the padding rows dropped (one split), ``kv_scale`` not folded into the
output; and the rolling-KV ring of K3 and K7, caught by their option
sweeps' ring cases (``check_paged_ring_options``, ``check_varlen_ring_options``):
a true page read at its own table entry (the ring's modulo dropped), K3's
rows past the end of the ring not wrapped to its start, and a walk that
starts at page 0 under a ring (the window band's start dropped); and
the f16 branches, caught by the option sweeps' f16 cases: K7's f16 MMA
fed 1-byte cache rows widened to bf16 bits, and K3's merge storing an f16
output as bf16 bits.
The unchanged package must pass all the checks first, and
every faulty copy must fail a check; the tool prints each run's check
lines and exits non-zero otherwise.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

from conch_tpu_torch.kernels.common import BUILD_DIR

PACKAGE_DIR = Path(__file__).resolve().parents[1]
REPO_ROOT = PACKAGE_DIR.parent
K7_LOGIT = "x = p.softcap > 0.0f ? cap_log2 * tanhf(x * scale_cap) : x * scale_log2;"
K7_SUM = "for (int z = 0; z < live; ++z) a += p.part_acc[z * split_stride * p.head_size + at] * w_s[gh][z];"
K3_SCALE_THEN_CAP = (
    "float x = warp_sum(part[g]) * p.scale;\n"
    "          if constexpr (SOFTCAP) x = p.softcap * tanhf(x / p.softcap);"
)
K3_WEIGHT = "w_s[z] = __expf(p.part_ml[(z * split_stride + head) * 2] - m);"
K3_SUM = "for (int z = 0; z < live; ++z) a += p.part_acc[(z * split_stride + head) * p.head_size + d] * w_s[z];"
K3_START = "const int kv_start = window > 0 ? max(seq_len - window, 0) : 0;"
K7_LO = "t.lo = p.window > 0 ? max(t.first - p.window + 1, 0) : 0;"
RING_ENTRY = "bt_row[p.ring_pages > 0 ? entry % p.ring_pages : entry]"
K3_RING_ENTRY = (
    "const int entry0 = p.ring_pages > 0 ? first % p.ring_pages : first;\n"
    "  const int wrap = p.ring_pages > 0 ? p.ring_pages : INT_MAX;"
)
K3_RING_WRAP = "if (entry >= wrap) entry -= wrap;"
K3_MERGE_STORE = "out[head * p.head_size + d] = from_float<T>(live > 0 ? a / l * p.v_scale : 0.0f);"
K3_MERGE_STORE_BF16_BITS = (
    "const float o = live > 0 ? a / l * p.v_scale : 0.0f;\n"
    "    if constexpr (std::is_same_v<T, __half>) out[head * p.head_size + d] = "
    "__ushort_as_half(__bfloat16_as_ushort(__float2bfloat16(o)));\n"
    "    else out[head * p.head_size + d] = from_float<T>(o);"
)
GEMMA, OPTIONS, SERVED = "gemma_attention_phases", "check_paged_attention_options", "kernel_phase_k3_served"
K7_OPTIONS = "check_varlen_attention_options"
K11_OPTIONS = "check_mla_attention_options"
# name -> (source file under csrc/, text, faulty text, the chip_smoke checks that must catch it)
MUTANTS = {
    "k7_softcap_dropped": ("varlen_attention.cu", K7_LOGIT, "x = x * scale_log2;", GEMMA),
    "k7_cap_before_scale": (
        "varlen_attention.cu", K7_LOGIT,
        "x = p.softcap > 0.0f ? cap_log2 * tanhf(x / p.softcap) * p.scale : x * scale_log2;", GEMMA,
    ),
    "k3_softcap_dropped": ("paged_attention.cuh", K3_SCALE_THEN_CAP, "float x = warp_sum(part[g]) * p.scale;", GEMMA),
    "k3_window_ignored": ("paged_attention.cuh", K3_START, "const int kv_start = 0;", GEMMA),
    "k3_ring_modulo_dropped": (
        "paged_attention.cuh", K3_RING_ENTRY, "const int entry0 = first;\n  const int wrap = INT_MAX;", OPTIONS,
    ),
    "k3_ring_wrap_dropped": ("paged_attention.cuh", K3_RING_WRAP, "(void)wrap;", OPTIONS),
    "k3_ring_band_from_zero": (
        "paged_attention.cuh", K3_START, K3_START.replace("window > 0 ?", "window > 0 && p.ring_pages == 0 ?"),
        OPTIONS,
    ),
    "k7_ring_modulo_dropped": ("varlen_attention.cu", RING_ENTRY, "bt_row[entry]", K7_OPTIONS),
    "k7_ring_band_from_zero": (
        "varlen_attention.cu", K7_LO, K7_LO.replace("p.window > 0 ?", "p.window > 0 && p.ring_pages == 0 ?"),
        K7_OPTIONS,
    ),
    "k7_window_mask_dropped": (
        "varlen_attention.cu", "return p.window > 0 ? max(t.first + i - p.window + 1, 0) : 0;", "return 0;",
        K7_OPTIONS,
    ),
    "k7_diagonal_off_by_one": (
        "varlen_attention.cu", "return p.causal ? t.first + i : t.seq_len - 1;",
        "return p.causal ? t.first + i + 1 : t.seq_len - 1;", K7_OPTIONS,
    ),
    "k7_band_tile_skipped": (
        "varlen_attention.cu", "k0 + n - 1 < w_min_start) continue;",
        "k0 + n - 1 < w_min_start || (p.window > 0 && k0 == t.lo)) continue;", K7_OPTIONS,
    ),
    "k7_merge_split_dropped": ("varlen_attention.cu", K7_SUM, K7_SUM.replace("z = 0", "z = 1"), K7_OPTIONS),
    "k3_merge_split_dropped": ("paged_attention.cuh", K3_SUM, K3_SUM.replace("z = 0", "z = 1"), OPTIONS),
    "k3_merge_split_dropped_served": ("paged_attention.cuh", K3_SUM, K3_SUM.replace("z = 0", "z = 1"), SERVED),
    "k3_merge_rescale_skipped": ("paged_attention.cuh", K3_WEIGHT, "w_s[z] = 1.0f;", OPTIONS),
    "k11_merge_split_dropped": (
        "mla_attention.cu", "for (int z0 = 0; z0 < live; z0 += 8) {", "for (int z0 = 1; z0 < live; z0 += 8) {",
        K11_OPTIONS,
    ),
    "k11_diagonal_off_by_one": (
        "mla_attention.cu", "return p.causal ? t.seq_k - t.q_len + (t.row0 + r) / p.heads : t.seq_k - 1;",
        "return p.causal ? t.seq_k - t.q_len + (t.row0 + r) / p.heads + 1 : t.seq_k - 1;", K11_OPTIONS,
    ),
    "k11_padding_copy_dropped": (
        "mla_attention.cu", "for (int row = total + i; row < end; ++row) put(row);", "(void)end;", K11_OPTIONS,
    ),
    "k11_kv_scale_not_in_output": ("mla_attention.cu", "p.v_scale = v_scale;", "p.v_scale = 1.0f;", K11_OPTIONS),
    "k7_f16_fed_bf16_rows": (
        "gemm_common.cuh", "if constexpr (std::is_same_v<T, __half>) return widen8_f16<C>(raw);",
        "if constexpr (std::is_same_v<T, __half>) return widen8_bf16<C>(raw);", K7_OPTIONS,
    ),
    "k3_f16_out_as_bf16": ("paged_attention.cuh", K3_MERGE_STORE, K3_MERGE_STORE_BF16_BITS, OPTIONS),
}


def phases_script(*checks: str) -> str:
    calls = "".join(f"chip_smoke.{c}(gen, np.random.default_rng(chip_smoke.SEED))\n" for c in checks)
    return (
        "import numpy as np, torch, chip_smoke, conch_tpu_torch\n"
        "print('package:', conch_tpu_torch.__file__, flush=True)\n"
        "gen = torch.Generator(device='cuda').manual_seed(chip_smoke.SEED)\n"
        "chip_smoke.build()\n" + calls
    )


def copy_package(name: str, mutant: tuple[str, str, str] | None) -> Path:
    """The package copied to ``_build/mutants/<name>``, with the fault put in."""
    root = BUILD_DIR / "mutants" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PACKAGE_DIR, root / PACKAGE_DIR.name, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    if mutant is not None:
        source, text, faulty = mutant
        path = root / PACKAGE_DIR.name / "csrc" / source
        code = path.read_text()
        if code.count(text) != 1:
            msg = f"{name}: the text to change is not in {source} exactly once"
            raise RuntimeError(msg)
        path.write_text(code.replace(text, faulty))
    return root


def run_phases(root: Path, script: str, timeout: float | None = None) -> tuple[int, str]:
    """Run ``script`` with ``root``'s package first on the path; past
    ``timeout`` seconds it is killed and the exit code is 124."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(root), str(REPO_ROOT)])}
    try:
        proc = subprocess.run(
            [sys.executable, "-c", script], cwd=root, env=env, capture_output=True, text=True, check=False,
            timeout=timeout,
        )
    except subprocess.TimeoutExpired as e:
        return 124, (e.stdout or b"").decode(errors="replace") + (e.stderr or b"").decode(errors="replace")
    return proc.returncode, proc.stdout + proc.stderr


def main() -> int:
    names = sys.argv[1:] or list(MUTANTS)
    chosen = {name: MUTANTS[name] for name in names}
    ok = True
    for name, mutant in {"unchanged": None, **chosen}.items():
        checks = tuple(dict.fromkeys(m[3] for m in chosen.values())) if mutant is None else (mutant[3],)
        code, out = run_phases(copy_package(name, None if mutant is None else mutant[:3]), phases_script(*checks))
        lines = [ln for ln in out.splitlines() if "package:" in ln or "max_abs_err" in ln or "Error" in ln]
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
