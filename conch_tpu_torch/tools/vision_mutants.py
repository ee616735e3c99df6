# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Show that the card checks of K13c (the NMS keep mask) and K13b (the BEV
pool backward) can fail.

    python3 -m conch_tpu_torch.tools.vision_mutants [NAME ...]

Run from the checkout's root on one Hopper card. For each fault below (or
the named ones), the tool copies the package to
``conch_tpu_torch/_build/mutants/<name>/`` with only ``csrc/nms.cu`` and
``csrc/bev_pool.cu`` (so each copy builds in seconds), puts the fault into
the copy, and runs the fault's sweep of ``chip_smoke.py`` on the copy in a
subprocess: ``check_nms_options`` (K13c over box counts from 1 to 40000,
three IoU thresholds, tied scores, the lattice and identical boxes, bit
for bit against the plain keep mask) or ``check_bev_backward_options``
(K13b in f32, bf16 and f16 at vector widths 1 to 8 and misaligned bases,
on the trap cases, the output NaN-filled first, bit for bit against the
plain backward). The unchanged copy must pass both sweeps first, and every
faulty copy must fail its sweep with a check's AssertionError (never a
failed build). The tool prints each run's result lines and exits non-zero
otherwise. The faults:

- ``nms_next_word_or_skipped``: the scan's resolver drops the removals of
  word w + 1 by word w's kept boxes (the OR it carries in a register);
- ``nms_ring_refilled_early``: the background warps free a ring slot as
  soon as its chunk lands, before reading it, so the producer refills it
  up to a stage early (the resolver's release still paces it, so the
  barriers keep their phases and the scan cannot hang);
- ``bev_gap_rows_unwritten``: K13b stores only the rows that take a cell's
  gradient, leaving gaps, dropped intervals and the ends unwritten;
- ``bev_search_off_by_one``: K13b's search lands one interval past the
  first that starts at or after a warp's first point.
"""

from __future__ import annotations

import shutil
import sys

from conch_tpu_torch.tools.attention_mutants import BUILD_DIR, PACKAGE_DIR, copy_package, run_phases

NMS, BEV = "check_nms_options", "check_bev_backward_options"
VISION_SOURCES = ("nms.cu", "bev_pool.cu")
BACKGROUND_RELEASE = (
    "      __syncwarp();\n      if (lane == 0) mbar_arrive(empty + 8 * s);\n    }\n    mbar_arrive(done_bar"
)
BACKGROUND_CHUNK = "      const uint64_t* chunk = ring + static_cast<int64_t>(s) * stage_words;\n"
# name -> (source under csrc/, [(text, faulty text), ...], the chip_smoke sweep that must catch it)
MUTANTS = {
    "nms_next_word_or_skipped": (
        "nms.cu", [("uint64_t rem = removed[w] | next_removed | ~live;", "uint64_t rem = removed[w] | ~live;")], NMS,
    ),
    "nms_ring_refilled_early": (
        "nms.cu", [(BACKGROUND_CHUNK, "      if (lane == 0) mbar_arrive(empty + 8 * s);\n" + BACKGROUND_CHUNK),
                   (BACKGROUND_RELEASE, "      __syncwarp();\n    }\n    mbar_arrive(done_bar")], NMS,
    ),
    "bev_gap_rows_unwritten": (
        "bev_pool.cu", [("    __stcs(dst + v, x);", "    if (row >= 0) __stcs(dst + v, x);")], BEV,
    ),
    "bev_search_off_by_one": ("bev_pool.cu", [("      lo += f * step;", "      lo += f * step + 1;")], BEV),
}


def copy_vision(name: str, mutant: tuple | None):
    """The package copied with only the vision kernels' sources, the fault put in."""
    root = copy_package(name, None)
    csrc = root / PACKAGE_DIR.name / "csrc"
    for source in csrc.glob("*.cu"):
        if source.name not in VISION_SOURCES:
            source.unlink()
    if mutant is not None:
        source, edits, _ = mutant
        code = (csrc / source).read_text()
        for text, faulty in edits:
            if code.count(text) != 1:
                msg = f"{name}: the text to change is not in {source} exactly once"
                raise RuntimeError(msg)
            code = code.replace(text, faulty)
        (csrc / source).write_text(code)
    return root


def phases_script(*checks: str) -> str:
    calls = "".join(f"chip_smoke.{c}(gen, np.random.default_rng(chip_smoke.SEED))\n" for c in checks)
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
        checks = tuple(dict.fromkeys(m[2] for m in chosen.values())) if mutant is None else (mutant[2],)
        code, out = run_phases(copy_vision(name, mutant), phases_script(*checks))
        lines = [ln for ln in out.splitlines() if "package:" in ln or "options" in ln or "Error" in ln]
        # A faulty copy must fail its sweep, not its build.
        failed_sweep = code != 0 and "nvcc failed" not in out and "AssertionError" in out
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
