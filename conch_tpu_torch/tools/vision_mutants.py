# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Show that the card checks of K13c (the NMS keep mask), K13b (the BEV
pool backward) and K13a (the BEV pool forward) can fail.

    python3 -m conch_tpu_torch.tools.vision_mutants [NAME ...]

Run from the checkout's root on one Hopper card. For each fault below (or
the named ones), the tool copies the package to
``conch_tpu_torch/_build/mutants/<name>/`` with only ``csrc/nms.cu`` and
``csrc/bev_pool.cu`` (so each copy builds in seconds), puts the fault into
the copy, and runs the fault's sweep of ``chip_smoke.py`` on the copy in a
subprocess: ``check_nms_options`` (K13c over box counts from 1 to 40000,
three IoU thresholds, tied scores, the lattice and identical boxes, bit
for bit against the plain keep mask), ``check_bev_backward_options``
(K13b in f32, bf16 and f16 at vector widths 1 to 8 and misaligned bases,
on the trap cases, the output NaN-filled first, bit for bit against the
plain backward) or ``check_bev_forward_options`` (K13a likewise, on its
trap cases, no kept interval, one interval of 100,000 points and
BEVFusion's inputs). The unchanged copy must pass the sweeps first, and
every faulty copy must fail its sweep with a check's AssertionError (never
a failed build, a fault of the device or a run past its time limit). The
tool prints each run's result lines and exits non-zero otherwise. The
faults:

- ``nms_next_word_or_skipped``: the scan's resolver drops the removals of
  word w + 1 by word w's kept boxes (the OR it carries in a register);
- ``nms_ring_refilled_early``: the background warps free a ring slot as
  soon as its chunk lands, before reading it, so the producer refills it
  up to a stage early (the resolver's release still paces it, so the
  barriers keep their phases and the scan cannot hang);
- ``bev_gap_rows_unwritten``: K13b stores only the rows that take a cell's
  gradient, leaving gaps, dropped intervals and the ends unwritten;
- ``bev_search_off_by_one``: K13b's search lands one interval past the
  first that starts at or after a warp's first point (K13a's block search
  shares the code);
- ``bev_fwd_run_later_intervals_skipped``: K13a's producer emits the rows
  of a run's opening interval only, so a run's second (and later) kept
  interval is summed by no block;
- ``bev_fwd_ring_refilled_early``: K13a's producer starts a stage's row
  copies before the consumers have released its ring slot, once the
  slot's last copies have landed (the headers have a ring of their own
  and the barriers keep their order, so the phases stay in step);
- ``bev_fwd_tile_edge_run_owned_twice``: K13a's look back skipped: a block
  takes the intervals at its tile's head that continue an earlier block's
  run as a run of its own, so two blocks sum them (and it zeros the grid
  from its head);
- ``bev_fwd_tile_edge_run_cut``: K13a's blocks stop at their tile's edge,
  so a run's intervals past it are summed by neither block;
- ``bev_fwd_gap_cell_unwritten``: K13a leaves the first cell of every gap
  between runs unwritten (its NaN shows).
"""

from __future__ import annotations

import shutil
import sys

from conch_tpu_torch.tools.attention_mutants import BUILD_DIR, PACKAGE_DIR, copy_package, run_phases

NMS, BEV, BEV_FWD = "check_nms_options", "check_bev_backward_options", "check_bev_forward_options"
TIMEOUT_S = 300  # a run of the sweeps (about 100 s): a hang fails the fault's run
VISION_SOURCES = ("nms.cu", "bev_pool.cu")
BACKGROUND_RELEASE = (
    "      __syncwarp();\n      if (lane == 0) mbar_arrive(empty + 8 * s);\n    }\n    mbar_arrive(done_bar"
)
BACKGROUND_CHUNK = "      const uint64_t* chunk = ring + static_cast<int64_t>(s) * stage_words;\n"
FWD_RELEASE_WAIT = "      if (t_pub >= stages) mbar_wait(empty + 8 * s,"
FWD_EARLY_COPIES = (  # after the slot's last copies landed (its full phase), so the barriers keep their phases
    "      if (t_pub >= stages) mbar_wait(full + 8 * s, static_cast<int>((t_pub / stages - 1) & 1));\n"
    "      for (int k = 0; kTma && k < (one_span ? 1 : npieces); ++k) {\n"
    "        const FwdPiece pc = hd.piece[k];\n"
    "        const int64_t g0 = one_span ? span_begin : pc.grow, r0 = one_span ? 0 : pc.srow;\n"
    "        const int64_t n0 = one_span ? rows : pc.rows;\n"
    "        if (n0 > 0)\n"
    "          bulk_load(smem_addr(ring + s * plan.stage_bytes + r0 * row_bytes), feats + g0 * channels,\n"
    "                    static_cast<uint32_t>(n0 * row_bytes), full + 8 * s);\n"
    "      }\n"
)
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
    "bev_fwd_run_later_intervals_skipped": (
        "bev_pool.cu", [("    const bool emits = mine && kept && own && end > start;",
                         "    const bool emits = mine && kept && own && end > start && run_start;")], BEV_FWD,
    ),
    "bev_fwd_ring_refilled_early": (
        "bev_pool.cu", [(FWD_RELEASE_WAIT, FWD_EARLY_COPIES + FWD_RELEASE_WAIT),
                        ("      if (one_span) {", "      if (one_span && rows < 0) {"),
                        ("        for (int k = lane; k < npieces; k += 32) {", "        for (int k = lane; k < 0; k += 32) {")],
        BEV_FWD,
    ),
    "bev_fwd_tile_edge_run_owned_twice": (
        "bev_pool.cu", [("  for (int64_t base = first - 1; base >= 0; base -= 32) {",
                         "  for (int64_t base = first - 1; base >= 0 && ni < 0; base -= 32) {")], BEV_FWD,
    ),
    "bev_fwd_tile_edge_run_cut": (
        "bev_pool.cu", [("!valid || (!in_tile && !own)", "!valid || !in_tile")], BEV_FWD,
    ),
    "bev_fwd_gap_cell_unwritten": (
        "bev_pool.cu", [("zero_later(opens && cell > prev + 1, prev + 1, cell);",
                         "zero_later(opens && cell > prev + 1, prev + 2, cell);")], BEV_FWD,
    ),
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
        code, out = run_phases(copy_vision(name, mutant), phases_script(*checks), TIMEOUT_S)
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
