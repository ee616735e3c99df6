# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""What K1b's per-group fold and its launch plan cost at a 512-row prefill step.

    python3 -m conch_tpu_torch.tools.k1b_prefill_fold

Run from the checkout's root on one Hopper card. K1b (``csrc/mixed_gemm_
planar.cu``) adds each group's product into its accumulators with
``acc += (part - z * sum) * s`` once the group's last wgmma has completed,
and the next group's first wgmma overwrites ``part``: the fold sits
between the two on every warp. The tool times the int8 engine's four fused
(K, N) at M = 512 (group 128, bf16 scales, weights walked over a 32-layer
stack) in three copies of the package under ``conch_tpu_torch/_build/
mutants/``, each in a subprocess that builds its kernels:

- ``unchanged``: the kernels as they are, with three launch plans: the
  wrappers' own (128 rows a block, the x row-sum pre-pass), 64 rows a
  block (no pre-pass: each block sums its x rows), and 128 rows with K
  split in two;
- ``fold_add``: K1b's fold reduced to ``acc += part`` (its outputs are
  wrong: a timing, not a kernel). The wait for the group's last wgmma and
  the hand-over of ``part`` stay; the scale, zero-point and row-sum
  arithmetic goes. (Dropping the fold altogether measures nothing: ptxas
  then removes the wgmmas, whose results nothing reads.)
- ``staggered``: the mainloop with warpgroup 0 issuing a slice's wgmmas
  before the block's barrier and warpgroup 1 after it, so that the tensor
  cores could take one warpgroup's wgmmas while the other folds; K1b and
  K1c.

Beside them: K1c (NF4 rows at group 64, no fold: the scale is applied
before the product) on the same four shapes, unchanged and staggered, and
``torch.matmul`` on the bf16 weight. Prints each shape's device time, one layer's sums, and the
registers ptxas gave K1b's 128-row template in each copy.
"""

from __future__ import annotations

import shutil
import sys

from conch_tpu_torch.tools.attention_mutants import BUILD_DIR, copy_package, run_phases

FOLD_ADD = (
    "mixed_gemm_planar.cu",
    "        acc[4 * j + e] += (st.part[4 * j + e] - fr.z[e >> 1] * sum) * fr.s[e >> 1];",
    "        acc[4 * j + e] += st.part[4 * j + e];",
)
STAGGERED = (
    "quant_gemm_mainloop.cuh",
    "    lay.template mma<BN>(cur, state, acc, stage_at<L, BN>(stage(s)));\n"
    "    if (s + 1 < s1) {\n"
    "      __syncthreads();  // every thread is done with slice s - 1\n",
    "    const bool leads = threadIdx.x < kThreads / 2;\n"
    "    if (leads) lay.template mma<BN>(cur, state, acc, stage_at<L, BN>(stage(s)));\n"
    "    __syncthreads();\n"
    "    if (!leads) lay.template mma<BN>(cur, state, acc, stage_at<L, BN>(stage(s)));\n"
    "    if (s + 1 < s1) {\n",
)

TIMINGS = '''
import dataclasses, itertools, json, torch, chip_smoke as cs, conch_tpu_torch
import conch_tpu_torch.kernels.quantization.gemm as g
from conch_tpu_torch.kernels.quantization.bitsandbytes.blockwise import NF4_CODE
print("package:", conch_tpu_torch.__file__, flush=True)
cs.build()
gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
own_plan = g.quant_gemm_plan

def plan_with(bn=None, splits=None):
    def plan(layout, m, n, k, bits, group, sms):
        p = own_plan(layout, m, n, k, bits, group, sms)
        if layout != "planar":
            return p
        bn_ = bn or p.bn
        s = splits or p.splits
        return dataclasses.replace(p, bn=bn_, splits=s, grid=(p.grid[0], -(-m // bn_), s), row_sums=bn_ == 128)
    return plan

m, sums = 512, {}
plans = {"own plan": own_plan, "64 rows a block": plan_with(bn=64), "K split in two": plan_with(splits=2)}
for (k, n) in cs.FUSED_LAYER_SHAPES:
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    packed = torch.randint(-(2**31), 2**31 - 1, (cs.NUM_LAYERS_POOL, k // 4, n), generator=gen, device="cuda",
                           dtype=torch.int32)
    scales = (torch.rand((cs.NUM_LAYERS_POOL, k // 128, n), generator=gen, device="cuda") * 4e-3 + 1e-4).to(
        torch.bfloat16)
    for label, plan in plans.items():
        if MODE != "unchanged" and label != "own plan":
            continue
        g.quant_gemm_plan = plan
        cyc = itertools.cycle(range(cs.NUM_LAYERS_POOL))
        ms = cs.time_ms(lambda: g.mixed_gemm_planar_launcher(x, packed, scales, None, 8, 128, 128, next(cyc)))
        g.quant_gemm_plan = own_plan
        sums[f"K1b {label}"] = sums.get(f"K1b {label}", 0.0) + ms
        print(f"{MODE} K1b {label} M={m} K={k} N={n}: {ms:.4f} ms", flush=True)
    del packed, scales
    if MODE != "fold_add":
        nf4 = torch.randint(-(2**31), 2**31 - 1, (cs.NUM_LAYERS_POOL, k // 8, n), generator=gen, device="cuda",
                            dtype=torch.int32)
        absmax = torch.rand((cs.NUM_LAYERS_POOL, k // 64, n), generator=gen, device="cuda") * 0.09 + 0.01
        cyc = itertools.cycle(range(cs.NUM_LAYERS_POOL))
        ms = cs.time_ms(lambda: g.mixed_gemm_rows_launcher(x, nf4, absmax, None, 4, 0, 64, NF4_CODE, next(cyc)))
        sums["K1c nf4"] = sums.get("K1c nf4", 0.0) + ms
        print(f"{MODE} K1c nf4 M={m} K={k} N={n}: {ms:.4f} ms", flush=True)
        del nf4, absmax
    if MODE == "unchanged":
        dense = torch.randn((k, n), generator=gen, device="cuda").to(torch.bfloat16)
        ms = cs.time_ms(lambda: torch.matmul(x, dense))
        sums["torch.matmul"] = sums.get("torch.matmul", 0.0) + ms
        print(f"{MODE} torch.matmul M={m} K={k} N={n}: {ms:.4f} ms", flush=True)
        del dense
    torch.cuda.empty_cache()
print(cs.card_line(), flush=True)
print("one layer at M=512:", json.dumps({MODE: sums}), flush=True)
'''


def main() -> int:
    ok = True
    for name, mutant in (("unchanged", None), ("fold_add", FOLD_ADD), ("staggered", STAGGERED)):
        code, out = run_phases(copy_package(name, mutant), f"MODE = {name!r}\n" + TIMINGS)
        ok &= code == 0
        print(f"{name}: exit code {code}", flush=True)
        # The timings, the card, and the registers of K1b's template at 128
        # rows a block (wgmma's accumulators: a copy whose wgmmas were
        # dropped would show a few dozen).
        keep = (name, "package:", "one layer", "ptxas PlanarLayout<8, 1> BN 128", " W")
        lines = [ln for ln in out.splitlines() if any(tag in ln for tag in keep)]
        for line in lines if code == 0 else out.splitlines()[-40:]:
            print("   ", line, flush=True)
    shutil.rmtree(BUILD_DIR / "mutants", ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
