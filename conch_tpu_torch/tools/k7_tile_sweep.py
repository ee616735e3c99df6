# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Time K7 (``csrc/varlen_attention.cu``) at other split counts and block
shapes on the card.

    python3 -m conch_tpu_torch.tools.k7_tile_sweep

Run from the checkout's root on one Hopper card. For each variant below the
tool copies the package to ``conch_tpu_torch/_build/k7_variants/<name>/``,
edits the copy's kernel constants (and the wrapper's matching plan
constants), keeps only K7's source, and runs, in a subprocess that builds
it, K7 on ``chip_smoke.py``'s ``K7_CASES`` as its ``k7_inputs`` builds them
(Llama-3-8B's 128-row step; Gemma-2-2B's 512-row step, softcap 50, without
and with the 4096 window, over bf16 and int8 pools): each checked against
the plain version (2e-2 + 2e-2 x |ref|; not the "no copies" variant, which
times the arithmetic on stale tiles), timed with the wrapper's own plan
and with the split count forced to each of ``SPLIT_COUNTS``, and profiled
once (device time of the tile kernel and of the merge, from
``torch.profiler``). Prints one line per (variant, case) and a JSON line
with every number.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from conch_tpu_torch.tools.attention_mutants import BUILD_DIR, PACKAGE_DIR, REPO_ROOT

KERNEL = "csrc/varlen_attention.cu"
WRAPPER = "kernels/attention/varlen_attention.py"
SOURCES = ("varlen_attention.cu",)
# name -> edits (file under the package, text, replacement)
VARIANTS = {
    "as built": (),
    "8 warps, 3 stages": (
        (KERNEL, "constexpr int kThreads = 128;", "constexpr int kThreads = 256;"),
        (KERNEL, "constexpr int kRows = 64;", "constexpr int kRows = 128;"),
        (KERNEL, "constexpr int kStages = 2;", "constexpr int kStages = 3;"),
        (KERNEL, "constexpr int kBlocksPerSm = 2;", "constexpr int kBlocksPerSm = 1;"),
        (WRAPPER, "TILE_MMA_ROWS = 64", "TILE_MMA_ROWS = 128"),
        (WRAPPER, "BLOCKS_PER_SM = 2", "BLOCKS_PER_SM = 1"),
    ),
    "3 stages": ((KERNEL, "constexpr int kStages = 2;", "constexpr int kStages = 3;"),),
    "tanh from an exp2": ((KERNEL, "cap_log2 * tanhf(x * scale_cap)",
                           "cap_log2 * (1.0f - __fdividef(2.0f, exp2f(2.0f * kLog2e * x * scale_cap) + 1.0f))"),),
    "no copies": ((KERNEL, "    issue(i + kStages - 1, next_page);", "    cp_async_commit();"),),
}
SPLIT_COUNTS = (1, 4, 16)

RUN = r'''
import dataclasses, json
import numpy as np, torch
import chip_smoke as cs
import conch_tpu_torch.kernels.attention.varlen_attention as va
from conch_tpu_torch.kernels.common import BUILD_DIR, kernel_library
from torch.profiler import ProfilerActivity, profile

CHECK = CHECK_FLAG
kernel_library()
gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
rng = np.random.default_rng(cs.SEED)
planner = va.varlen_tile_plan
result = {}
for name, cache in [(n, None) for n in cs.K7_CASES] + [("gemma2 table line", "int8")]:
    case = cs.k7_inputs(gen, rng, name, cache)
    launch = cs.with_kv_scales(va.varlen_attention_launcher, cache)
    plain = cs.with_kv_scales(va.varlen_attention_plain, cache)
    for w in case["windows"]:
        args = (*case["args"], w)
        if CHECK:
            got, ref = launch(*args).float(), plain(*args).float()
            if not bool(((got - ref).abs() <= 2e-2 + 2e-2 * ref.abs()).all()):
                raise AssertionError(f"{name} {cache} window {w}: outside 2e-2 + 2e-2 x |ref|")
        plan = planner(args[0].shape[0], len(case["seq_lens"]), case["bt"].shape[1], cs.PS, *case["shape"][:2],
                       case["shape"][2], True, w, torch.cuda.get_device_properties(0).multi_processor_count)
        entry = {"plan": [plan.splits, plan.split_len], "ms": cs.time_ms(lambda: launch(*args))}
        for count in SPLIT_COUNTS:
            span = plan.splits * plan.split_len
            length = cs.math.ceil(cs.math.ceil(span / count) / plan.kv_tile) * plan.kv_tile
            forced = dataclasses.replace(plan, split_len=length, splits=-(-span // length))
            va.varlen_tile_plan = lambda *a, forced=forced: forced
            entry[f"splits {forced.splits}"] = cs.time_ms(lambda: launch(*args))
            va.varlen_tile_plan = planner
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                launch(*args)
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            for kernel in ("varlen_tile", "varlen_merge"):
                if kernel in ev.key:
                    total = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
                    entry[f"{kernel} ms"] = total / max(ev.count, 1) / 1e3
        key = f"{name} {cache or 'bf16'} window {w}"
        result[key] = entry
        print("CASE " + json.dumps({key: entry}), flush=True)
    del case
    torch.cuda.empty_cache()
# ptxas's report of the tile kernels (registers, spills).
entry, report = None, []
for ln in (BUILD_DIR / "nvcc.log").read_text().splitlines():
    if "Compiling entry function" in ln:
        entry = next((t for t in ("__nv_bfloat16Li256", "__nv_bfloat16Li128", "aLi256") if
                      "varlen_tile_kernel" in ln and t in ln), None)
    elif entry and ("spill" in ln or "Used" in ln):
        report.append(f"{entry}: {ln.strip()}")
result["ptxas"] = report
print("RESULT " + json.dumps(result), flush=True)
'''.replace("SPLIT_COUNTS", repr(SPLIT_COUNTS))


def main() -> int:
    results = {}
    for name, edits in VARIANTS.items():
        root = BUILD_DIR / "k7_variants" / name.replace(" ", "_").replace(",", "")
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(PACKAGE_DIR, root / PACKAGE_DIR.name, ignore=shutil.ignore_patterns("_build", "__pycache__"))
        for source in (root / PACKAGE_DIR.name / "csrc").glob("*.cu"):
            if source.name not in SOURCES:
                source.unlink()
        for file, text, new in edits:
            path = root / PACKAGE_DIR.name / file
            code = path.read_text()
            if code.count(text) != 1:
                raise RuntimeError(f"{name}: {text!r} is not in {file} exactly once")
            path.write_text(code.replace(text, new))
        env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(root), str(REPO_ROOT)])}
        script = RUN.replace("CHECK_FLAG", repr(name != "no copies"))
        proc = subprocess.run([sys.executable, "-c", script], cwd=root, env=env, capture_output=True, text=True,
                              check=False)
        line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")), None)
        if proc.returncode != 0 or line is None:
            print(f"{name}: failed (exit code {proc.returncode})\n{proc.stdout[-4000:]}{proc.stderr[-3000:]}", flush=True)
            continue
        results[name] = json.loads(line[len("RESULT "):])
        print(f"{name} | ptxas: " + "; ".join(results[name].pop("ptxas")), flush=True)
        for shape, entry in results[name].items():
            print(f"{name} | {shape}: " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in entry.items()), flush=True)
    shutil.rmtree(BUILD_DIR / "k7_variants", ignore_errors=True)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
