# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Time K3 (``csrc/paged_attention.cuh``) at other split lengths and block
shapes on the card.

    python3 -m conch_tpu_torch.tools.k3_split_sweep

Run from the checkout's root on one Hopper card. For each variant below the
tool copies the package to ``conch_tpu_torch/_build/k3_variants/<name>/``,
edits the copy's kernel constants, and runs, in a subprocess that builds
the copy's kernels, K3 on ``chip_smoke.py``'s ``K3_CASES`` as its
``k3_inputs`` builds them (the kernel table's lines and the served decode
steps, Gemma's without and with the 4096 window): each checked against the plain version (3e-2), timed with
the wrapper's own plan and with the split length forced to each of
``SPLIT_LENGTHS``, and profiled once (device time of the split kernel and
of the merge, from ``torch.profiler``). Prints one line per (variant,
shape) and a JSON line with every number.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from conch_tpu_torch.tools.attention_mutants import BUILD_DIR, PACKAGE_DIR, REPO_ROOT

# name -> edits (text, replacement) of csrc/paged_attention.cuh
VARIANTS = {
    "as built": (),
    "4 stages": (("constexpr int kStages = 3;", "constexpr int kStages = 4;"),),
    "tile 64": (("constexpr int kTile = 32;", "constexpr int kTile = 64;"),),
    "128 threads": (("constexpr int kThreads = 256;", "constexpr int kThreads = 128;"),),
}
SPLIT_LENGTHS = (64, 128, 512)

RUN = r'''
import json
import numpy as np, torch
import chip_smoke as cs
import conch_tpu_torch.kernels.attention.paged_attention as pa
from conch_tpu_torch.kernels.common import BUILD_DIR, kernel_library
from torch.profiler import ProfilerActivity, profile

kernel_library()
gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
rng = np.random.default_rng(cs.SEED)
planner = pa.paged_split_plan
result = {}

sms = torch.cuda.get_device_properties(0).multi_processor_count
for name in cs.K3_CASES:
    case = cs.k3_inputs(gen, rng, name)
    kc, bt, sl = case["args"][1], case["args"][3], case["args"][4]
    kh, max_pages = kc.shape[2], bt.shape[1]
    for w in case["windows"]:
        args = (*case["args"], w)
        err = (pa.paged_attention_launcher(*args).float() - pa.paged_attention_plain(*args).float()).abs().max().item()
        if not err <= 3e-2:
            raise AssertionError(f"{name} window {w}: max_abs_err {err}")
        plan = planner(sl, bt, cs.PS, kh, w, sms)
        entry = {"plan": [plan.splits, plan.split_len], "ms": cs.time_ms(lambda: pa.paged_attention_launcher(*args))}
        for length in SPLIT_LENGTHS:
            forced = pa.PagedSplitPlan(-(-min(max_pages * cs.PS, w or 1 << 30) // length), length)
            pa.paged_split_plan = lambda *a, forced=forced: forced
            entry[f"split {length}"] = cs.time_ms(lambda: pa.paged_attention_launcher(*args))
            pa.paged_split_plan = planner
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                pa.paged_attention_launcher(*args)
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            for kernel in ("paged_split", "paged_merge"):
                if kernel in ev.key:
                    total = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
                    entry[f"{kernel} ms"] = total / max(ev.count, 1) / 1e3
        result[f"{name} window {w}"] = entry
        print("CASE " + json.dumps({f"{name} window {w}": entry}), flush=True)
    del case
# ptxas's report of the bf16 split kernels (registers, spills).
entry, report = None, []
for ln in (BUILD_DIR / "nvcc.log").read_text().splitlines():
    if "Compiling entry function" in ln:
        entry = "softcap" if "paged_split_kernelI13__nv_bfloat16S2_Lb1" in ln else (
            "plain" if "paged_split_kernelI13__nv_bfloat16S2_Lb0" in ln else None)
    elif entry and ("spill" in ln or "Used" in ln):
        report.append(f"{entry}: {ln.strip()}")
result["ptxas"] = report
print("RESULT " + json.dumps(result), flush=True)
'''.replace("SPLIT_LENGTHS", repr(SPLIT_LENGTHS))


def main() -> int:
    results = {}
    for name, edits in VARIANTS.items():
        root = BUILD_DIR / "k3_variants" / name.replace(" ", "_").replace(",", "")
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(PACKAGE_DIR, root / PACKAGE_DIR.name, ignore=shutil.ignore_patterns("_build", "__pycache__"))
        source = root / PACKAGE_DIR.name / "csrc" / "paged_attention.cuh"
        code = source.read_text()
        for text, new in edits:
            if code.count(text) != 1:
                raise RuntimeError(f"{name}: {text!r} is not in paged_attention.cuh exactly once")
            code = code.replace(text, new)
        source.write_text(code)
        env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(root), str(REPO_ROOT)])}
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=root, env=env, capture_output=True, text=True,
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
    shutil.rmtree(BUILD_DIR / "k3_variants", ignore_errors=True)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
