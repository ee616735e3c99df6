# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Time K11 (``csrc/mla_attention.cu``) at other split counts and with the
design choices it dropped, on the card.

    python3 -m conch_tpu_torch.tools.k11_tile_sweep

Run from the checkout's root on one Hopper card. For each variant below the
tool copies the package to ``conch_tpu_torch/_build/k11_variants/<name>/``,
edits the copy's kernel (and the wrapper's plan constants), keeps only
K11's source, and runs, in a subprocess that builds it, K11 on
``chip_smoke.py``'s ``k11_inputs`` (DeepSeek-V2-Lite's decode step of batch
8 to 4000 tokens and its 512-row prefill step, bf16 queries over bf16 and
int8 pools): each checked against the plain version (``K11_TOLERANCES``),
timed with the wrapper's own plan and with the split count forced to each
of ``SPLIT_COUNTS``, and profiled once (device time of the split kernel
and of the merge, from ``torch.profiler``). Prints one line per (variant,
case) and a JSON line with every number. The variants:

- ``as built``;
- ``2 stages``: a ring of two 32-key stages (three fit beside the Q tile
  at packed 640; four would not);
- ``16-key stages``: stages of 16 keys (m64n16 score products, one k16 step
  of PV a stage), four of them;
- ``scores by mma.sync``: each consumer warp computes its own 16 rows' scores
  with ``mma.sync`` m16n8k16 (operands by ``ldmatrix`` from the swizzled
  tiles), and warps whose rows lie past the tile skip them: at decode, 16
  live rows of 64, one warp of each consumer does the work that a
  ``wgmma`` of 64 rows does; PV stays on ``wgmma``;
- ``no PV product``, ``no score product``, ``no copies``: diagnostics, each
  with one part of the work taken out (their outputs are wrong and not
  checked), to show which part sets a stage's pace.
A key tile of 64 does not fit: Q (80 KB at packed 640) and two 64-key
stages (80 KB each) exceed the 227 KB a block may use.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from conch_tpu_torch.tools.attention_mutants import BUILD_DIR, PACKAGE_DIR, REPO_ROOT

KERNEL = "csrc/mla_attention.cu"
WRAPPER = "kernels/attention/mla_attention.py"
SOURCES = ("mla_attention.cu",)
WGMMA_SCORES = """    fence_operands(s);
    wgmma_fence();
    for (int c = 0; c < chunks; ++c) {  // 64-column chunks, four k16 steps each
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wgmma_ss<kKeys>(s, desc_sw128(q_addr + c * kQChunkBytes + 32 * k),
                        desc_sw128(k_addr + c * kKChunkBytes + 32 * k), c > 0 || k > 0);
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_operands(s);"""
MMA_SYNC_SCORES = """    if (warp * 16 < t.rows) {
      for (int c = 0; c < chunks; ++c) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          uint32_t a[4];
          ldmatrix_x4(a, smem + c * kQChunkBytes +
                             swizzled(warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1), 2 * k + (lane >> 4)));
#pragma unroll
          for (int np = 0; np < kKeys / 16; ++np) {
            uint32_t b[4];
            ldmatrix_x4(b, smem + q_bytes + st * stage_bytes + c * kKChunkBytes +
                               swizzled(16 * np + 8 * (lane >> 4) + (lane & 7), 2 * k + ((lane >> 3) & 1)));
            mma_bf16_16816(*reinterpret_cast<float(*)[4]>(&s[8 * np]), a[0], a[1], a[2], a[3], b[0], b[1]);
            mma_bf16_16816(*reinterpret_cast<float(*)[4]>(&s[8 * np + 4]), a[0], a[1], a[2], a[3], b[2], b[3]);
          }
        }
      }
    }"""
# name -> edits (file under the package, text, replacement)
VARIANTS = {
    "as built": (),
    "2 stages": ((WRAPPER, "MAX_STAGES = 4", "MAX_STAGES = 2"),),
    "16-key stages": (
        (KERNEL, "constexpr int kKeys = 32; ", "constexpr int kKeys = 16; "),
        (WRAPPER, "KV_TILE = 32", "KV_TILE = 16"),
    ),
    "scores by mma.sync": ((KERNEL, WGMMA_SCORES, MMA_SYNC_SCORES),),
    "no PV product": (
        (KERNEL, "wgmma_rs_n64_t(o[c], a[kk], desc_mn_sw128(k_addr + (cw * NC + c) * kKChunkBytes + kk * 2048));", ""),
    ),
    "no score product": ((KERNEL, """        wgmma_ss<kKeys>(s, desc_sw128(q_addr + c * kQChunkBytes + 32 * k),
                        desc_sw128(k_addr + c * kKChunkBytes + 32 * k), c > 0 || k > 0);""", ""),),
    "no copies": ((KERNEL, "      copy_stage(p, smem, q_bytes + st * stage_bytes, rows, tid);", ""),),
}
UNCHECKED = ("no PV product", "no score product", "no copies")
SPLIT_COUNTS = {"decode": (1, 4, 8, 16, 64), "prefill": (1, 2, 6, 12)}

RUN = r'''
import dataclasses, json, math
import numpy as np, torch
import chip_smoke as cs
import conch_tpu_torch.kernels.attention.mla_attention as mla
from conch_tpu_torch.kernels.common import BUILD_DIR, kernel_library
from torch.profiler import ProfilerActivity, profile

CHECK = CHECK_FLAG
kernel_library()
gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
rng = np.random.default_rng(cs.SEED)
planner = mla.mla_tile_plan
result = {}
for cache in (None, "int8"):
    inputs = cs.k11_inputs(gen, rng, cache)
    for case in inputs["cases"]:
        args, kw = cs.k11_args(inputs, case, torch.bfloat16)
        launch = lambda: mla.mla_attention_launcher(*args, **kw)
        got, ref = launch().float(), mla.mla_attention_plain(*args, **kw).float()
        tol = cs.K11_TOLERANCES[torch.bfloat16]
        if CHECK and not bool(((got - ref).abs() <= tol + tol * ref.abs()).all()):
            raise AssertionError(f"{case} {cache}: outside the K11 tolerance")
        q, layer, _, _, _, bt = args
        plan = planner(q.shape[0], bt.shape[0], bt.shape[1], layer.shape[1], q.shape[1], q.shape[2], cs.DS_LATENT,
                       True, torch.cuda.get_device_properties(0).multi_processor_count)
        entry = {"plan": [plan.splits, plan.split_len, plan.stages], "ms": cs.time_ms(launch)}
        span = plan.splits * plan.split_len
        for count in SPLIT_COUNTS[case]:
            length = math.ceil(math.ceil(span / count) / plan.kv_tile) * plan.kv_tile
            forced = dataclasses.replace(plan, split_len=length, splits=-(-span // length))
            mla.mla_tile_plan = lambda *a, forced=forced: forced
            entry[f"splits {forced.splits}"] = cs.time_ms(launch)
            mla.mla_tile_plan = planner
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                launch()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            for kernel in ("mla_wgmma", "mla_merge"):
                if kernel in ev.key:
                    total = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
                    entry[f"{kernel} ms"] = total / max(ev.count, 1) / 1e3
        key = f"{case} {cache or 'bf16'}"
        result[key] = entry
        print("CASE " + json.dumps({key: entry}), flush=True)
    del inputs
    torch.cuda.empty_cache()
# ptxas's report of the wgmma kernels (registers, spills, serialization).
entry, report = None, []
for ln in (BUILD_DIR / "nvcc.log").read_text().splitlines():
    if "Compiling entry function" in ln:
        entry = "latent 512" if "mla_wgmma_kernelILi4" in ln else None
    elif entry and ("spill" in ln or "Used" in ln):
        report.append(f"{entry}: {ln.strip()}")
    elif "C7515" in ln or "C7510" in ln:
        report.append(ln.strip()[:160])
result["ptxas"] = report
print("RESULT " + json.dumps(result), flush=True)
'''.replace("SPLIT_COUNTS", repr(SPLIT_COUNTS))


def main() -> int:
    results = {}
    names = sys.argv[1:] or list(VARIANTS)
    for name in names:
        root = BUILD_DIR / "k11_variants" / name.replace(" ", "_").replace(".", "_")
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(PACKAGE_DIR, root / PACKAGE_DIR.name, ignore=shutil.ignore_patterns("_build", "__pycache__"))
        for source in (root / PACKAGE_DIR.name / "csrc").glob("*.cu"):
            if source.name not in SOURCES:
                source.unlink()
        for file, text, new in VARIANTS[name]:
            path = root / PACKAGE_DIR.name / file
            code = path.read_text()
            if code.count(text) != 1:
                raise RuntimeError(f"{name}: {text[:60]!r} is not in {file} exactly once")
            path.write_text(code.replace(text, new))
        env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(root), str(REPO_ROOT)])}
        script = RUN.replace("CHECK_FLAG", repr(name not in UNCHECKED))
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
    shutil.rmtree(BUILD_DIR / "k11_variants", ignore_errors=True)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
