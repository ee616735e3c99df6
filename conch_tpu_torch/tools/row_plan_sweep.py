# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Time K5 (RoPE) and K10a (Gemma RMS norm) at other launch plans than
their plans pick.

    python3 -m conch_tpu_torch.tools.row_plan_sweep

Run from the checkout's root on one Hopper card. At the served shapes (K5:
Llama-3-8B's QH 32 / KH 8 / D 128 at 8, 32 and 512 tokens and Gemma-2-2B's
8 / 4 / 256 at 8, 16 and 512, on slices of the fused qkv product; K10a:
Gemma-2-2B's hidden 2304 at 8, 16 and 512 rows, bf16) the tool swaps the
module's plan function (``rope_plan``, ``gemma_norm_plan``) for one that
returns the plan with one field forced (K5: heads a block; K10a: threads a
row, with the vectors a thread that follow), and times the kernel back to
back (``chip_smoke.time_ms``) and after its served predecessor, a bf16
``torch.matmul`` (the pair's time minus the predecessor's, PAIR_ITERS
launches each), with the programmatic-dependent launch. The plan's own
choice is the line marked "plan". Prints one line per case and a JSON line.

    python3 -m conch_tpu_torch.tools.row_plan_sweep --diagnostics [--parent DIR]

times K10a at 16 and 512 rows (bf16, 2304) without the programmatic-
dependent launch (and back to back with it) in copies of the package (only the two row kernels'
sources, built in a subprocess each, as ``row_mutants`` builds them): the
kernel as it is, without the barrier of its cross-warp sum (the sum races:
a diagnostic of time only), without its weight loads (w taken as 0), with
them issued before ``griddepcontrol.wait`` and x's after (the first
design), and, with ``--parent``, another checkout's kernel.
Each copy is timed back to back and after a 64 MiB ``zero_()`` that evicts
the L2 cache (the pair minus the ``zero_()``), as a served step finds
its weights.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from conch_tpu_torch.kernels.common import cdiv
from conch_tpu_torch.kernels.embedding import rotary_embedding as rope_module
from conch_tpu_torch.kernels.normalization import gemma_rms_norm as norm_module
from conch_tpu_torch.reference.embedding.rotary_embedding import compute_cos_sin_cache

ROPE_SHAPES = {"llama3_8b": (cs.QH, cs.KH, cs.D, (8, 32, 512)), "gemma2_2b": (cs.G_QH, cs.G_KH, cs.G_D, (8, 16, 512))}
ROPE_HEADS_A_BLOCK = (1, 2, 4, 8, 16, 32)
NORM_ROWS = (8, 16, 512)
NORM_THREADS_A_ROW = (96, 160, 288)


def timed(kernel, pred) -> dict:
    """``kernel`` back to back, and after ``pred`` (the pair minus ``pred``)."""
    out = pred()
    pred_ms = cs.time_ms(pred, iters=cs.PAIR_ITERS)
    pair_ms = cs.time_ms(lambda: kernel(pred()), iters=cs.PAIR_ITERS)
    return {"alone_ms": cs.time_ms(lambda: kernel(out), iters=cs.PAIR_ITERS), "after_pred_ms": pair_ms - pred_ms}


def with_plan(module, name: str, change):
    """Run the module's plan function, then ``change`` on its plan, until restored."""
    original = getattr(module, name)
    setattr(module, name, lambda *args: change(original(*args)))
    return original


K10A_LOADS = """    griddep_wait();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = lane + k * tpr;
      if (live && k < p.items && j < nvec) {
        xv[k] = Vx::load(xr + j * V);
        wv[k] = Vx::load(w + j * V);
      }
    }
"""
K10A_LOADS_BEFORE_THE_WAIT = """#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = lane + k * tpr;
      if (k < p.items && j < nvec) wv[k] = Vx::load(w + j * V);
    }
    griddep_wait();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = lane + k * tpr;
      if (live && k < p.items && j < nvec) xv[k] = Vx::load(xr + j * V);
    }
"""
# name -> the change to csrc/gemma_rms_norm.cu (None: the kernel as it is)
DIAGNOSTICS = {
    "as is": None,
    "no barrier": ("csrc/gemma_rms_norm.cu", "  __syncthreads();\n  float total = 0.0f;", "  float total = 0.0f;"),
    "no weight loads": ("csrc/gemma_rms_norm.cu", "wv[k] = Vx::load(w + j * V);", "wv[k] = typename Vx::Raw{};"),
    "weight loaded before the wait": ("csrc/gemma_rms_norm.cu", K10A_LOADS, K10A_LOADS_BEFORE_THE_WAIT),
}
DIAGNOSTIC_RUN = r'''
import json, torch, chip_smoke as cs
from conch_tpu_torch.kernels.normalization.gemma_rms_norm import gemma_rms_norm_launcher as norm
cs.build()
norm.pdl = False
gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
w = (0.5 * torch.randn((cs.G_HIDDEN,), generator=gen, device="cuda")).to(torch.bfloat16)
scrub = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
times = {}
for rows in (16, 512):
    x = torch.randn((rows, cs.G_HIDDEN), generator=gen, device="cuda").to(torch.bfloat16)
    times[f"rows={rows} back to back"] = cs.time_ms(lambda: norm(x, w, 1e-6), iters=cs.PAIR_ITERS)
    norm.pdl = True
    times[f"rows={rows} back to back with PDL"] = cs.time_ms(lambda: norm(x, w, 1e-6), iters=cs.PAIR_ITERS)
    norm.pdl = False
    times[f"rows={rows} after the L2 eviction"] = (cs.time_ms(lambda: (scrub.zero_(), norm(x, w, 1e-6)), iters=50)
                                                   - cs.time_ms(scrub.zero_, iters=50))
print("DIAG " + json.dumps(times), flush=True)
'''


def diagnostics() -> int:
    """K10a's copies (DIAGNOSTICS), each built and timed in a subprocess."""
    from conch_tpu_torch.tools.attention_mutants import BUILD_DIR, PACKAGE_DIR, run_phases
    from conch_tpu_torch.tools.row_mutants import ROW_SOURCES, copy_rows

    roots = {name: copy_rows(name.replace(" ", "_"), change) for name, change in DIAGNOSTICS.items()}
    if "--parent" in sys.argv:
        parent = roots["parent"] = BUILD_DIR / "mutants" / "parent"
        shutil.rmtree(parent, ignore_errors=True)
        source = Path(sys.argv[sys.argv.index("--parent") + 1]) / PACKAGE_DIR.name
        shutil.copytree(source, parent / PACKAGE_DIR.name, ignore=shutil.ignore_patterns("_build", "__pycache__"))
        for cu in (parent / PACKAGE_DIR.name / "csrc").glob("*.cu"):
            if cu.name not in ROW_SOURCES:
                cu.unlink()
    results = {}
    for name, root in roots.items():
        code, out = run_phases(root, DIAGNOSTIC_RUN)
        line = next((ln for ln in out.splitlines() if ln.startswith("DIAG ")), None)
        if code != 0 or line is None:
            print(f"{name}: exit code {code}\n{out[-3000:]}", flush=True)
            return 1
        results[name] = json.loads(line[len("DIAG "):])
        print(f"K10a {name} (without PDL): " + "; ".join(f"{k} {v:.4f} ms" for k, v in results[name].items()),
              flush=True)
    shutil.rmtree(BUILD_DIR / "mutants", ignore_errors=True)
    print(json.dumps({"card": cs.card_line(), "diagnostics": results}), flush=True)
    return 0


def main() -> int:
    if "--diagnostics" in sys.argv[1:]:
        return diagnostics()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    rng = np.random.default_rng(cs.SEED)
    rope, norm = rope_module.rotary_embedding_launcher, norm_module.gemma_rms_norm_launcher
    results = []
    for model, (qh, kh, d, token_counts) in ROPE_SHAPES.items():
        cache = compute_cos_sin_cache(10000.0, d, 8192, device="cuda")
        hidden = 4096 if model == "llama3_8b" else cs.G_HIDDEN
        w_qkv = (0.02 * torch.randn((hidden, (qh + 2 * kh) * d), generator=gen, device="cuda")).to(torch.bfloat16)
        for tokens in token_counts:
            x = torch.randn((tokens, hidden), generator=gen, device="cuda").to(torch.bfloat16)
            pos = torch.from_numpy(rng.integers(0, 8192, size=tokens).astype(np.int32)).cuda()
            plan = rope_module.rope_plan(tokens, qh, kh, d, d, 2, (qh + 2 * kh) * d, (qh + 2 * kh) * d, True)
            for by in ROPE_HEADS_A_BLOCK:
                original = with_plan(rope_module, "rope_plan", lambda p, by=by: dataclasses.replace(
                    p, block=(p.block[0], by), grid=(p.grid[0], cdiv(qh + kh, by))))
                try:
                    t = timed(lambda out: rope(pos, out[:, : qh * d], out[:, qh * d : (qh + kh) * d], d, cache),
                              lambda: torch.matmul(x, w_qkv))
                finally:
                    rope_module.rope_plan = original
                mark = " plan" if by == plan.block[1] else ""
                results.append({"kernel": "K5", "model": model, "tokens": tokens, "heads_a_block": by, **t})
                print(f"K5 {model} tokens={tokens} heads a block {by}{mark}: alone {t['alone_ms']:.4f} ms, after "
                      f"the matmul {t['after_pred_ms']:.4f} ms", flush=True)
    w_o = (0.02 * torch.randn((2048, cs.G_HIDDEN), generator=gen, device="cuda")).to(torch.bfloat16)
    w = (0.5 * torch.randn((cs.G_HIDDEN,), generator=gen, device="cuda")).to(torch.bfloat16)
    nvec = cs.G_HIDDEN // 8
    for rows in NORM_ROWS:
        x = torch.randn((rows, 2048), generator=gen, device="cuda").to(torch.bfloat16)
        plan = norm_module.gemma_norm_plan(rows, cs.G_HIDDEN, 2, cs.G_HIDDEN, True)
        for tpr in NORM_THREADS_A_ROW:
            original = with_plan(norm_module, "gemma_norm_plan", lambda p, tpr=tpr: dataclasses.replace(
                p, threads_per_row=tpr, rows_per_block=1, items=cdiv(nvec, tpr), grid=rows))
            try:
                t = timed(lambda out: norm(out, w, 1e-6), lambda: torch.matmul(x, w_o))
            finally:
                norm_module.gemma_norm_plan = original
            mark = " plan" if tpr == plan.threads_per_row else ""
            results.append({"kernel": "K10a", "rows": rows, "threads_a_row": tpr, **t})
            print(f"K10a rows={rows} threads a row {tpr}{mark}: alone {t['alone_ms']:.4f} ms, after the matmul "
                  f"{t['after_pred_ms']:.4f} ms", flush=True)
    print(json.dumps({"card": cs.card_line(), "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
