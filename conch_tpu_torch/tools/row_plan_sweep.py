# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Time K5 (RoPE), K10a (Gemma RMS norm), K4 (RMS norm), K2 (the stacked
KV-cache write), K6 and K10b (the gated activations) at other launch plans
than their plans pick.

    python3 -m conch_tpu_torch.tools.row_plan_sweep

Run from the checkout's root on one Hopper card. At the served shapes (K5:
Llama-3-8B's QH 32 / KH 8 / D 128 at 8, 32 and 512 tokens and Gemma-2-2B's
8 / 4 / 256 at 8, 16 and 512, on slices of the fused qkv product; K10a:
Gemma-2-2B's hidden 2304 at 8, 16 and 512 rows; K4: Llama-3-8B's hidden
4096 at 8, 32 and 512 rows; K2: Llama-3-8B's decode step of 8 tokens and
the padded 32 with 8 live, k from K5; bf16) the tool swaps the module's
plan function (``rope_plan``, ``row_norm_plan``, ``cache_write_plan``) for
one that returns the plan with one field forced (K5: heads a block; K10a
and K4: threads a row, with the vectors a thread that follow; K2: rows a
block), and times the kernel back to back (``chip_smoke.time_ms``) and
after its served predecessor (K5 and K10a: a bf16 ``torch.matmul``; K4:
the residual add; K2: K5), the pair's time minus the predecessor's,
PAIR_ITERS launches each, with the programmatic-dependent launch. The
plan's own choice is the line marked "plan". Prints one line per case and
a JSON line.

    python3 -m conch_tpu_torch.tools.row_plan_sweep --gated

times only K6 (Llama-3-8B's d 14336 at 8, 32 and 512 rows) and K10b
(Gemma-2-2B's 9216 at 8, 16 and 512), bf16 fused halves, at forced
``gated_act_plan`` plans (units of 16 or 8 bytes; the decode steps at 64
to 256 threads a block, one unit a thread; 512 rows at 1 to 4 units a
thread, 256 threads, no grid cap), back to back and after a bf16
``torch.matmul`` gate|up projection, with the programmatic-dependent
launch.

    python3 -m conch_tpu_torch.tools.row_plan_sweep --gated-diagnostics

times K6 (14336) at 8 and 32 rows and K10b (9216) at 8 and 16, bf16 and
f32 fused halves, back to back with and without the programmatic-dependent
launch, in copies of the package built as ``--diagnostics`` builds them:
the kernels as they are, with the activation's division by 1 + exp(-g)
replaced by a product, and with no activation (out = g * u); the last two
are wrong by design, diagnostics of time only.

    python3 -m conch_tpu_torch.tools.row_plan_sweep --diagnostics [--parent DIR]

times K10a at 16 and 512 rows (bf16, 2304) and K4 at 8, 32 and 512 rows
(bf16, 4096) without the programmatic-dependent launch (and back to back
with it) in copies of the package (only the row kernels' sources, built in
a subprocess each, as ``row_mutants`` builds them; the changes go into
``csrc/row_norm.cuh``, which both share, or ``csrc/rms_norm.cu``): the
kernels as they are, without the barrier of the cross-warp sum (the sum
races: a diagnostic of time only), without the weight loads (w taken as
0), with them issued before ``griddepcontrol.wait`` and x's after (K10a's
first design), the warp sum in a loop of runtime offsets (this PR's first
design), K4's squares summed in f32 (wrong in the last bits: time only),
and, with ``--parent``, another checkout's kernels.
Each copy is timed back to back and after a 64 MiB ``zero_()`` that evicts
the L2 cache (the pair minus the ``zero_()``), as a served step finds
its weights.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from conch_tpu_torch.kernels.activation import gated_act as gated_module
from conch_tpu_torch.kernels.activation.gelu_tanh_and_mul import gelu_tanh_and_mul_launcher
from conch_tpu_torch.kernels.activation.silu_and_mul import silu_and_mul_launcher
from conch_tpu_torch.kernels.cache import reshape_and_cache as cache_module
from conch_tpu_torch.kernels.common import cdiv
from conch_tpu_torch.kernels.embedding import rotary_embedding as rope_module
from conch_tpu_torch.kernels.normalization import row_norm as norm_module
from conch_tpu_torch.kernels.normalization.gemma_rms_norm import gemma_rms_norm_launcher
from conch_tpu_torch.kernels.normalization.rms_norm import rms_norm_launcher
from conch_tpu_torch.reference.embedding.rotary_embedding import compute_cos_sin_cache
from conch_tpu_torch.tools.row_mutants import K4_SUM_F32, K4_SUM_F64

ROPE_SHAPES = {"llama3_8b": (cs.QH, cs.KH, cs.D, (8, 32, 512)), "gemma2_2b": (cs.G_QH, cs.G_KH, cs.G_D, (8, 16, 512))}
ROPE_HEADS_A_BLOCK = (1, 2, 4, 8, 16, 32)
NORM_ROWS = (8, 16, 512)
NORM_THREADS_A_ROW = (96, 160, 288)
K4_ROWS = (8, 32, 512)
K4_THREADS_A_ROW = (128, 256, 512)
K2_ROWS_A_BLOCK = (1, 2, 4, 8)
GATED_SHAPES = {"K6": (cs.HIDDEN, cs.INTER, cs.K6_ROWS), "K10b": (cs.G_HIDDEN, cs.G_INTER, cs.K10B_ROWS)}
GATED_VECTORS = (8, 4)  # bf16 elements a unit: 16 or 8 bytes
GATED_DECODE_THREADS = (64, 128, 256)
GATED_PREFILL_ITEMS = (1, 2, 4)


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
ROW_SUM = """  if (tpr <= 32) {
    for (int offset = tpr >> 1; offset > 0; offset >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, offset);
    return sq;
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, offset);
"""
ROW_SUM_RUNTIME_OFFSETS = """  const int width = tpr < 32 ? tpr : 32;
  for (int offset = width >> 1; offset > 0; offset >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, offset);
  if (tpr <= 32) return sq;
"""
# name -> the change to a source (None: the kernels as they are)
DIAGNOSTICS = {
    "as is": None,
    "no barrier": ("csrc/row_norm.cuh", "  __syncthreads();\n  Acc total = 0;", "  Acc total = 0;"),
    "no weight loads": ("csrc/row_norm.cuh", "wv[k] = Vx::load(w + j * V);", "wv[k] = typename Vx::Raw{};"),
    "weight loaded before the wait": ("csrc/row_norm.cuh", K10A_LOADS, K10A_LOADS_BEFORE_THE_WAIT),
    "warp sum at runtime offsets": ("csrc/row_norm.cuh", ROW_SUM, ROW_SUM_RUNTIME_OFFSETS),
    "K4 sums in f32": ("csrc/rms_norm.cu", K4_SUM_F64, K4_SUM_F32),
}
DIAGNOSTIC_RUN = r'''
import json, torch, chip_smoke as cs
from conch_tpu_torch.kernels.normalization.gemma_rms_norm import gemma_rms_norm_launcher as k10a
from conch_tpu_torch.kernels.normalization.rms_norm import rms_norm_launcher as k4
cs.build()
gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
scrub = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
times = {}
for name, norm, hidden, all_rows, eps in (("K10a", k10a, cs.G_HIDDEN, (16, 512), 1e-6),
                                         ("K4", k4, cs.HIDDEN, (8, 32, 512), 1e-5)):
    norm.pdl = False  # a package whose launcher has no attribute launches without PDL either way
    w = (0.5 * torch.randn((hidden,), generator=gen, device="cuda")).to(torch.bfloat16)
    for rows in all_rows:
        x = torch.randn((rows, hidden), generator=gen, device="cuda").to(torch.bfloat16)
        times[f"{name} rows={rows} back to back"] = cs.time_ms(lambda: norm(x, w, eps), iters=cs.PAIR_ITERS)
        norm.pdl = True
        times[f"{name} rows={rows} back to back with PDL"] = cs.time_ms(lambda: norm(x, w, eps),
                                                                         iters=cs.PAIR_ITERS)
        norm.pdl = False
        times[f"{name} rows={rows} after the L2 eviction"] = (
            cs.time_ms(lambda: (scrub.zero_(), norm(x, w, eps)), iters=50) - cs.time_ms(scrub.zero_, iters=50))
print("DIAG " + json.dumps(times), flush=True)
'''


GATED_DIAGNOSTICS = {
    "as is": None,
    "no division": ("csrc/gated_act.cuh", "return g / (1.0f + expf(-g));", "return g * (1.0f + expf(-g));"),
    "no activation": (
        "csrc/gated_act.cuh", "return to_float(from_float<T>(Act::apply(g))) * u;", "return g * u;",
    ),
}
GATED_DIAGNOSTIC_RUN = r'''
import json, torch, chip_smoke as cs
from conch_tpu_torch.kernels.activation.gelu_tanh_and_mul import gelu_tanh_and_mul_launcher as k10b
from conch_tpu_torch.kernels.activation.silu_and_mul import silu_and_mul_launcher as k6
cs.build()
gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
times = {}
for name, launch, d, all_rows in (("K6", k6, cs.INTER, (8, 32)), ("K10b", k10b, cs.G_INTER, (8, 16))):
    for rows, dtype in ((r, t) for r in all_rows for t in (torch.bfloat16, torch.float32)):
        x = torch.randn((rows, 2 * d), generator=gen, device="cuda").to(dtype)
        for pdl in (False, True):
            launch.pdl = pdl
            times[f"{name} rows={rows} {dtype} pdl {pdl}"] = cs.time_ms(lambda: launch(x), iters=cs.PAIR_ITERS)
print("DIAG " + json.dumps(times), flush=True)
'''


def diagnostics(changes: dict = DIAGNOSTICS, script: str = DIAGNOSTIC_RUN) -> int:
    """The copies of K10a and K4 (DIAGNOSTICS), or K6 and K10b
    (GATED_DIAGNOSTICS), each built and timed in a subprocess."""
    from conch_tpu_torch.tools.attention_mutants import BUILD_DIR, PACKAGE_DIR, run_phases
    from conch_tpu_torch.tools.row_mutants import ROW_SOURCES, copy_rows

    roots = {name: copy_rows(name.replace(" ", "_"), change) for name, change in changes.items()}
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
        code, out = run_phases(root, script)
        line = next((ln for ln in out.splitlines() if ln.startswith("DIAG ")), None)
        if code != 0 or line is None:
            print(f"{name}: exit code {code}\n{out[-3000:]}", flush=True)
            return 1
        results[name] = json.loads(line[len("DIAG "):])
        print(f"{name}: " + "; ".join(f"{k} {v:.4f} ms" for k, v in results[name].items()), flush=True)
    shutil.rmtree(BUILD_DIR / "mutants", ignore_errors=True)
    print(json.dumps({"card": cs.card_line(), "diagnostics": results}), flush=True)
    return 0


def norm_threads(kernel: str, rows: int, hidden: int, threads: tuple[int, ...], launch, pred, pred_name: str):
    """K4 or K10a (``launch`` of the predecessor's output) at ``rows`` x
    ``hidden`` with each of ``threads`` a row (one row a block), timed by
    ``timed`` after ``pred``."""
    plan, nvec, results = norm_module.row_norm_plan(rows, hidden, 2, hidden, True), hidden // 8, []
    for tpr in threads:
        original = with_plan(norm_module, "row_norm_plan", lambda p, tpr=tpr: dataclasses.replace(
            p, threads_per_row=tpr, rows_per_block=1, items=cdiv(nvec, tpr), grid=rows))
        try:
            t = timed(launch, pred)
        finally:
            norm_module.row_norm_plan = original
        mark = " plan" if tpr == plan.threads_per_row else ""
        results.append({"kernel": kernel, "rows": rows, "threads_a_row": tpr, **t})
        print(f"{kernel} rows={rows} threads a row {tpr}{mark}: alone {t['alone_ms']:.4f} ms, after {pred_name} "
              f"{t['after_pred_ms']:.4f} ms", flush=True)
    return results


def cache_rows_a_block(gen, rng, rope) -> list[dict]:
    """K2 at Llama-3-8B's decode steps (``chip_smoke.K2_STEPS``) with each
    of K2_ROWS_A_BLOCK rows a block, timed after K5, which writes its k."""
    launch = cache_module.reshape_and_cache_stacked_launcher
    kc, vc = cs.make_pool(gen, 256)
    cache = compute_cos_sin_cache(500000.0, cs.D, 8192, device="cuda")
    results = []
    for tokens, idle in cs.K2_STEPS:
        k, v, _, slot_t = cs.k2_step(gen, rng, cs.QH, cs.KH, cs.D, tokens, idle, 256)
        live = tokens - len(idle)
        q = torch.randn((tokens, cs.QH * cs.D), generator=gen, device="cuda").to(torch.bfloat16)
        pos = torch.from_numpy(rng.integers(0, 8192, size=tokens).astype(np.int32)).cuda()
        k_rows = k.reshape(tokens, cs.KH * cs.D)
        plan = cache_module.cache_write_plan(tokens, cs.KH, cs.D, 2, k_rows.stride(0), v.stride(0), True)
        rows = 2 * tokens * cs.KH
        for rpb in K2_ROWS_A_BLOCK:
            original = with_plan(cache_module, "cache_write_plan", lambda p, rpb=rpb: dataclasses.replace(
                p, rows_per_block=rpb, grid=cdiv(rows, rpb)))
            try:
                t = timed(lambda out: launch(out[1].view(tokens, cs.KH, cs.D), v, kc, vc, slot_t, cs.LAYER),
                          lambda: rope(pos, q, k_rows, cs.D, cache))
            finally:
                cache_module.cache_write_plan = original
            mark = " plan" if rpb == plan.rows_per_block else ""
            results.append({"kernel": "K2", "tokens": tokens, "live": live, "rows_a_block": rpb, **t})
            print(f"K2 tokens={tokens} live={live} rows a block {rpb}{mark}: alone {t['alone_ms']:.4f} ms, after "
                  f"K5 {t['after_pred_ms']:.4f} ms", flush=True)
    return results


def gated_plans(gen) -> list[dict]:
    """K6 and K10b (GATED_SHAPES) at forced plans (GATED_VECTORS elements a
    unit; at decode steps GATED_DECODE_THREADS a block, one unit a thread;
    at 512 rows GATED_PREFILL_ITEMS a thread in blocks of 256), timed by
    ``timed`` after the bf16 gate|up matmul that feeds them."""
    launchers = {"K6": silu_and_mul_launcher, "K10b": gelu_tanh_and_mul_launcher}
    results = []
    for kernel, (hidden, d, all_rows) in GATED_SHAPES.items():
        launch = launchers[kernel]
        w = (0.02 * torch.randn((hidden, 2 * d), generator=gen, device="cuda")).to(torch.bfloat16)
        for rows in all_rows:
            x = torch.randn((rows, hidden), generator=gen, device="cuda").to(torch.bfloat16)
            plan = gated_module.gated_act_plan(rows, d, 2, 2 * d, 2 * d, True)
            forced = itertools.product(GATED_VECTORS, GATED_DECODE_THREADS if rows < 512 else (256,),
                                       (1,) if rows < 512 else GATED_PREFILL_ITEMS)
            for vec, threads, items in forced:
                original = with_plan(gated_module, "gated_act_plan", lambda p, v=vec, t=threads, i=items: (
                    dataclasses.replace(p, vec=v, threads=t, items=i, grid=cdiv(rows * d // v, t * i))))
                try:
                    t = timed(launch, lambda x=x: torch.matmul(x, w))
                finally:
                    gated_module.gated_act_plan = original
                mark = " plan" if (vec, threads, items) == (plan.vec, plan.threads, plan.items) else ""
                results.append({"kernel": kernel, "rows": rows, "vec": vec, "threads": threads, "items": items, **t})
                print(f"{kernel} rows={rows} vec {vec} threads {threads} items {items}{mark}: alone "
                      f"{t['alone_ms']:.4f} ms, after the matmul {t['after_pred_ms']:.4f} ms", flush=True)
    return results


def main() -> int:
    if "--diagnostics" in sys.argv[1:]:
        return diagnostics()
    if "--gated-diagnostics" in sys.argv[1:]:
        return diagnostics(GATED_DIAGNOSTICS, GATED_DIAGNOSTIC_RUN)
    if "--gated" in sys.argv[1:]:
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        print(json.dumps({"card": cs.card_line(), "results": gated_plans(gen)}), flush=True)
        return 0
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    rng = np.random.default_rng(cs.SEED)
    rope, norm = rope_module.rotary_embedding_launcher, gemma_rms_norm_launcher
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
    for rows in NORM_ROWS:
        x = torch.randn((rows, 2048), generator=gen, device="cuda").to(torch.bfloat16)
        results += norm_threads("K10a", rows, cs.G_HIDDEN, NORM_THREADS_A_ROW, lambda out: norm(out, w, 1e-6),
                                lambda x=x: torch.matmul(x, w_o), "the matmul")
    w4 = (1.0 + 0.1 * torch.randn((cs.HIDDEN,), generator=gen, device="cuda")).to(torch.bfloat16)
    for rows in K4_ROWS:
        h, r = (torch.randn((rows, cs.HIDDEN), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
        results += norm_threads("K4", rows, cs.HIDDEN, K4_THREADS_A_ROW, lambda out: rms_norm_launcher(out, w4, 1e-5),
                                lambda h=h, r=r: h + r, "the residual add")
    results += cache_rows_a_block(gen, rng, rope)
    results += gated_plans(gen)
    print(json.dumps({"card": cs.card_line(), "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
