# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Time K1 to K8, K10a, K10b, K11, K12q and K13a to K13c of two checkouts on one card, in turns.

    python3 -m conch_tpu_torch.tools.parent_compare --parent DIR [--kernels K6 K10b ...] [--serve]
    python3 -m conch_tpu_torch.tools.parent_compare --mutant NAME [--kernels ...]

Run from the checkout's root on one Hopper card, with ``DIR`` another
checkout of the repository (for instance ``git archive`` of the parent
commit, unpacked). The tool copies ``DIR``'s ``conch_tpu_torch`` package to
``conch_tpu_torch/_build/compare/parent/`` and times, in a subprocess per
run that builds that run's kernels, the parent's package, this one, this
one again and the parent's again (so a drift of the card shows as a
difference between a package's two runs). Each run goes through the public
launchers only, which both packages share:

- K1 (``mixed_gemm_magic_launcher``), one layer's four GEMMs of the int4
  Llama-3-8B engine (fused wqkv, wo, fused gate|up, w_down) at groups 128
  and 64 and M 8, 32 and 512, read from layer 17 of a 32-layer stack
  (timed calls walk the layers, so the weights come from HBM);
- K1G32 and K1bG32 (the same launchers at group 32): one MoE layer's
  GEMMs of DeepSeek-V2-Lite's int4 engine (``chip_smoke.DS_INT4_LAYER_SHAPES``:
  two groups a K1 slice) and of its int8 engine (``DS_INT8_LAYER_SHAPES``:
  8-bit planar codes, 8 word rows a K1b slice) at M 8, 32 and 512 (layer
  17 of a 32-layer stack; timed calls walk the layers). Only a checkout
  whose kernels take group 32 can run them (this one and later);
- K3 (``paged_attention_launcher``) on ``chip_smoke.py``'s ``K3_CASES``,
  built by its ``k3_inputs`` as its K3 phases build them: the kernel
  table's lines (Llama-3-8B's decode batch of 8 at lengths to 540;
  Gemma-2-2B's 8 rows to 6000, softcap 50) and the served decode steps,
  Gemma's without and with the 4096 window;
- K7 (``varlen_attention_launcher``) on ``K7_CASES``, built by
  ``k7_inputs``: Llama-3-8B's 128-row prefill step and Gemma-2-2B's
  512-row one (softcap 50, without and with the 4096 window), over bf16,
  int8 and e4m3 pools;
- K1b (``mixed_gemm_planar_launcher``), one layer's four GEMMs of the int8
  engine (8-bit planar codes, group 128, bf16 scales) and K1c
  (``mixed_gemm_rows_launcher``), one layer's seven NF4 GEMMs of the nf4
  engine, at M 8, 32 and 512 (layer 17 of a 32-layer stack; timed calls
  walk the layers);
- K8 (``scaled_gemm_launcher``), one layer's four GEMMs of the w8a8 engine
  at M 8, 32 and 512, built by ``k8_weights`` and ``k8_rows`` (layer 17
  of a 32-layer stack; timed calls walk the layers); then the same four
  shapes over float8_e4m3fn (``k8_e4m3_weights``, per-row and per-column
  scales, bf16 out) at M 16, 32 and 512 (``K8_FP8_MS``);
- K11 (``mla_attention_launcher``) on ``k11_inputs``' decode and 512-row
  prefill steps at DeepSeek-V2-Lite's shapes, bf16 queries over bf16,
  int8 and e4m3 latent pools;
- K12q (``quantize4_launcher``), NF4 on Llama-3-8B's gate projection
  (14336 x 4096 bf16, as ``kernel_phase_k12q`` builds it) at blocksizes 64
  and 4096;
- K5 (``rotary_embedding_launcher``) on slices of a fused bf16 qkv block at
  Llama-3-8B's and Gemma-2-2B's heads, and K10a (``gemma_rms_norm_launcher``)
  at Gemma-2-2B's hidden 2304 in bf16, each at 8, 16, 32 and 512 rows; then
  both after their served predecessors (``chip_smoke.row_kernel_pairs``:
  the pair's time minus the predecessor's, with and without the
  programmatic-dependent launch where the package has it);
- K4 (``rms_norm_launcher``) at Llama-3-8B's hidden 4096 in bf16 at 8, 32
  and 512 rows, and K2 (``reshape_and_cache_stacked_launcher``) at
  ``chip_smoke.K2_STEPS`` (8 tokens, one idle; 32 with 8 live) of
  Llama-3-8B into bf16, int8 and e4m3 pools and at Gemma-2-2B's 8 tokens,
  k and v slices of a fused qkv block (``chip_smoke.k2_step``); then both
  after their served predecessors (``row_kernel_pairs``, as K5 and K10a);
- K6 (``silu_and_mul_launcher``) at Llama-3-8B's d 14336 and K10b
  (``gelu_tanh_and_mul_launcher``) at Gemma-2-2B's 9216, bf16 fused halves
  at ``chip_smoke.K6_ROWS`` and ``K10B_ROWS`` (8 / 32 / 512 and 8 / 16 /
  512 rows), then after their served predecessors (``row_kernel_pairs``).
  Their outputs in f32 and bf16 (fused halves, row-strided parts, and
  fused rows one element longer, which take the scalar path) at those
  steps are hashed in every run: the tool fails unless the two packages'
  outputs are equal bit for bit.

- K13a (``bev_pool_forward_launcher``) and K13b
  (``bev_pool_backward_launcher``) on ``chip_smoke.bevfusion_inputs``
  (BEVFusion's nuScenes pool, f32 and bf16), and K13c
  (``nms_keep_mask_launcher``) on ``chip_smoke.nms_boxes``' 4096 tied boxes
  at IoU 0.5, each through its launcher (K13b's output allocation
  included); their calls are also profiled, and the device time of each
  kernel a call launches is printed by name (K13c's mask and scan kernels,
  a zero fill where a launcher has one). Their outputs are hashed in
  every run and must be equal bit for bit. Asked for alone, each package
  is copied with only ``csrc/bev_pool.cu`` and ``csrc/nms.cu``, so a run
  builds in seconds.

``--kernels`` times only the named ones (K1 K1b K1c K2 K3 K4 K5 K6 K7 K8
K10a K10b K11 K12q K13a K13b K13c K1G32 K1bG32; by default all but the
last two, which a checkout older than group 32 refuses).
``--mutant NAME`` times this checkout against a copy of itself with
``gemm_mutants.py``'s fault NAME put in, in the parent's place (for
instance ``k8_e4m3_not_promoted``: K8's e4m3 slices summed in the wgmma
accumulator, to time the promotion).
``--serve`` also serves Gemma-2-2B and the int4 Llama-3-8B engine with each
package, as ``chip_smoke.py``'s ``serve`` does (launches checked per model
step, then a profiled repeat), and prints each run's served and profile
lines (device time by kernel, K5's, K6's, K10a's and K10b's among them); a package whose
K5 and K10a launch as programmatic dependents also serves Gemma-2-2B with
that launch off. The profile lines give K2's, K4's, K5's and K10a's
device time and launches.

Device times come from ``chip_smoke.time_ms``. The tool prints each run's
numbers, then one line per case with the two packages' means, and a JSON
line with every run.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from conch_tpu_torch.kernels.common import BUILD_DIR
from conch_tpu_torch.tools.attention_mutants import copy_package
from conch_tpu_torch.tools.gemm_mutants import MUTANTS

PACKAGE_DIR = Path(__file__).resolve().parents[1]
REPO_ROOT = PACKAGE_DIR.parent

# Run in a subprocess with one package first on the path; prints one JSON line.
RUN = r'''
import hashlib, json, itertools, sys
import numpy as np, torch
import chip_smoke as cs
import conch_tpu_torch
from conch_tpu_torch.kernels.common import kernel_library
from conch_tpu_torch.kernels.quantization.gemm import mixed_gemm_magic_launcher as k1
from conch_tpu_torch.kernels.attention.paged_attention import paged_attention_launcher as k3
from conch_tpu_torch.kernels.embedding.rotary_embedding import rotary_embedding_launcher as k5
from conch_tpu_torch.kernels.attention.varlen_attention import varlen_attention_launcher as k7
from conch_tpu_torch.kernels.quantization.gemm import scaled_gemm_launcher as k8
from conch_tpu_torch.kernels.normalization.gemma_rms_norm import gemma_rms_norm_launcher as k10a
from conch_tpu_torch.kernels.attention.mla_attention import mla_attention_launcher as k11
from conch_tpu_torch.kernels.quantization.bitsandbytes.blockwise import quantize4_launcher as k12q
from conch_tpu_torch.kernels.cache.reshape_and_cache import reshape_and_cache_stacked_launcher as k2
from conch_tpu_torch.kernels.normalization.rms_norm import rms_norm_launcher as k4
from conch_tpu_torch.kernels.activation import gelu_tanh_and_mul as k10b_module, silu_and_mul as k6_module
from conch_tpu_torch.reference.embedding.rotary_embedding import compute_cos_sin_cache

k6, k10b = k6_module.silu_and_mul_launcher, k10b_module.gelu_tanh_and_mul_launcher

want = set(sys.argv[1:])
has_pdl = hasattr(k5, "pdl")
kernel_library()
gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
rng = np.random.default_rng(cs.SEED)
times, digests = {}, {}
# The quantized GEMMs, each as (label, (K, N) shapes (a dict gives each its
# count a layer), codes a 32-bit word, metadata rows a group, metadata dtype,
# the call); timed one layer at a time, the calls walking a 32-layer stack.
gemm_cases = []
if want & {"K1b", "K1bG32", "K1c"}:
    from conch_tpu_torch.kernels.quantization.bitsandbytes.blockwise import NF4_CODE
    from conch_tpu_torch.kernels.quantization.gemm import mixed_gemm_planar_launcher as k1b
    from conch_tpu_torch.kernels.quantization.gemm import mixed_gemm_rows_launcher as k1c
for key, label, shapes, group in (("K1", "K1 group 128", cs.K1_SHAPES, 128), ("K1", "K1 group 64", cs.K1_SHAPES, 64),
                                  ("K1G32", "K1 G32", cs.DS_INT4_LAYER_SHAPES, cs.DS_GROUP)):
    if key in want:
        gemm_cases.append((label, shapes, 8, group, torch.bfloat16,
                           lambda x, w, s, li, g=group: k1(x, w, s, g, 8, li)))
for key, label, shapes, group in (("K1b", "K1b", cs.FUSED_LAYER_SHAPES, cs.GROUP),
                                  ("K1bG32", "K1b G32", cs.DS_INT8_LAYER_SHAPES, cs.DS_GROUP)):
    if key in want:
        gemm_cases.append((label, shapes, 4, group, torch.bfloat16,
                           lambda x, w, s, li, g=group: k1b(x, w, s, None, 8, 128, g, li)))
if "K1c" in want:
    gemm_cases.append(("K1c", cs.NF4_LAYER_SHAPES, 8, cs.NF4_BLOCK, torch.float32,
                       lambda x, w, s, li: k1c(x, w, s, None, 4, 0, cs.NF4_BLOCK, NF4_CODE, li)))
for label, shapes, epw, group, meta_dtype, call in gemm_cases:
    counts = shapes if isinstance(shapes, dict) else dict.fromkeys(shapes, 1)
    sums = {m: 0.0 for m in cs.GEMM_MS}
    for (k, n), count in counts.items():
        packed = torch.randint(-(2**31), 2**31 - 1, (cs.NUM_LAYERS_POOL, k // epw, n), generator=gen,
                               device="cuda", dtype=torch.int32)
        meta = (torch.rand((cs.NUM_LAYERS_POOL, k // group, n), generator=gen, device="cuda") * 4e-3
                + 1e-4).to(meta_dtype)
        layers = itertools.cycle(range(cs.NUM_LAYERS_POOL))
        for m in cs.GEMM_MS:
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            sums[m] += count * cs.time_ms(lambda: call(x, packed, meta, next(layers)))
        del packed, meta
        torch.cuda.empty_cache()
    for m, t in sums.items():
        times[f"{label} one layer M={m}"] = t

if "K3" in want:
    for name in cs.K3_CASES:
        case = cs.k3_inputs(gen, rng, name)
        for w in case["windows"]:
            times[f"K3 {name} window {w}"] = cs.time_ms(lambda: k3(*case["args"], w))
        del case

if "K7" in want:
    for cache in (None, "int8", "fp8"):
        launch = cs.with_kv_scales(k7, cache)
        for name in cs.K7_CASES:
            case = cs.k7_inputs(gen, rng, name, cache)
            for w in case["windows"]:
                times[f"K7 {name} {cache or 'bf16'} cache window {w}"] = cs.time_ms(lambda: launch(*case["args"], w))
            del case
            torch.cuda.empty_cache()

if "K8" in want:
    sums = {m: 0.0 for m in cs.GEMM_MS}
    for k, n in cs.FUSED_LAYER_SHAPES:
        w8, sb = cs.k8_weights(gen, k, n)
        layers = itertools.cycle(range(cs.NUM_LAYERS_POOL))
        for m in cs.GEMM_MS:
            a, sa = cs.k8_rows(gen, m, k)
            sums[m] += cs.time_ms(lambda: k8(a, w8, sa, sb, torch.bfloat16, next(layers)))
        del w8, sb
        torch.cuda.empty_cache()
    for m, t in sums.items():
        times[f"K8 one layer M={m}"] = t
    sums = {m: 0.0 for m in cs.K8_FP8_MS}
    for k, n in cs.FUSED_LAYER_SHAPES:
        w8, sb = cs.k8_e4m3_weights(gen, k, n)
        layers = itertools.cycle(range(cs.NUM_LAYERS_POOL))
        for m in cs.K8_FP8_MS:
            a = torch.randn((m, k), generator=gen, device="cuda").to(torch.float8_e4m3fn)
            sa = 1e-2 * torch.logspace(0, 1, m, device="cuda")
            sums[m] += cs.time_ms(lambda: k8(a, w8, sa, sb, torch.bfloat16, next(layers)))
        del w8, sb
        torch.cuda.empty_cache()
    for m, t in sums.items():
        times[f"K8 e4m3 one layer M={m}"] = t

if "K11" in want:
    for cache in (None, "int8", "fp8"):
        inputs = cs.k11_inputs(gen, rng, cache)
        for case in inputs["cases"]:
            args, kw = cs.k11_args(inputs, case, torch.bfloat16)
            times[f"K11 {case} {cache or 'bf16'} cache"] = cs.time_ms(lambda: k11(*args, **kw))
        del inputs
        torch.cuda.empty_cache()

if "K12q" in want:
    k, n = cs.GATE
    wt = (0.02 * torch.randn((n, k), generator=gen, device="cuda")).to(torch.bfloat16)
    for blocksize in (cs.NF4_BLOCK, 4096):
        times[f"K12q gate nf4 blocksize {blocksize}"] = cs.time_ms(lambda: k12q(wt, blocksize, "nf4"))

if "K4" in want:
    w4 = (1.0 + 0.1 * torch.randn((cs.HIDDEN,), generator=gen, device="cuda")).to(torch.bfloat16)
    for rows in cs.K4_ROWS:
        x = torch.randn((rows, cs.HIDDEN), generator=gen, device="cuda").to(torch.bfloat16)
        times[f"K4 rows={rows}"] = cs.time_ms(lambda: k4(x, w4, 1e-5))

if "K2" in want:
    for label, (qh, kh, d, layers, steps) in (("llama3_8b", (cs.QH, cs.KH, cs.D, cs.NUM_LAYERS_POOL, cs.K2_STEPS)),
                                              ("gemma2_2b", (cs.G_QH, cs.G_KH, cs.G_D, cs.G_LAYERS, cs.K2_STEPS[:1]))):
        for cache in (None, "int8", "fp8") if label == "llama3_8b" else (None,):
            kc, vc = cs.kv_pools(gen, 256, layers, kh, d, cache)
            launch = cs.with_kv_scales(k2, cache)
            for tokens, idle in steps:
                k, v, _, slot_t = cs.k2_step(gen, rng, qh, kh, d, tokens, idle, 256)
                times[f"K2 {label} {cache or 'bf16'} cache tokens={tokens} live={tokens - len(idle)}"] = cs.time_ms(
                    lambda: launch(k, v, kc, vc, slot_t, cs.LAYER))
            del kc, vc
            torch.cuda.empty_cache()

for label, fn, parts, d, steps in (
        ("K6", k6, k6_module.silu_and_mul_parts_launcher, cs.INTER, cs.K6_ROWS),
        ("K10b", k10b, k10b_module.gelu_tanh_and_mul_parts_launcher, cs.G_INTER, cs.K10B_ROWS)):
    if label not in want:
        continue
    for rows, dtype in itertools.product(steps, (torch.float32, torch.bfloat16)):
        x = (3.0 * torch.randn((rows, 2 * d + 1), generator=gen, device="cuda")).to(dtype)
        halves = x[:, : 2 * d].contiguous()
        for form, out in (("halves", fn(halves)), ("parts", parts(halves[:, :d], halves[:, d:])),
                          ("misaligned rows", fn(x[:, : 2 * d]))):
            digests[f"{label} rows={rows} {dtype} {form}"] = hashlib.sha256(
                out.view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
        if dtype == torch.bfloat16:
            times[f"{label} rows={rows}"] = cs.time_ms(lambda: fn(halves))

if want & {"K5", "K10a", "K4", "K2", "K6", "K10b"}:
    for fn in (k5, k10a, k4, k2, k6, k10b):
        fn.pdl = getattr(fn, "pdl", False)  # a package without the attribute launches one way
    for label, (qh, kh, d, theta) in (("llama3_8b", (cs.QH, cs.KH, cs.D, 500000.0)),
                                      ("gemma2_2b", (cs.G_QH, cs.G_KH, cs.G_D, 10000.0))):
        cache = compute_cos_sin_cache(theta, d, 8192, device="cuda")
        for tokens in (8, 16, 32, 512):
            qkv = torch.randn((tokens, (qh + 2 * kh) * d), generator=gen, device="cuda").to(torch.bfloat16)
            q, kk = qkv[:, : qh * d], qkv[:, qh * d : (qh + kh) * d]
            pos = torch.from_numpy(rng.integers(0, 8192, size=tokens).astype(np.int32)).cuda()
            times[f"K5 {label} tokens={tokens}"] = cs.time_ms(lambda: k5(pos, q, kk, d, cache))
    w = (0.5 * torch.randn((cs.G_HIDDEN,), generator=gen, device="cuda")).to(torch.bfloat16)
    for rows in (8, 16, 32, 512):
        x = torch.randn((rows, cs.G_HIDDEN), generator=gen, device="cuda").to(torch.bfloat16)
        times[f"K10a rows={rows}"] = cs.time_ms(lambda: k10a(x, w, 1e-6))
    by_name = {"rotary_embedding": {}, "gemma_rms_norm": {}, "reshape_and_cache_stacked": {}, "rms_norm": {},
               "silu_and_mul": {}, "gelu_tanh_and_mul": {}}
    cs.row_kernel_pairs(gen, rng, by_name)
    for row in by_name.values():
        for pair in row["after_predecessor"]:
            for tag in ("no_pdl", "pdl"):
                v = pair[f"{tag}_after_pred_ms"]
                times[f"{pair['case']} ({tag})"] = sum(v) / len(v)

if want & {"K13a", "K13b", "K13c"}:
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from conch_tpu_torch.kernels.vision.bev_pool import bev_pool_backward_launcher as k13b
    from conch_tpu_torch.kernels.vision.bev_pool import bev_pool_forward_launcher as k13a
    from conch_tpu_torch.kernels.vision.nms import nms_keep_mask_launcher as k13c, sorted_boxes

    def digest(t):
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()

    def split(label, fn, iters=20):
        """Device ms a call of each kernel ``fn`` launches, from a profiler trace's kernel events."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            prof.export_chrome_trace(f"{tmp}/trace.json")
            with open(f"{tmp}/trace.json") as f:
                events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
        for e in events:
            name = e["name"].replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
            name = name.replace("void ", "")[-40:]
            key = f"{label} [profile] {name}"
            times[key] = times.get(key, 0.0) + e["dur"] / 1e3 / iters

    for dtype in (torch.float32, torch.bfloat16):
        bev = cs.bevfusion_inputs(gen, np.random.default_rng(cs.SEED), dtype)
        args = (bev["feats"], bev["geom"], bev["starts"], bev["lengths"])
        n, tag = bev["feats"].shape[0], str(dtype).split(".")[-1]
        if "K13a" in want:
            digests[f"K13a BEVFusion {tag}"] = digest(k13a(*args, *cs.BEV_GRID))
            times[f"K13a BEVFusion {tag}"] = cs.time_ms(lambda: k13a(*args, *cs.BEV_GRID))
            split(f"K13a BEVFusion {tag}", lambda: k13a(*args, *cs.BEV_GRID))
        if "K13b" in want:
            grad = torch.randn((*cs.BEV_GRID, cs.BEV_C), generator=gen, device="cuda").to(dtype)
            bargs = (grad, *args[1:], n)
            digests[f"K13b BEVFusion {tag}"] = digest(k13b(*bargs))
            times[f"K13b BEVFusion {tag}"] = cs.time_ms(lambda: k13b(*bargs))
            split(f"K13b BEVFusion {tag}", lambda: k13b(*bargs))
            del grad, bargs
        del bev, args
        torch.cuda.empty_cache()
    if "K13c" in want:
        boxes, scores = cs.nms_boxes(rng, cs.NMS_BOXES, ties=True)
        _, parts = sorted_boxes(boxes, scores)
        label = f"K13c {cs.NMS_BOXES} boxes IoU {cs.NMS_IOU}"
        digests[label] = digest(k13c(*parts, cs.NMS_IOU))
        times[label] = cs.time_ms(lambda: k13c(*parts, cs.NMS_IOU))
        split(label, lambda: k13c(*parts, cs.NMS_IOU))

if "serve" in want:
    from conch_tpu_torch.models.gemma import GemmaConfig, gemma_decode_step, gemma_prefill, init_gemma_params
    from conch_tpu_torch.models.llama import LlamaConfig, init_llama_params

    card = cs.card_line()

    def gemma(label):
        cs.serve(card, label, GemmaConfig.gemma2_2b(), lambda cfg: init_gemma_params(cs.SEED, cfg, device="cuda"),
                 {"prefill_fn": gemma_prefill, "decode_fn": gemma_decode_step},
                 {"num_pages": 4096, "max_batch_size": 16, "max_pages_per_seq": 320}, cs.gemma_prompts,
                 cs.GEMMA_KERNELS, cs.GEMMA_PER_STEP)

    gemma("gemma2-2b")
    if has_pdl:  # the same run with K5 and K10a launched after their predecessors end
        k5.pdl = k10a.pdl = False
        gemma("gemma2-2b without PDL")
        k5.pdl = k10a.pdl = True
    cs.serve(card, "int4", LlamaConfig.llama3_8b(),
             lambda cfg: init_llama_params(cs.SEED, cfg, quant_mode="int4", device="cuda"), {},
             {"num_pages": 4096, "max_batch_size": 32}, cs.int4_prompts, cs.LLAMA_KERNELS, cs.LLAMA_PER_STEP)
print("TIMES " + json.dumps({"package": conch_tpu_torch.__file__, "times": times, "digests": digests}), flush=True)
'''
KERNELS = ("K1", "K1b", "K1c", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K10a", "K10b", "K11", "K12q", "K13a",
           "K13b", "K13c")
# Group 32 of K1 and K1b: asked for by name (a checkout before it refuses the group).
GROUP32_KERNELS = ("K1G32", "K1bG32")
# A run of the vision kernels alone builds their sources alone (seconds, not minutes).
VISION_KERNELS, VISION_SOURCES = {"K13a", "K13b", "K13c"}, ("bev_pool.cu", "nms.cu")
# The lines of a run's output that the tool prints with --serve.
SERVE_LINES = ("served ", "profile", "launches per model step")


def run(package_root: Path, parts: list[str]) -> dict:
    """One timed run of ``parts`` (kernel names, "serve") with
    ``package_root``'s package first on the path and this checkout's
    ``chip_smoke.py`` after it; the served and profile lines of its output
    under "serve"."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(package_root), str(REPO_ROOT)])}
    proc = subprocess.run([sys.executable, "-c", RUN, *parts], cwd=package_root, env=env, capture_output=True,
                          text=True, check=False)
    line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("TIMES ")), None)
    if proc.returncode != 0 or line is None:
        msg = f"the run of {package_root} failed (exit code {proc.returncode}):\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}"
        raise RuntimeError(msg)
    result = json.loads(line[len("TIMES "):])
    result["serve"] = [ln for ln in proc.stdout.splitlines() if any(tag in ln for tag in SERVE_LINES)]
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    which = parser.add_mutually_exclusive_group(required=True)
    which.add_argument("--parent", type=Path, help="another checkout of the repository")
    which.add_argument("--mutant", choices=sorted(MUTANTS), help="time against this checkout with a gemm_mutants fault")
    parser.add_argument("--kernels", nargs="+", choices=KERNELS + GROUP32_KERNELS, default=list(KERNELS),
                        help="the kernels to time")
    parser.add_argument("--serve", action="store_true", help="also serve Gemma-2-2B and int4 Llama-3-8B, profiled")
    args = parser.parse_args()
    parts = [*args.kernels, *(["serve"] if args.serve else [])]
    parent, change = BUILD_DIR / "compare" / "parent", REPO_ROOT
    copies = [] if args.mutant else [(args.parent, parent)]
    if args.mutant:
        parent = copy_package(args.mutant, MUTANTS[args.mutant][:3])
    vision = set(args.kernels) <= VISION_KERNELS and not args.serve
    if vision:
        change = BUILD_DIR / "compare" / "change"
        copies.append((REPO_ROOT, change))
    for source, root in copies:
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(source / PACKAGE_DIR.name, root / PACKAGE_DIR.name,
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        if vision:
            for path in (root / PACKAGE_DIR.name / "csrc").glob("*.cu"):
                if path.name not in VISION_SOURCES:
                    path.unlink()
    runs = []
    for label, root in (("parent", parent), ("change", change), ("change", change), ("parent", parent)):
        result = run(root, parts)
        runs.append({"label": label, **result})
        print(f"{label} ({result['package']}): " + "; ".join(f"{k} {v:.4f}" for k, v in result["times"].items()),
              flush=True)
        for line in result["serve"]:
            print(f"{label}: {line}", flush=True)
    for case in dict.fromkeys(c for r in runs for c in r["times"]):
        by = {label: [r["times"][case] for r in runs if r["label"] == label and case in r["times"]]
              for label in ("parent", "change")}
        if not all(by.values()):  # a kernel only one package launches (a profile's split by kernel name)
            print(f"{case}: " + ", ".join(f"{label} {', '.join(f'{t:.4f}' for t in v)} ms"
                                          for label, v in by.items() if v), flush=True)
            continue
        mean = {label: sum(v) / len(v) for label, v in by.items()}
        print(f"{case}: parent {mean['parent']:.4f} ms ({by['parent'][0]:.4f}, {by['parent'][1]:.4f}), change "
              f"{mean['change']:.4f} ms ({by['change'][0]:.4f}, {by['change'][1]:.4f}), change / parent "
              f"{mean['change'] / mean['parent']:.3f}", flush=True)
    print(json.dumps({"runs": runs}), flush=True)
    shutil.rmtree(BUILD_DIR / "compare", ignore_errors=True)
    shutil.rmtree(BUILD_DIR / "mutants", ignore_errors=True)
    differ = sorted(case for case in runs[0]["digests"] if len({r["digests"][case] for r in runs}) != 1)
    if runs[0]["digests"]:
        print(f"outputs of the two packages: {len(runs[0]['digests'])} cases, "
              + (f"{len(differ)} differ: {', '.join(differ)}" if differ else "all equal bit for bit"), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
