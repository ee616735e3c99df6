# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Time K1, K3, K5, K7, K8, K10a, K11 and K12q of two checkouts on one card, in turns.

    python3 -m conch_tpu_torch.tools.parent_compare --parent DIR [--kernels K5 K10a ...] [--serve]

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
- K3 (``paged_attention_launcher``) on ``chip_smoke.py``'s ``K3_CASES``,
  built by its ``k3_inputs`` as its K3 phases build them: the kernel
  table's lines (Llama-3-8B's decode batch of 8 at lengths to 540;
  Gemma-2-2B's 8 rows to 6000, softcap 50) and the served decode steps,
  Gemma's without and with the 4096 window;
- K7 (``varlen_attention_launcher``) on ``K7_CASES``, built by
  ``k7_inputs``: Llama-3-8B's 128-row prefill step and Gemma-2-2B's
  512-row one (softcap 50, without and with the 4096 window), over bf16,
  int8 and e4m3 pools;
- K8 (``scaled_gemm_launcher``), one layer's four GEMMs of the w8a8 engine
  at M 8, 32 and 512, built by ``k8_weights`` and ``k8_rows`` (layer 17
  of a 32-layer stack; timed calls walk the layers);
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
  programmatic-dependent launch where the package has it).

``--kernels`` times only the named ones (K1 K3 K5 K7 K8 K10a K11 K12q).
``--serve`` also serves Gemma-2-2B and the int4 Llama-3-8B engine with each
package, as ``chip_smoke.py``'s ``serve`` does (launches checked per model
step, then a profiled repeat), and prints each run's served and profile
lines (device time by kernel, K5's and K10a's among them); a package whose
K5 and K10a launch as programmatic dependents also serves Gemma-2-2B with
that launch off.

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

PACKAGE_DIR = Path(__file__).resolve().parents[1]
REPO_ROOT = PACKAGE_DIR.parent

# Run in a subprocess with one package first on the path; prints one JSON line.
RUN = r'''
import json, itertools, sys
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
from conch_tpu_torch.reference.embedding.rotary_embedding import compute_cos_sin_cache

want = set(sys.argv[1:])
has_pdl = hasattr(k5, "pdl")
kernel_library()
gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
rng = np.random.default_rng(cs.SEED)
times = {}
if "K1" in want:
    for group in (128, 64):
        sums = {m: 0.0 for m in cs.GEMM_MS}
        for k, n in cs.K1_SHAPES:
            packed = torch.randint(-(2**31), 2**31 - 1, (cs.NUM_LAYERS_POOL, k // 8, n), generator=gen,
                                   device="cuda", dtype=torch.int32)
            scales = (torch.rand((cs.NUM_LAYERS_POOL, k // group, n), generator=gen, device="cuda") * 4e-3
                      + 1e-4).to(torch.bfloat16)
            layers = itertools.cycle(range(cs.NUM_LAYERS_POOL))
            for m in cs.GEMM_MS:
                x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
                sums[m] += cs.time_ms(lambda: k1(x, packed, scales, group, 8, next(layers)))
            del packed, scales
        for m, t in sums.items():
            times[f"K1 group {group} one layer M={m}"] = t

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

if "K5" in want or "K10a" in want:
    for fn in (k5, k10a):
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
    by_name = {"rotary_embedding": {}, "gemma_rms_norm": {}}
    cs.row_kernel_pairs(gen, rng, by_name)
    for row in by_name.values():
        for pair in row["after_predecessor"]:
            for tag in ("no_pdl", "pdl"):
                v = pair[f"{tag}_after_pred_ms"]
                times[f"{pair['case']} ({tag})"] = sum(v) / len(v)

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
print("TIMES " + json.dumps({"package": conch_tpu_torch.__file__, "times": times}), flush=True)
'''
KERNELS = ("K1", "K3", "K5", "K7", "K8", "K10a", "K11", "K12q")
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
    parser.add_argument("--parent", type=Path, required=True, help="another checkout of the repository")
    parser.add_argument("--kernels", nargs="+", choices=KERNELS, default=list(KERNELS), help="the kernels to time")
    parser.add_argument("--serve", action="store_true", help="also serve Gemma-2-2B and int4 Llama-3-8B, profiled")
    args = parser.parse_args()
    parts = [*args.kernels, *(["serve"] if args.serve else [])]
    parent = BUILD_DIR / "compare" / "parent"
    shutil.rmtree(parent, ignore_errors=True)
    shutil.copytree(args.parent / PACKAGE_DIR.name, parent / PACKAGE_DIR.name,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    runs = []
    for label, root in (("parent", parent), ("change", REPO_ROOT), ("change", REPO_ROOT), ("parent", parent)):
        result = run(root, parts)
        runs.append({"label": label, **result})
        print(f"{label} ({result['package']}): " + "; ".join(f"{k} {v:.4f}" for k, v in result["times"].items()),
              flush=True)
        for line in result["serve"]:
            print(f"{label}: {line}", flush=True)
    for case in runs[0]["times"]:
        by = {label: [r["times"][case] for r in runs if r["label"] == label] for label in ("parent", "change")}
        mean = {label: sum(v) / len(v) for label, v in by.items()}
        print(f"{case}: parent {mean['parent']:.4f} ms ({by['parent'][0]:.4f}, {by['parent'][1]:.4f}), change "
              f"{mean['change']:.4f} ms ({by['change'][0]:.4f}, {by['change'][1]:.4f}), change / parent "
              f"{mean['change'] / mean['parent']:.3f}", flush=True)
    print(json.dumps({"runs": runs}), flush=True)
    shutil.rmtree(BUILD_DIR / "compare", ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
