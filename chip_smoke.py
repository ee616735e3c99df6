# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Smoke run of the PyTorch/CUDA port (``conch_tpu_torch``) on one H100.

    python3 chip_smoke.py

1. prints the card's ``nvidia-smi`` name and power limit;
2. builds the kernels from ``conch_tpu_torch/csrc`` (one ``nvcc`` per
   source, all at once, then one link);
3. kernel phases: holds each hand-written kernel against its plain
   PyTorch version on the card, at the main paths' shapes, and times it
   (device time with the stream pre-filled, and paced by the host) beside
   its plain version, its bound and, where one exists, one PyTorch call
   computing the same function:
   - K1 int4 magic GEMM at the engine's four (K, N) at M 8, 32 (the
     engine's decode step, padded to max_batch_size 32) and 512, read from
     layer 17 of a 32-layer stack, at group 128 and group 64 (tolerance
     1e-2 x max |ref|, bit for bit across two calls);
   - K1b int8 planar GEMM and K8 int8 scaled GEMM at the int8 / w8a8
     engine's four fused (K, N) and lm_head (4096 x 128256), K1c NF4
     codebook GEMM at the nf4 engine's unfused shapes and lm_head, each at
     M 8, 32 and 512 from layer 17 of a 32-layer stack, with random codes
     over the full range (K8: row scales 10x apart end to end), tolerance
     1e-2 x max |ref|, K1b and K1c also bit for bit across two calls; plus
     small cases of the options the served path does not use (K1b 4-bit
     with per-group and scalar zero-points, K1c 8-bit rows with
     zero-points and the FP4 codebook, K8 float8_e4m3fn); each GEMM row
     keeps one layer's sums at each M (``by_m``: 4 GEMMs for K1, K1b and
     K8, 7 for K1c);
   - K1b and K1c over every option they take (``check_quant_gemm_options``,
     2808 small cases: 2-, 4- and 8-bit codes and the NF4 codebook, groups
     12 to 256, bf16 and f32 scales, zero-point modes 0, 1 and 2, M 8, 40
     and 130 with K split, x contiguous, with padded rows or realigned, f32
     and bf16 outputs), tolerance 1e-2 x max |ref|; K1 over every option it
     takes (``check_magic_gemm_options``, 576 cases: groups 64 and 128,
     biases 8, 0 and 15, stacked
     and single weights, M 1 to 600, x three ways, f32 and bf16 outputs;
     1e-2 x max |ref|, every case bit for bit across two calls);
   - K3 over every option it takes (``check_paged_attention_options``, 1008
     cases: bf16 and f32 queries over bf16, f32, int8 and e4m3 caches, GQA
     groups 1, 4 and 8, heads 34 to 256, softcap, windows 0, 37 and 500, one
     split and several, idle rows exactly zero, shared prefix pages, pages no
     row may see set to NaN; 3e-2, or 3e-2 + 3e-2 x |ref| on 1-byte caches;
     every case bit for bit across two calls), then one K3 call captured in
     a CUDA graph and replayed (equal to the eager call, also after
     seq_lens changed in place);
   - K7 over every option it takes (``check_varlen_attention_options``,
     1008 cases: K3's (query, cache) dtypes, groups and heads, causal and
     not, softcap, windows 0, 37 and 500, a ragged step with a decode row,
     a zero-length sequence and padding rows, shared prefix pages, pages no
     row may see set to NaN, several splits and one; 2e-2 + 2e-2 x |ref|,
     padding rows exactly zero, every case bit for bit across two calls),
     then one K7 call replayed from a CUDA graph (also after cu_seqlens_q
     and seq_lens changed in place);
   - K8's int8 path over every option it takes (``check_scaled_gemm_options``,
     522 cases: M 1 to 600, K 96 / N 160 and the served shapes, f32 and bf16
     outputs, scalar and vector scales, stacked and single weights, strided
     a, values near 127 whose split sums pass 2^24), each equal to the
     plain version bit for bit;
   - K11 over every option it takes (``check_mla_attention_options``, 1440
     cases: bf16 queries over bf16, int8 and e4m3 latent caches, f32
     queries over f32, int8 and e4m3 ones, 1, 3, 16 and 128 heads, latent
     128 to 512 and packed 128 to 896, causal or not, ragged decode and
     prefill steps at stage and split edges with idle and zero-length
     sequences, shared pages, padding rows after a real last sequence,
     ``max_seqlen_q`` above the real maximum, one split to eight), within
     K11's tolerances, every case twice, bit for bit; K12q over every
     option it takes (``check_quantize4_options``, 504 cases: blocksizes 2
     to 4096, f32 / bf16 / f16, nf4 and fp4, ragged tails, all-zero
     blocks, every threshold exactly, starts 16-, 8- and 4-byte aligned),
     byte for byte;
   - K12q NF4/FP4 encode on every weight the nf4 init quantizes (with an
     all-zero block), and on the gate projection at blocksize 4096 and
     from f16, byte for byte; K12d NF4/FP4 decode of the gate projection
     at blocksize 64 and 4096 into bf16, f32 and f16, bit for bit;
   - K2 cache write, K3 paged decode attention, K5 RoPE (timed at 8, 32 and
     512 Llama tokens, 8, 16 and 512 Gemma ones), K7 varlen prefill
     attention at Llama-3-8B's shapes (QH 32 / KH 8 / D 128, page 16, a
     32-layer pool read at a non-zero layer, decode batch 8 with an idle
     seq_len-0 row, a 128-row prefill of mixed lengths with a zero-length
     padding sequence and padding rows, pages shared between sequences),
     and again at Gemma-2-2B's (QH 8 / KH 4 / D 256, a 26-layer pool; K3
     and K7 with softcap 50 and scale 1/16, with and without the 4096
     window, at lengths past it, queries scaled so the logits reach the cap);
     K3 also at the decode steps the engines serve (``K3_SERVED_LLAMA``: 32
     rows, 8 live at 40 to 932; ``K3_SERVED_GEMMA``: 16 rows, 8 live at 4200
     to 6000, without and with the window; 1e-2 x (|ref| + the head's
     rms)), in its row's ``served``; every K3 case is built by
     ``k3_inputs`` from ``K3_CASES``;
   - K4 rms_norm at 8 and 512 rows x 4096 (and f32, f16 at 512), K4b
     fused_add_rms_norm in bf16 at 8 and 2048 rows x 4096 and in f32 and
     f16 at 2048 (the sum bit for bit, the output at
     tests/rms_norm_test.py's tolerances), K6 silu_and_mul on fused
     halves at 8 and 512 rows x 2 * 14336 and on parts;
   - K10a gemma_rms_norm at 8, 16 (Gemma-2-2B's decode step) and 512 rows x
     2304 in f32, f16 and bf16, timed beside ``F.rms_norm`` with the weight
     1 + w; K10b gelu_tanh_and_mul at 8 and 512 rows x 2 * 9216 (halves and
     parts), f32 and bf16;
   - K5 and K10a after their served predecessors (``row_kernel_pairs``: K5
     after Llama-3-8B's fused wqkv through K1 at 32 rows and through
     ``torch.matmul`` at 8, K10a after Gemma-2-2B's ``o_proj`` matmul at 16
     and 512 rows): the pair's device time minus the predecessor's, with and
     without the programmatic-dependent launch;
   - K5 over every option it takes (``check_rope_options``, 2304 cases: f32,
     bf16 and f16, heads (32, 8, 128), (8, 4, 256), (4, 1, 128) and (8, 8,
     64), whole, half and D - 28 rot_dims, 0 to 512 tokens, contiguous q/k,
     slices of a fused qkv block, rows or a base that break 16-byte
     alignment, positions past the cache, each with and without the
     programmatic-dependent launch) and K10a over every option it takes
     (``check_gemma_rms_norm_options``, 672 cases: f32, bf16 and f16, rows 0
     to 4096, hidden 128 to 4608 and 36872 (the looped path), strided and
     misaligned rows), at the JAX tests' tolerances;
   - K11 absorbed MLA at DeepSeek-V2-Lite's shapes (16 heads, packed
     640, latent 512, page 16, a 27-layer latent pool read at layer 13):
     a decode step of batch 8 at lengths 0 (an idle row) to 4000 and a
     512-row prefill step (chunked continuations, shared pages, padding
     sequences and rows), f32 at 2e-4 and bf16 at 3e-2 (+ the same x
     |ref|);
   - K9 static-scale int8 / e4m3 quantization through its public ops
     (``scaled_int8_quant``, ``scaled_fp8_quant``) at 8 and 512 rows x
     4096 and at 7 x 4097, from f32, bf16 and f16, byte for byte;
   - K3 and K7 with dequantization scales over an f32 cache (2e-3);
   - the int8 and e4m3 KV-cache branches: K2's quantizing store (byte for
     byte) and K3 / K7 at Llama's and Gemma's shapes (softcap, window),
     with k_scale != v_scale, and K11 over quantized latent caches, decode
     and prefill, bf16 queries, at 3e-2 (+ 3e-2 x |ref|; K7 2e-2);
   - K13a BEV pool forward and K13b backward at BEVFusion's nuScenes
     camera-to-BEV size (6 cameras, 118 depth bins x 32 x 88, a 360 x 360
     grid, 80 channels; 1.63 M of 1.99 M frustum points kept, sorted into
     intervals by cell) in f32 and bf16, and on small cases (shared cells,
     cells outside the grid, f16, C 5 and 6): K13a f32 at 1e-5 (+ 1e-5 x
     |ref|), bf16 / f16 at one rounding step x |ref|, K13b bit for bit;
     K13c NMS keep mask at 4096 boxes, IoU 0.5, tied scores, and at N 1,
     513, identical boxes and a lattice of touching boxes, bit for bit;
   - K14 ring all-gather on rings of 1, 2, 4 and 8 virtual ranks on the
     card (every rank's buffers its own), both launch modes (one
     cooperative launch; one launch per rank on its own stream), f32, bf16
     and int8, the TP-8 shard (64 x 4096) and a 1 x 4097 one, automatic
     and single blocks per rank; 100 back-to-back calls on one flag
     buffer; per-rank launches with ``torch.cuda._sleep`` ahead of some
     ranks; a deliberate 1 ms timeout that must set the error word; every
     result bit for bit against the plain version, the error word read
     after each phase; timed at 8 ranks x 64 x 4096 and 2048 x 4096 bf16;
   - K1, K1b and K1c storing f32 from bf16 activations
     (``mixed_precision_gemm(..., output_dtype=torch.float32)``) at K = N
     = 4096, M 8 and 512, at 1e-2 x max |ref|, timed beside the bf16
     store; a float16 output must raise, and a bfloat16 ``acc_dtype``
     (recorded only, as in JAX) must equal the f32 call bit for bit;
4. vision: ``generate_voxels`` and ``voxelization_stable`` with
   ``collect_point_features`` at PointPillars' KITTI size (120,000 points,
   3% on voxel boundaries) on the card, every output equal to the CPU's;
   then the vision path (``vision_bevfusion``): voxelize, BEV pool forward
   and ``loss.backward()`` at BEVFusion's size, NMS over 4096 boxes,
   through ``conch_tpu_torch.ops.vision``, with K13a, K13b and K13c's
   launches read around it;
   the QLoRA storage path (``llama3_8b_qlora``): every projection of
   Llama-3-8B's 32 layers and its lm_head (bf16 random weights, one layer
   at a time) through ``quantize_4bit(nf4, 64, compress_statistics=True)``
   and ``dequantize_4bit``, 225 launches each of K12q and K12d, every
   error within NF4's half-gap plus the double quantization's, and a
   profiled repeat of one layer; Llama-3-8B's residual stream through
   ``fused_add_rms_norm`` (``llama3_8b_residual_stream``: 64 calls at 2048
   x 4096 bf16, against the plain op's chain); and the collectives layer
   at Llama-3-8B's TP-8 shapes on 8 virtual ranks
   (``llama3_8b_tp8_collectives``: ``ring_all_gather`` of a 512-row and a
   16384-row chunk, K14 launched twice; ``overlapped_allgather_matmul``
   and ``overlapped_matmul_reduce_scatter`` in f32 and bf16 against the
   unsharded product, then timed);
5. slice phases: the first-token logits of 2-layer full-width prefills on
   the card against the plain path on the CPU (Llama-3-8B: bf16 weights in
   f32 and bf16, int4 at group 128 and 64, int8, nf4 and w8a8 weights in
   bf16; Gemma-2-2B: f32 and bf16, random norm weights; DeepSeek-V2-Lite,
   one dense and one MoE
   layer: f32 and bf16, random norm weights, and the MoE routing compared
   token by token, a divergence accepted only at a near tie; each family
   also in bf16 over an int8 and an e4m3 KV cache); then
   ``LLMEngine`` at full width (random
   weights from a seed) serving greedy requests of 32 tokens, with every
   kernel's launch count and the model steps read around the run, and the
   same requests repeated under torch.profiler (device time by kernel
   group, idle share):
   - Llama-3-8B bf16: 4 requests, ``EngineConfig(num_pages=2048,
     max_batch_size=8, max_prefill_tokens=128)``;
   - Llama-3-8B int4, the README's example: 16 requests of 40 to 900
     tokens, ``EngineConfig(num_pages=4096, max_batch_size=32)`` (512-row
     prefill steps);
   - the same int4 engine with the projections at group 64 (K1's group-64
     template): 8 requests of 40 to 900 tokens;
   - Llama-3-8B int8 (K1b), nf4 (K1c; K12q during the init) and w8a8 (K8),
     32 layers, every projection and lm_head in the mode: 8 requests of 40
     to 900 tokens each, ``EngineConfig(num_pages=4096, max_batch_size=32)``;
   - Gemma-2-2B bf16 (26 layers): 8 requests of 40
     to 4600 tokens, ``EngineConfig(num_pages=4096, max_batch_size=16,
     max_pages_per_seq=320)``, through ``gemma_prefill`` and
     ``gemma_decode_step``;
   - DeepSeek-V2-Lite bf16 (27 layers): 8 requests of 40 to 1800 tokens,
     ``EngineConfig(num_pages=4096, max_batch_size=16,
     max_pages_per_seq=128)``, through ``deepseek_prefill`` and
     ``deepseek_decode_step``;
   - over quantized KV caches (``LLMEngine(..., cache_dtype=...)``), each
     its twin above with only the cache changed: the int4 example over an
     int8 cache, bf16 Llama over an e4m3 cache, DeepSeek-V2-Lite over an
     e4m3 latent cache;
6. prints the ``kernels`` JSON line (each row's launches from its main
   run: Gemma for the kernels it runs, int4 for K1, K4 and K6, int8, nf4
   and w8a8 for K1b, K1c and K8, the nf4 init for K12q, DeepSeek for K11,
   K9's own phase for K9 (no served path runs it), the vision path for
   K13a, K13b and K13c, the QLoRA path for K12d, the residual stream for
   K4b, the TP-8 collectives path for K14; every path's counts
   beside them), the card line, then ``{"ok": true, "device": ...}`` as the
   last line.

Any failed check raises, so the script exits non-zero and prints no
result line. Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import itertools
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core peak
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores
SEED = 0
NUM_LAYERS_POOL = 32
LAYER = 17  # a non-zero layer inside the 32-layer pool
QH, KH, D, PS = 32, 8, 128, 16
MAX_PAGES_PER_SEQ = 64


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


SM_CYCLES_PER_S = 2.0e9  # above the H100's top SM clock, so a sleep of n cycles lasts at least n / 2e9 s


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, from CUDA events around ``iters``
    calls. A sleep kernel first holds the stream for twice the host time
    of the calls, so all of them are queued before the first one runs:
    the events time the device's work back to back, not the host's
    launch cost (``paced_ms`` times that)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * iters * host_s * SM_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def paced_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call as a caller sees it when the device waits
    on the host: CUDA events around ``iters`` calls issued one after the
    other from Python (wrapper, checks and launch included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float, ops_per_s: float = BF16_OPS_PER_S) -> tuple[float, str]:
    """Least time on the card: the larger of bytes / HBM rate and ops / the
    peak rate of their type (bf16 tensor cores unless given)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(name: str, err: float, tol: float) -> None:
    print(f"{name}: max_abs_err {err:.3e} (tolerance {tol:.1e})", flush=True)
    if not err <= tol:
        msg = f"{name}: max_abs_err {err} exceeds tolerance {tol}"
        raise AssertionError(msg)


def check_close(name: str, out: torch.Tensor, ref: torch.Tensor, tol: float) -> float:
    """Hold ``out`` to ``ref`` elementwise at ``|out - ref| <= tol + tol * |ref|``
    (the JAX tests' assert_allclose with atol = rtol = tol); returns the
    max abs error."""
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    print(f"{name}: max_abs_err {err:.3e} (tolerance {tol:.0e} + {tol:.0e} * |ref|)", flush=True)
    if not bool((diff <= tol + tol * ref.float().abs()).all()):
        msg = f"{name}: outside {tol} + {tol} * |ref| (max_abs_err {err})"
        raise AssertionError(msg)
    return err


def make_pool(
    gen: torch.Generator, num_pages: int, layers: int = NUM_LAYERS_POOL, kh: int = KH, d: int = D
) -> tuple[torch.Tensor, torch.Tensor]:
    shape = (layers, num_pages, kh, PS, d)
    kc = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(torch.bfloat16)
    vc = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(torch.bfloat16)
    return kc, vc


def paged_layout(
    rng: np.random.Generator, seq_lens: list[int], num_pages: int, share: tuple[int, int], shared_pages: int,
    max_pages: int = MAX_PAGES_PER_SEQ,
):
    """Block table (B, max_pages) with random distinct pages,
    entries past each sequence's pages left 0 (page 0 is a real page), and
    sequence ``share[1]`` reading the first ``shared_pages`` pages of
    ``share[0]`` (a prefix-cache hit)."""
    perm = iter(rng.permutation(np.arange(1, num_pages)).tolist())
    bt = np.zeros((len(seq_lens), max_pages), np.int32)
    for b, n in enumerate(seq_lens):
        for p in range(-(-n // PS)):
            bt[b, p] = next(perm)
    src, dst = share
    bt[dst, :shared_pages] = bt[src, :shared_pages]
    return bt


def unique_kv_rows(bt: np.ndarray, kv_lens: list[int], starts: list[int] | None = None) -> int:
    """Distinct cached (page, entry) rows that these sequences read: positions
    ``starts[b]`` (default 0) to ``kv_lens[b] - 1`` of each."""
    rows = set()
    for b, n in enumerate(kv_lens):
        start = starts[b] if starts else 0
        rows.update((int(bt[b, pos // PS]), pos % PS) for pos in range(start, n))
    return len(rows)


# Quantized KV caches in the kernel checks, and their (k_scale, v_scale):
# k != v, so a kernel that swapped them would fail. The int8 scales put
# N(0, 1) values over most of the int8 range.
KV_CACHES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
KV_SCALES = {"int8": (1 / 32, 1 / 16), "fp8": (1.5, 0.75)}


def quant_pool(gen, num_pages: int, layers: int, kh: int, d: int, cache: str) -> tuple[torch.Tensor, torch.Tensor]:
    """K and V pools of N(0, 1) values through the quantizing store at
    KV_SCALES[cache]; it clips, so no e4m3 NaN code is ever written."""
    from conch_tpu_torch.kernels.cache.reshape_and_cache import quantize_store

    shape = (layers, num_pages, kh, PS, d)
    return tuple(
        quantize_store(torch.randn(shape, generator=gen, device="cuda"), scale, KV_CACHES[cache])
        for scale in KV_SCALES[cache]
    )


def cache_bytes(t: torch.Tensor) -> torch.Tensor:
    """A quantized cache's raw bytes (comparable across e4m3 NaN codes)."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def kv_pools(gen, num_pages: int, layers: int, kh: int, d: int, cache: str | None):
    """bf16 K and V pools (``make_pool``), or int8 / e4m3 ones (``quant_pool``)."""
    return make_pool(gen, num_pages, layers, kh, d) if cache is None else quant_pool(gen, num_pages, layers, kh, d, cache)


def with_kv_scales(fn, cache: str | None):
    """``fn`` as it is for a bf16 pool; for an int8 / e4m3 one, called with
    KV_SCALES[cache] as its k_scale and v_scale."""
    if cache is None:
        return fn
    ks, vs = KV_SCALES[cache]
    return functools.partial(fn, k_scale=ks, v_scale=vs)


def kernel_phase_k2(
    gen, rng, qh: int = QH, kh: int = KH, d: int = D, layers: int = NUM_LAYERS_POOL, cache: str | None = None
) -> dict:
    """K2 into a bf16 pool, or with ``cache`` ("int8", "fp8") its quantizing
    store into such a pool at KV_SCALES[cache], held byte for byte."""
    from conch_tpu_torch.kernels.cache.reshape_and_cache import (
        reshape_and_cache_stacked_launcher as launch_kv,
        reshape_and_cache_stacked_plain as plain_kv,
    )

    num_pages, batch = 256, 8
    kc, vc = kv_pools(gen, num_pages, layers, kh, d, cache)
    launch, plain = with_kv_scales(launch_kv, cache), with_kv_scales(plain_kv, cache)

    # Decode batch of 8 taken from a fused qkv row block (strided k, v);
    # row 3 is idle (slot -1); rows 5 and 6 write the same page.
    qkv = torch.randn((batch, (qh + 2 * kh) * d), generator=gen, device="cuda").to(torch.bfloat16)
    k = qkv[:, qh * d : (qh + kh) * d].view(batch, kh, d)
    v = qkv[:, (qh + kh) * d :].view(batch, kh, d)
    pages = rng.permutation(np.arange(num_pages))[:batch]
    pages[6] = pages[5]
    entries = np.array([0, 15, 7, 0, 3, 9, 10, 1])
    slots = (pages * PS + entries).astype(np.int32)
    slots[3] = -1
    slot_t = torch.from_numpy(slots).cuda()
    kc_ref, vc_ref = kc.clone(), vc.clone()
    plain(k, v, kc_ref, vc_ref, slot_t, LAYER)
    launch(k, v, kc, vc, slot_t, LAYER)
    torch.cuda.synchronize()
    if cache is None:
        err = max((kc.float() - kc_ref.float()).abs().max().item(), (vc.float() - vc_ref.float()).abs().max().item())
        check(f"K2 reshape_and_cache_stacked KH={kh} D={d}", err, 0.0)
    else:
        err = float(sum(int((cache_bytes(a) != cache_bytes(b)).sum()) for a, b in ((kc, kc_ref), (vc, vc_ref))))
        check(f"K2 reshape_and_cache_stacked {cache} store KH={kh} D={d}: bytes differing", err, 0.0)
    valid = torch.from_numpy(np.nonzero(slots >= 0)[0]).cuda()
    vp = torch.from_numpy(slots[slots >= 0] // PS).long().cuda()
    ve = torch.from_numpy(slots[slots >= 0] % PS).long().cuda()
    kv_valid, vv_valid = k[valid], v[valid]

    def library():
        kc[LAYER, vp, :, ve] = kv_valid
        vc[LAYER, vp, :, ve] = vv_valid

    n_valid = int((slots >= 0).sum())
    # K and V rows: read in bf16, written in the cache's element size.
    bytes_moved = 2 * n_valid * kh * d * (2 + kc.element_size()) + batch * 4
    bound_ms, bound_by = bound(bytes_moved, 0)
    return {
        "name": "reshape_and_cache_stacked", "route": "cuda", "source": "conch_tpu_torch/csrc/reshape_and_cache.cu",
        "replaces": "conch_tpu/kernels/cache/reshape_and_cache.py:37", "max_abs_err": err,
        "ms": time_ms(lambda: launch(k, v, kc, vc, slot_t, LAYER)),
        "paced_ms": paced_ms(lambda: launch(k, v, kc, vc, slot_t, LAYER)),
        "plain_ms": time_ms(lambda: plain(k, v, kc, vc, slot_t, LAYER)),
        # One indexed assignment writes the bf16 rows; no single PyTorch call quantizes on store.
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": time_ms(library) if cache is None else None,
    }


# K5's timed steps: the kernel table's decode step of 8 tokens (the row's
# numbers), then Llama-3-8B's padded decode step of the quantized engines
# and a 512-row prefill chunk, Gemma-2-2B's decode step and a 512-row chunk.
K5_TOKENS = {"llama": (8, 32, 512), "gemma": (8, 16, 512)}


def k5_bound(tokens: int, qh: int, kh: int, d: int, itemsize: int = 2) -> tuple[float, str]:
    """K5's bound: q and k read and written once, one f32 cache row and a
    position a token; 3 operations an element."""
    return bound(2 * tokens * (qh + kh) * d * itemsize + tokens * d * 4 + tokens * 4, tokens * (qh + kh) * d * 3)


def kernel_phase_k5(gen, rng, qh: int = QH, kh: int = KH, d: int = D, theta: float = 500000.0,
                    timed_tokens: tuple[int, ...] = K5_TOKENS["llama"]) -> dict:
    """K5 on slices of a fused bf16 qkv row block at ``timed_tokens`` and a
    128-row chunk (2e-2), each step timed beside its bound and plain
    version (``detail``); the row has the first step's numbers."""
    from conch_tpu_torch.kernels.embedding.rotary_embedding import (
        rotary_embedding_launcher as launch,
        rotary_embedding_plain as plain,
    )
    from conch_tpu_torch.reference.embedding.rotary_embedding import compute_cos_sin_cache

    cache = compute_cos_sin_cache(theta, d, 8192, device="cuda")
    err, detail = 0.0, []
    for tokens in (*timed_tokens, 128):
        qkv = torch.randn((tokens, (qh + 2 * kh) * d), generator=gen, device="cuda").to(torch.bfloat16)
        q, k = qkv[:, : qh * d], qkv[:, qh * d : (qh + kh) * d]
        pos = torch.from_numpy(rng.integers(0, 8192, size=tokens).astype(np.int32)).cuda()
        q_k, k_k = launch(pos, q, k, d, cache)
        q_p, k_p = plain(pos, q, k, d, cache)
        torch.cuda.synchronize()
        e = max((q_k.float() - q_p.float()).abs().max().item(), (k_k.float() - k_p.float()).abs().max().item())
        err = max(err, e)
        if tokens in timed_tokens:
            b_ms, b_by = k5_bound(tokens, qh, kh, d)
            detail.append({
                "tokens": tokens, "max_abs_err": e, "bound_ms": b_ms, "bound_by": b_by,
                "ms": time_ms(lambda: launch(pos, q, k, d, cache)),
                "paced_ms": paced_ms(lambda: launch(pos, q, k, d, cache)),
                "plain_ms": time_ms(lambda: plain(pos, q, k, d, cache)), "library_ms": None,
            })
    check(f"K5 rotary_embedding QH={qh} KH={kh} D={d}", err, 2e-2)
    for x in detail:
        print(f"K5 QH={qh} KH={kh} D={d} tokens={x['tokens']}: {x['ms']:.4f} ms (paced {x['paced_ms']:.4f}, plain "
              f"{x['plain_ms']:.4f}, bound {x['bound_ms']:.6f} by {x['bound_by']})", flush=True)
    row = _kernel_row(
        "rotary_embedding", "conch_tpu_torch/csrc/rotary_embedding.cu",
        "conch_tpu/kernels/embedding/rotary_embedding.py:34", err, detail[0], detail[0]["bound_ms"],
        detail[0]["bound_by"],
    )
    row["detail"] = detail
    return row


PAIR_ITERS = 200


def pair_timings(name: str, pred, kernel, launcher) -> dict:
    """``kernel`` after its served predecessor ``pred``: the device time of
    the pair (``kernel(pred())``) minus ``pred()``'s alone, each from one
    ``time_ms`` call of PAIR_ITERS launches, with and without the kernel's
    programmatic-dependent launch (``launcher.pdl``), and the kernel alone
    back to back both ways (there it overlaps its own previous launch)."""
    saved = launcher.pdl
    out = pred()
    res = {"case": name}
    try:
        for pdl in (False, True, False, True):
            launcher.pdl = pdl
            tag = "pdl" if pdl else "no_pdl"
            pred_ms = time_ms(pred, iters=PAIR_ITERS)
            pair_ms = time_ms(lambda: kernel(pred()), iters=PAIR_ITERS)
            alone_ms = time_ms(lambda: kernel(out), iters=PAIR_ITERS)
            for key, value in (("pred_ms", pred_ms), ("pair_ms", pair_ms), ("after_pred_ms", pair_ms - pred_ms),
                               ("alone_ms", alone_ms)):
                res.setdefault(f"{tag}_{key}", []).append(value)
    finally:
        launcher.pdl = saved
    print(f"{name}: after the predecessor (pair - predecessor) without PDL "
          f"{', '.join(f'{v:.4f}' for v in res['no_pdl_after_pred_ms'])} ms, with PDL "
          f"{', '.join(f'{v:.4f}' for v in res['pdl_after_pred_ms'])}; predecessor "
          f"{res['no_pdl_pred_ms'][0]:.4f}; alone without / with PDL "
          f"{res['no_pdl_alone_ms'][0]:.4f} / {res['pdl_alone_ms'][0]:.4f} ms", flush=True)
    return res


def row_kernel_pairs(gen, rng, by_name: dict) -> None:
    """K5 and K10a after their served predecessors (``pair_timings``): K5
    after Llama-3-8B's fused wqkv through K1 (int4, group 128, the engine's
    32-row decode step) and through ``torch.matmul`` (bf16, 8 rows); K10a
    after Gemma-2-2B's bf16 ``o_proj`` ``torch.matmul`` at 16 and 512 rows.
    The results go into the rows' ``after_predecessor``."""
    from conch_tpu_torch.kernels.embedding.rotary_embedding import rotary_embedding_launcher as rope
    from conch_tpu_torch.kernels.normalization.gemma_rms_norm import gemma_rms_norm_launcher as norm
    from conch_tpu_torch.kernels.quantization.gemm import mixed_gemm_magic_launcher as k1
    from conch_tpu_torch.reference.embedding.rotary_embedding import compute_cos_sin_cache

    k, n = K1_SHAPES[0]
    cache = compute_cos_sin_cache(500000.0, D, 8192, device="cuda")
    packed = torch.randint(-(2**31), 2**31 - 1, (1, k // 8, n), generator=gen, device="cuda", dtype=torch.int32)
    scales = (torch.rand((1, k // GROUP, n), generator=gen, device="cuda") * 4e-3 + 1e-4).to(torch.bfloat16)
    w_qkv = (0.02 * torch.randn((k, n), generator=gen, device="cuda")).to(torch.bfloat16)

    def rope_after(out, pos):
        return rope(pos, out[:, : QH * D], out[:, QH * D : (QH + KH) * D], D, cache)

    rope_pairs = []
    for m, label in ((32, "K1 int4 wqkv, 32 rows"), (8, "torch.matmul bf16 wqkv, 8 rows")):
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        pos = torch.from_numpy(rng.integers(0, 8192, size=m).astype(np.int32)).cuda()
        pred = (lambda x=x: k1(x, packed, scales, GROUP, 8, 0)) if m == 32 else (lambda x=x: torch.matmul(x, w_qkv))
        rope_pairs.append(pair_timings(f"K5 after {label}", pred, lambda out, pos=pos: rope_after(out, pos), rope))
    by_name["rotary_embedding"]["after_predecessor"] = rope_pairs
    w_o = (0.02 * torch.randn((2048, G_HIDDEN), generator=gen, device="cuda")).to(torch.bfloat16)
    w = (0.5 * torch.randn((G_HIDDEN,), generator=gen, device="cuda")).to(torch.bfloat16)
    norm_pairs = []
    for m in (16, 512):
        x = torch.randn((m, 2048), generator=gen, device="cuda").to(torch.bfloat16)
        norm_pairs.append(pair_timings(f"K10a after torch.matmul bf16 o_proj, {m} rows",
                                       lambda x=x: torch.matmul(x, w_o), lambda out: norm(out, w, 1e-6), norm))
    by_name["gemma_rms_norm"]["after_predecessor"] = norm_pairs


# K5's options (check_rope_options): head shapes (Llama-3-8B, Gemma-2-2B,
# JAX's test shapes), three rot_dims each (whole, half, and rot_dim / 2 not
# a multiple of 8: D - 28), token counts, q/k layouts (contiguous, slices
# of a fused qkv block, fused rows one element longer, contiguous rows from
# a base one element off), positions from -64 to past the cache.
ROPE_OPTION_HEADS = ((32, 8, 128), (8, 4, 256), (4, 1, 128), (8, 8, 64))
ROPE_OPTION_TOKENS = (0, 1, 7, 8, 16, 32, 128, 512)
ROPE_OPTION_LAYOUTS = ("contiguous", "fused", "misaligned rows", "misaligned base")
ROPE_OPTION_POSITIONS = 4096
# tests/rotary_embedding_test.py's tolerances (atol and rtol); bf16's is the K5 phase's 2e-2.
ROPE_TOLERANCES = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 1e-3}


def _flat_rows(gen, rows: int, width: int, dtype: torch.dtype, layout: str, row_stride: int | None = None):
    """A (rows, width) tensor of N(0, 1) values in ``dtype``: contiguous;
    rows at ``row_stride`` (``layout`` "strided"); rows one element longer
    than ``row_stride`` or width ("misaligned rows"); or contiguous rows from
    a base one element past a 16-byte boundary ("misaligned base")."""
    stride = row_stride or width
    if layout == "misaligned base":
        flat = torch.randn((rows * width + 1,), generator=gen, device="cuda").to(dtype)
        return flat[1:].view(rows, width)
    if layout == "misaligned rows":
        stride += 1
    if layout in ("strided", "misaligned rows"):
        return torch.randn((rows, stride), generator=gen, device="cuda").to(dtype)[:, :width]
    return torch.randn((rows, width), generator=gen, device="cuda").to(dtype)


def check_rope_options(gen, rng) -> None:
    """K5 over every option it takes (ROPE_OPTION_*: f32, bf16 and f16,
    each case with and without the programmatic-dependent launch) against
    the plain version at ROPE_TOLERANCES, both outputs contiguous and of
    their input's shape; counts the cases on each path of ``rope_plan``."""
    from conch_tpu_torch.kernels.common import aligned16
    from conch_tpu_torch.kernels.embedding.rotary_embedding import (
        rope_plan,
        rotary_embedding_launcher as launch,
        rotary_embedding_plain as plain,
    )
    from conch_tpu_torch.reference.embedding.rotary_embedding import compute_cos_sin_cache

    saved, failed, paths, cases, exact, err = launch.pdl, [], {}, 0, 0, {}
    try:
        for (qh, kh, d), dtype in itertools.product(ROPE_OPTION_HEADS, ROPE_TOLERANCES):
            tol = ROPE_TOLERANCES[dtype]
            for rot in (d, d // 2, d - 28):
                cache = compute_cos_sin_cache(10000.0, rot, ROPE_OPTION_POSITIONS, device="cuda")
                for tokens, layout in itertools.product(ROPE_OPTION_TOKENS, ROPE_OPTION_LAYOUTS):
                    if layout in ("fused", "misaligned rows"):
                        qkv = _flat_rows(gen, tokens, (qh + 2 * kh) * d, dtype, layout)
                        q, k = qkv[:, : qh * d], qkv[:, qh * d : (qh + kh) * d]
                    else:
                        q = _flat_rows(gen, tokens, qh * d, dtype, layout)
                        k = _flat_rows(gen, tokens, kh * d, dtype, layout)
                    pos = torch.from_numpy(rng.integers(-64, ROPE_OPTION_POSITIONS + 64, size=tokens).astype(
                        np.int32)).cuda()
                    plan = rope_plan(tokens, qh, kh, d, rot, q.element_size(), q.stride(0), k.stride(0),
                                     aligned16(q, k))
                    ref = plain(pos, q, k, d, cache)
                    for pdl in (False, True):
                        launch.pdl = pdl
                        got = launch(pos, q, k, d, cache)
                        name = f"{dtype} QH {qh} KH {kh} D {d} rot {rot} tokens {tokens} {layout} pdl {pdl}"
                        cases += 1
                        paths[plan.path] = paths.get(plan.path, 0) + 1
                        e = 0.0
                        for g, r in zip(got, ref):
                            if g.shape != r.shape or not g.is_contiguous():
                                failed.append(f"{name}: shape {tuple(g.shape)}")
                            elif tokens:
                                diff = (g.float() - r.float()).abs()
                                e = max(e, diff.max().item())
                                if not bool((diff <= tol + tol * r.float().abs()).all()):
                                    failed.append(f"{name}: max_abs_err {diff.max().item():.3e}")
                        err[dtype] = max(err.get(dtype, 0.0), e)
                        exact += e == 0.0
    finally:
        launch.pdl = saved
    torch.cuda.synchronize()
    print(f"K5 options: {cases} cases ({paths.get(0, 0)} on the vector path, {paths.get(1, 0)} scalar), "
          f"{exact} equal to the plain version bit for bit; max_abs_err "
          + ", ".join(f"{dt} {e:.3e} (tolerance {ROPE_TOLERANCES[dt]:.0e} + {ROPE_TOLERANCES[dt]:.0e} * |ref|)"
                      for dt, e in err.items()), flush=True)
    if failed:
        raise AssertionError(f"K5 options: {len(failed)} of {cases} cases failed: " + "; ".join(failed[:10]))


def kernel_phase_k3(gen, rng, cache: str | None = None) -> dict:
    """K3 on Llama-3-8B's table line (K3_CASES) over a bf16 pool, or over
    an int8 / e4m3 one (``cache``) with KV_SCALES[cache] (held at 3e-2 +
    3e-2 x |ref|)."""
    from conch_tpu_torch.kernels.attention.paged_attention import (
        paged_attention_launcher as launch_kv,
        paged_attention_plain as plain_kv,
    )

    case = k3_inputs(gen, rng, "llama3_8b table line", cache)
    launch, plain = with_kv_scales(launch_kv, cache), with_kv_scales(plain_kv, cache)
    args = (*case["args"], 0)
    out_k = launch(*args)
    out_p = plain(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(out_k).all() or out_k[case["idle"]].abs().max().item() != 0.0:
        raise AssertionError("K3: the idle row must come out as finite zeros")
    if cache is None:
        err = (out_k.float() - out_p.float()).abs().max().item()
        check("K3 paged_attention", err, 3e-2)
    else:
        err = check_close(f"K3 paged_attention {cache} cache", out_k, out_p, 3e-2)
    bound_ms, bound_by = k3_bound(case, 0)
    return {
        "name": "paged_attention", "route": "cuda", "source": "conch_tpu_torch/csrc/paged_attention.cu",
        "replaces": "conch_tpu/kernels/attention/paged_attention.py:57", "max_abs_err": err,
        "ms": time_ms(lambda: launch(*args)),
        "paced_ms": paced_ms(lambda: launch(*args)),
        "plain_ms": time_ms(lambda: plain(*args), iters=5),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def kernel_phase_k7(gen, rng, cache: str | None = None) -> dict:
    """K7 at Llama-3-8B's table line (K7_CASES) over a bf16 pool, or over an
    int8 / e4m3 one (``cache``) with KV_SCALES[cache] (held at 2e-2 + 2e-2
    x |ref|); padding rows exactly zero."""
    from conch_tpu_torch.kernels.attention.varlen_attention import (
        varlen_attention_launcher as launch_kv,
        varlen_attention_plain as plain_kv,
    )

    case = k7_inputs(gen, rng, "llama3_8b table line", cache)
    launch, plain = with_kv_scales(launch_kv, cache), with_kv_scales(plain_kv, cache)
    args = (*case["args"], 0)
    out_k = launch(*args)
    out_p = plain(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(out_k).all() or out_k[case["total"]:].abs().max().item() != 0.0:
        raise AssertionError("K7: padding rows must come out as finite zeros")
    if cache is None:
        err = (out_k.float() - out_p.float()).abs().max().item()
        check("K7 varlen_attention", err, 2e-2)
    else:
        err = check_close(f"K7 varlen_attention {cache} cache", out_k, out_p, 2e-2)
    bound_ms, bound_by = k7_bound(case, 0)
    return {
        "name": "varlen_attention", "route": "cuda", "source": "conch_tpu_torch/csrc/varlen_attention.cu",
        "replaces": "conch_tpu/kernels/attention/varlen_attention.py:247", "max_abs_err": err,
        "ms": time_ms(lambda: launch(*args)),
        "paced_ms": paced_ms(lambda: launch(*args)),
        "plain_ms": time_ms(lambda: plain(*args), iters=5),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


# Engine shapes of K1 (K, N): fused wqkv, wo, fused gate|up, w_down.
K1_SHAPES = ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096))
# Rows of the timed GEMM cases: a decode step of 8, the engine's decode step
# (padded to max_batch_size 32) and a 512-row prefill chunk.
GEMM_MS = (8, 32, 512)
GROUP = 128
HIDDEN, INTER = 4096, 14336


def _kernel_row(name: str, source: str, replaces: str, err: float, timed: dict, bound_ms: float, bound_by: str) -> dict:
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "max_abs_err": err,
        "ms": timed["ms"], "paced_ms": timed["paced_ms"], "plain_ms": timed["plain_ms"], "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": timed["library_ms"],
    }


def _k1_cases(gen, group: int) -> list[dict]:
    """K1 at the engine's four (K, N), M in GEMM_MS, layer 17 of a 32-layer
    stack, at ``group``: checked against the plain version (tolerance 1e-2
    x max |ref|), bit for bit across two calls, and timed beside it and a
    bf16 matmul on the dequantized weight."""
    from conch_tpu_torch.kernels.common import sm_count
    from conch_tpu_torch.kernels.quantization.gemm import (
        dequantize_magic,
        mixed_gemm_magic_launcher as launch,
        mixed_gemm_magic_plain as plain,
        quant_gemm_plan,
    )

    detail = []
    for k, n in K1_SHAPES:
        packed = torch.randint(-(2**31), 2**31 - 1, (NUM_LAYERS_POOL, k // 8, n), generator=gen, device="cuda",
                               dtype=torch.int32)
        scales = (torch.rand((NUM_LAYERS_POOL, k // group, n), generator=gen, device="cuda") * 4e-3 + 1e-4).to(
            torch.bfloat16)
        # Timed calls walk the 32 layers (library: 3 dense copies), so the
        # weights come from HBM as in a model step, not from the 50 MB L2.
        dense = [dequantize_magic(packed[i], scales[i], k, group, 8).to(torch.bfloat16) for i in (LAYER, 0, 31)]
        layers, copies = itertools.cycle(range(NUM_LAYERS_POOL)), itertools.cycle(dense)
        for m in GEMM_MS:
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            out_k = launch(x, packed, scales, group, 8, LAYER)
            out_p = plain(x, packed, scales, group, 8, LAYER)
            torch.cuda.synchronize()
            scale = out_p.float().abs().max().item()
            e = (out_k.float() - out_p.float()).abs().max().item()
            check(f"K1 mixed_gemm_magic group {group} M={m} K={k} N={n} (max|ref| {scale:.3f})", e, 1e-2 * scale)
            check_repeatable(f"K1 mixed_gemm_magic group {group} M={m} K={k} N={n}",
                             lambda: launch(x, packed, scales, group, 8, LAYER))
            plan = quant_gemm_plan("magic", m, n, k, 4, group, sm_count(0))
            bytes_moved = m * k * 2 + k * n // 2 + (k // group) * n * 2 + m * n * 2
            b_ms, b_by = bound(bytes_moved, 2 * m * n * k)
            detail.append({
                "group": group, "m": m, "k": k, "n": n, "max_abs_err": e, "bound_ms": b_ms, "bound_by": b_by,
                "plan": dataclasses.asdict(plan),
                "ms": time_ms(lambda: launch(x, packed, scales, group, 8, next(layers))),
                "paced_ms": paced_ms(lambda: launch(x, packed, scales, group, 8, next(layers))),
                "plain_ms": time_ms(lambda: plain(x, packed, scales, group, 8, next(layers)), iters=5),
                "library_ms": time_ms(lambda: torch.matmul(x, next(copies))),
            })
        del packed, scales, dense
        torch.cuda.empty_cache()
    for d in detail:
        print(f"K1 group {group} M={d['m']} K={d['k']} N={d['n']}: {d['ms']:.4f} ms (paced {d['paced_ms']:.4f}, plain {d['plain_ms']:.4f}, bf16 matmul {d['library_ms']:.4f}, bound "
              f"{d['bound_ms']:.5f} by {d['bound_by']}; splits {d['plan']['splits']})", flush=True)
    return detail


def _decode_sums(detail: list[dict], m: int = 8) -> dict:
    """One layer's four GEMMs at ``m`` rows: each time and the bound summed."""
    decode = [d for d in detail if d["m"] == m]
    keys = ("ms", "paced_ms", "plain_ms", "library_ms", "bound_ms")
    return {key: sum(d[key] for d in decode) for key in keys}


def kernel_phase_k1(gen) -> dict:
    """K1 at the engine's four (K, N) at M = 8, 32 (the engine's decode
    step) and 512 (a prefill chunk), read from layer 17 of a 32-layer
    stack, at group 128 (the README's int4) and group 64. The row's numbers
    are the group-128 sums over the four shapes at M = 8 (one layer's
    projections in a decode step of 8); ``by_m`` has them at each M,
    ``group64`` the M = 8 sums at group 64, ``group64_by_m`` those at each
    M, and ``detail`` every case."""
    detail = _k1_cases(gen, 128) + _k1_cases(gen, 64)
    timed = _decode_sums([d for d in detail if d["group"] == 128])
    row = _kernel_row(
        "mixed_gemm_magic", "conch_tpu_torch/csrc/mixed_gemm_magic.cu", "conch_tpu/kernels/quantization/gemm.py:658",
        max(d["max_abs_err"] for d in detail), timed, timed["bound_ms"], "bytes",
    )
    row["group64"] = _decode_sums([d for d in detail if d["group"] == 64])
    row["by_m"] = {m: _decode_sums([d for d in detail if d["group"] == 128], m) for m in GEMM_MS}
    row["group64_by_m"] = {m: _decode_sums([d for d in detail if d["group"] == 64], m) for m in GEMM_MS}
    for group, by_m in ((128, row["by_m"]), (64, row["group64_by_m"])):
        for m, sums in by_m.items():
            print(f"mixed_gemm_magic group {group} one layer at M={m}: {sums['ms']:.4f} ms (library "
                  f"{sums['library_ms']:.4f}, bound {sums['bound_ms']:.5f})", flush=True)
    print(f"K1 one layer at M=8: group 128 {timed['ms']:.4f} ms, group 64 {row['group64']['ms']:.4f} ms", flush=True)
    row["detail"] = detail
    return row


# Engine shapes (K, N) of the quantized modes at Llama-3-8B, with the
# count of each in one layer: int8 (K1b) and w8a8 (K8) fuse wqkv and
# gate|up; nf4 (K1c) stays unfused (its ``shape`` meta refuses concat_n,
# as in the JAX package). lm_head (4096 x 128256) is timed apart.
FUSED_LAYER_SHAPES = {(4096, 6144): 1, (4096, 4096): 1, (4096, 28672): 1, (14336, 4096): 1}
NF4_LAYER_SHAPES = {(4096, 4096): 2, (4096, 1024): 2, (4096, 14336): 2, (14336, 4096): 1}
LM_HEAD = (4096, 128256)
NF4_BLOCK = 64


def _time_case(launch, plain, library, m: int, k: int, n: int, err: float, bytes_moved: float, ops: float,
               ops_per_s: float = BF16_OPS_PER_S, **extra) -> dict:
    b_ms, b_by = bound(bytes_moved, ops, ops_per_s)
    return {
        "m": m, "k": k, "n": n, "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
        "ms": time_ms(launch), "paced_ms": paced_ms(launch), "plain_ms": time_ms(plain, iters=3, warmup=1),
        "library_ms": None if library is None else time_ms(library), **extra,
    }


def _layer_sums(detail: list, counts: dict, m: int) -> dict:
    """One layer's GEMMs at ``m`` rows: each shape's times and bound times its
    count in a layer, summed."""
    cases = [d for d in detail if d["m"] == m and (d["k"], d["n"]) in counts]
    sums = {
        key: sum(d[key] * counts[(d["k"], d["n"])] for d in cases)
        for key in ("ms", "paced_ms", "plain_ms", "library_ms", "bound_ms") if all(d[key] is not None for d in cases)
    }
    sums.setdefault("library_ms", None)
    return sums


def _layer_row(name: str, source: str, replaces: str, err: float, detail: list, counts: dict) -> dict:
    """A kernel row whose numbers are one layer's GEMMs at M = 8 (each shape
    times its count in a layer); ``by_m`` has the same sums at each of
    ``GEMM_MS`` and ``detail`` keeps every case."""
    timed = _layer_sums(detail, counts, 8)
    row = _kernel_row(name, source, replaces, err, timed, timed["bound_ms"], "bytes")
    row["by_m"] = {m: _layer_sums(detail, counts, m) for m in GEMM_MS}
    row["detail"] = detail
    for d in detail:
        print(f"{name} M={d['m']} K={d['k']} N={d['n']}: {d['ms']:.4f} ms (paced {d['paced_ms']:.4f}, plain "
              f"{d['plain_ms']:.4f}, library {d['library_ms']}, bound {d['bound_ms']:.5f} by {d['bound_by']})",
              flush=True)
    for m, sums in row["by_m"].items():
        print(f"{name} one layer at M={m}: {sums['ms']:.4f} ms (library {sums['library_ms']}, bound "
              f"{sums['bound_ms']:.5f})", flush=True)
    return row


def check_repeatable(name: str, launch) -> None:
    """Two calls of ``launch`` on the same inputs must agree bit for bit."""
    first, second = launch(), launch()
    torch.cuda.synchronize()
    if not torch.equal(first, second):
        diff = (first.float() - second.float()).abs().max().item()
        raise AssertionError(f"{name}: two calls on the same inputs differ (max {diff})")
    print(f"{name}: two calls bit for bit equal", flush=True)


def _stack_cycle(n_layers: int = NUM_LAYERS_POOL):
    """Timed calls walk the layers of a stack, so its weights come from HBM
    as in a model step, not from the 50 MB L2."""
    return itertools.cycle(range(n_layers))


def kernel_phase_k1b(gen) -> dict:
    """K1b (int8 planar, uint8b128, group 128, bf16 scales) at the int8
    engine's shapes, M in GEMM_MS, layer 17 of a 32-layer stack (lm_head
    unstacked), random codes over the full range, bit for bit across two
    calls; plus 4-bit with per-group and with scalar zero-points. Tolerance
    1e-2 x max |ref|. Library: a bf16 matmul on the dequantized weight."""
    from conch_tpu_torch.kernels.quantization.gemm import (
        mixed_gemm_planar_launcher as launch,
        mixed_gemm_planar_plain as plain,
    )
    from conch_tpu_torch.utils.quant_utils import unpack_rows_planar

    def dequant(packed, scales, k, bits, bias, zp=None):
        codes = unpack_rows_planar(packed, bits, k, GROUP).float()
        z = float(bias) if zp is None else (zp.reshape(()) if zp.numel() == 1 else zp.repeat_interleave(GROUP, 0))
        return ((codes - z) * scales.float().repeat_interleave(GROUP, 0)).to(torch.bfloat16)

    err, detail = 0.0, []
    for (k, n) in (*FUSED_LAYER_SHAPES, LM_HEAD):
        layers = NUM_LAYERS_POOL if (k, n) != LM_HEAD else None
        lead = () if layers is None else (layers,)
        packed = torch.randint(-(2**31), 2**31 - 1, (*lead, k // 4, n), generator=gen, device="cuda", dtype=torch.int32)
        scales = (torch.rand((*lead, k // GROUP, n), generator=gen, device="cuda") * 4e-3 + 1e-4).to(torch.bfloat16)
        li = None if layers is None else LAYER
        cyc = _stack_cycle() if layers else itertools.repeat(None)
        one = packed if layers is None else packed[LAYER]
        dense = dequant(one, scales if layers is None else scales[LAYER], k, 8, 128)
        for m in GEMM_MS:
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            out_k = launch(x, packed, scales, None, 8, 128, GROUP, li)
            out_p = plain(x, packed, scales, None, 8, 128, GROUP, li)
            torch.cuda.synchronize()
            scale = out_p.float().abs().max().item()
            e = (out_k.float() - out_p.float()).abs().max().item()
            check(f"K1b mixed_gemm_planar int8 M={m} K={k} N={n} (max|ref| {scale:.3f})", e, 1e-2 * scale)
            check_repeatable(f"K1b mixed_gemm_planar int8 M={m} K={k} N={n}",
                             lambda: launch(x, packed, scales, None, 8, 128, GROUP, li))
            err = max(err, e)
            bytes_moved = m * k * 2 + k * n + (k // GROUP) * n * 2 + m * n * 2
            detail.append(_time_case(
                lambda: launch(x, packed, scales, None, 8, 128, GROUP, next(cyc)),
                lambda: plain(x, packed, scales, None, 8, 128, GROUP, li),
                lambda: torch.matmul(x, dense), m, k, n, e, bytes_moved, 2 * m * n * k,
            ))
        del packed, scales, dense
        torch.cuda.empty_cache()
    # Options the served path does not use: 4-bit planar with per-group and
    # with scalar zero-points (which replace the bias, as in the TPU kernel).
    k, n = 1024, 512
    packed = torch.randint(-(2**31), 2**31 - 1, (3, k // 8, n), generator=gen, device="cuda", dtype=torch.int32)
    scales = (torch.rand((3, k // GROUP, n), generator=gen, device="cuda") * 4e-3 + 1e-4).to(torch.bfloat16)
    zps = {
        "per-group": torch.randint(0, 16, (3, k // GROUP, n), generator=gen, device="cuda").float(),
        "scalar": torch.tensor([7.0], device="cuda"),
    }
    for label, zp in zps.items():
        for m in (8, 40):
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            out_k, out_p = launch(x, packed, scales, zp, 4, 8, GROUP, 1), plain(x, packed, scales, zp, 4, 8, GROUP, 1)
            scale = out_p.float().abs().max().item()
            e = (out_k.float() - out_p.float()).abs().max().item()
            check(f"K1b mixed_gemm_planar 4-bit {label} zero-points M={m} (max|ref| {scale:.3f})", e, 1e-2 * scale)
            err = max(err, e)
    return _layer_row(
        "mixed_gemm_planar", "conch_tpu_torch/csrc/mixed_gemm_planar.cu", "conch_tpu/kernels/quantization/gemm.py:582",
        err, detail, FUSED_LAYER_SHAPES,
    )


def kernel_phase_k1c(gen) -> dict:
    """K1c (NF4 codebook over GPTQ rows, f32 absmax per 64 rows) at the nf4
    engine's unfused shapes, M in GEMM_MS, layer 17 of a 32-layer stack
    (lm_head unstacked), random codes, bit for bit across two calls; plus
    8-bit GPTQ rows with per-group zero-points and the FP4 codebook.
    Tolerance 1e-2 x max |ref|. Library: a bf16 matmul on the dequantized
    weight."""
    from conch_tpu_torch.kernels.quantization.bitsandbytes.blockwise import FP4_MAGNITUDE_CODE, NF4_CODE
    from conch_tpu_torch.kernels.quantization.gemm import (
        dequantize_rows,
        mixed_gemm_rows_launcher as launch,
        mixed_gemm_rows_plain as plain,
    )

    err, detail = 0.0, []
    for (k, n) in (*NF4_LAYER_SHAPES, LM_HEAD):
        layers = NUM_LAYERS_POOL if (k, n) != LM_HEAD else None
        lead = () if layers is None else (layers,)
        packed = torch.randint(-(2**31), 2**31 - 1, (*lead, k // 8, n), generator=gen, device="cuda", dtype=torch.int32)
        absmax = torch.rand((*lead, k // NF4_BLOCK, n), generator=gen, device="cuda") * 0.09 + 0.01
        li = None if layers is None else LAYER
        cyc = _stack_cycle() if layers else itertools.repeat(None)
        one = (packed, absmax) if layers is None else (packed[LAYER], absmax[LAYER])
        dense = dequantize_rows(*one, None, k, 4, 0, NF4_BLOCK, NF4_CODE).to(torch.bfloat16)
        for m in GEMM_MS:
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            out_k = launch(x, packed, absmax, None, 4, 0, NF4_BLOCK, NF4_CODE, li)
            out_p = plain(x, packed, absmax, None, 4, 0, NF4_BLOCK, NF4_CODE, li)
            torch.cuda.synchronize()
            scale = out_p.float().abs().max().item()
            e = (out_k.float() - out_p.float()).abs().max().item()
            check(f"K1c mixed_gemm_rows nf4 M={m} K={k} N={n} (max|ref| {scale:.3f})", e, 1e-2 * scale)
            check_repeatable(f"K1c mixed_gemm_rows nf4 M={m} K={k} N={n}",
                             lambda: launch(x, packed, absmax, None, 4, 0, NF4_BLOCK, NF4_CODE, li))
            err = max(err, e)
            bytes_moved = m * k * 2 + k * n // 2 + (k // NF4_BLOCK) * n * 4 + m * n * 2
            detail.append(_time_case(
                lambda: launch(x, packed, absmax, None, 4, 0, NF4_BLOCK, NF4_CODE, next(cyc)),
                lambda: plain(x, packed, absmax, None, 4, 0, NF4_BLOCK, NF4_CODE, li),
                lambda: torch.matmul(x, dense), m, k, n, e, bytes_moved, 2 * m * n * k,
            ))
        del packed, absmax, dense
        torch.cuda.empty_cache()
    # Options the served path does not use: 8-bit GPTQ rows (uint8b128) with
    # per-group zero-points, and the FP4 codebook (sign bit 3).
    fp4 = tuple(FP4_MAGNITUDE_CODE) + tuple(-v for v in FP4_MAGNITUDE_CODE)
    k, n = 1024, 512
    cases = {
        "8-bit per-group zero-points": (8, 128, None, torch.randint(-8, 8, (3, k // 64, n), generator=gen,
                                                                    device="cuda").float()),
        "fp4 codebook": (4, 0, fp4, None),
    }
    for label, (bits, bias, book, zp) in cases.items():
        packed = torch.randint(-(2**31), 2**31 - 1, (3, k * bits // 32, n), generator=gen, device="cuda",
                               dtype=torch.int32)
        scales = (torch.rand((3, k // 64, n), generator=gen, device="cuda") * 4e-3 + 1e-4).to(torch.bfloat16)
        for m in (8, 40):
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            out_k = launch(x, packed, scales, zp, bits, bias, 64, book, 2)
            out_p = plain(x, packed, scales, zp, bits, bias, 64, book, 2)
            scale = out_p.float().abs().max().item()
            e = (out_k.float() - out_p.float()).abs().max().item()
            check(f"K1c mixed_gemm_rows {label} M={m} (max|ref| {scale:.3f})", e, 1e-2 * scale)
            err = max(err, e)
    return _layer_row(
        "mixed_gemm_rows", "conch_tpu_torch/csrc/mixed_gemm_rows.cu", "conch_tpu/kernels/quantization/gemm.py:129",
        err, detail, NF4_LAYER_SHAPES,
    )


# The option sweep of K1b and K1c: every bit width, scale dtype, zero-point
# mode, M regime (32, 64 and 128 rows a block, with splits), x row layout
# and output dtype, at each group the kernels take among these. Small K and
# N: K spans four split units, so the plan splits K at every M.
OPTION_MS = (8, 40, 130)
ROWS_OPTION_GROUPS = (12, 64, 100, 128, 256)  # 12 and 100: the group-table template (up to 17 scale rows a slice)
PLANAR_OPTION_GROUPS = {2: (256,), 4: (128, 256), 8: (64, 128, 256)}  # group % (16 * 32 / bits) == 0
OPTION_N = 160  # a partial 128-column tile


def _option_xs(gen, m: int, k: int) -> dict:
    """x three ways: contiguous; rows 16 bytes longer (TMA with ldx != K);
    8 bytes off and a stride of K + 4 (realigned by the wrapper's
    ``_tma_rows``)."""
    wide = torch.randn((m, k + 8), generator=gen, device="cuda").to(torch.bfloat16)
    off = torch.randn((m, k + 4), generator=gen, device="cuda").to(torch.bfloat16)
    return {"contiguous": wide[:, :k].contiguous(), "padded": wide[:, :k], "offset": off[:, 4:]}


def check_quant_gemm_options(gen) -> None:
    """K1b and K1c at every option they take, against their plain versions
    at 1e-2 x max |ref|: 2-, 4- and 8-bit codes (K1c also the NF4 codebook)
    at groups ``ROWS_OPTION_GROUPS`` (K1c, K not a multiple of 64) and
    ``PLANAR_OPTION_GROUPS`` (K1b: the 16-word-row slices with their 4-d x
    box, 2-bit codes, and whole groups of 128), bf16 and f32 scales,
    zero-point modes 0, 1 and 2, M in ``OPTION_MS``, x contiguous, with
    padded rows, or realigned, f32 and bf16 outputs; layer 1 of a 2-layer
    stack. Errors are gathered on the card and read once."""
    from conch_tpu_torch.kernels.quantization.bitsandbytes.blockwise import NF4_CODE
    from conch_tpu_torch.kernels.quantization.gemm import (
        mixed_gemm_planar_launcher,
        mixed_gemm_planar_plain,
        mixed_gemm_rows_launcher,
        mixed_gemm_rows_plain,
    )

    n = OPTION_N
    names, errs, refs = [], [], []

    kernels = {
        "K1c mixed_gemm_rows": (mixed_gemm_rows_launcher, mixed_gemm_rows_plain),
        "K1b mixed_gemm_planar": (mixed_gemm_planar_launcher, mixed_gemm_planar_plain),
    }

    def sweep(label, bits, group, k, groups, books):
        launch, plain = kernels[label]
        epp = 32 // bits
        packed = torch.randint(-(2**31), 2**31 - 1, (2, k // epp, n), generator=gen, device="cuda", dtype=torch.int32)
        for sdt in (torch.bfloat16, torch.float32):
            scales = (torch.rand((2, groups, n), generator=gen, device="cuda") * 4e-3 + 1e-4).to(sdt)
            zps = {
                "zp none": None, "zp scalar": torch.tensor([3.0], device="cuda"),
                "zp per group": torch.randint(0, 2**bits, (2, groups, n), generator=gen, device="cuda").float(),
            }
            for zlabel, zp in zps.items():
                for m in OPTION_MS:
                    for xlabel, x in _option_xs(gen, m, k).items():
                        for book, bias in books:
                            book_arg = () if label.startswith("K1b") else (book,)  # K1b takes no codebook
                            for od in (torch.bfloat16, torch.float32):
                                out = launch(x, packed, scales, zp, bits, bias, group, *book_arg, 1, od)
                                ref = plain(x, packed, scales, zp, bits, bias, group, *book_arg, 1, od)
                                names.append(f"{label} {bits}-bit group {group} K={k} {'nf4 ' if book else ''}"
                                             f"{str(sdt)[6:]} scales, {zlabel}, M={m}, x {xlabel}, {str(od)[6:]} out")
                                errs.append((out.float() - ref.float()).abs().max())
                                refs.append(ref.float().abs().max())

    for bits in (2, 4, 8):
        for group in ROWS_OPTION_GROUPS:
            k = 4 * math.lcm(group, 64) - 16  # four split units, the last slice partial
            books = ((None, 2 ** (bits - 1)),) + (((tuple(NF4_CODE), 0),) if bits == 4 else ())
            sweep("K1c mixed_gemm_rows", bits, group, k, -(-k // group), books)
        for group in PLANAR_OPTION_GROUPS[bits]:
            sweep("K1b mixed_gemm_planar", bits, group, 4 * group, 4, ((None, 2 ** (bits - 1)),))
    err_list = torch.stack(errs).tolist()
    ref_list = torch.stack(refs).tolist()
    bad = [(name, e, r) for name, e, r in zip(names, err_list, ref_list) if not e <= 1e-2 * r]
    for layout in kernels:
        ratios = [e / r for name, e, r in zip(names, err_list, ref_list) if name.startswith(layout)]
        print(f"{layout} options: {len(ratios)} cases, worst max_abs_err / max|ref| {max(ratios):.3e} "
              f"(tolerance 1e-2)", flush=True)
    for name, e, r in bad:
        print(f"{name}: max_abs_err {e:.3e} (tolerance {1e-2 * r:.1e})", flush=True)
    if bad:
        raise AssertionError(f"{len(bad)} of {len(names)} K1b/K1c option cases exceed 1e-2 x max |ref|")


# K1's option sweep: both groups, any bias, stacked and single weights, x three ways, bf16 and f32 outputs, M
# from 1 past 512 (32, 64 and 128 rows a block, K split at small M).
MAGIC_OPTION_MS = (1, 8, 31, 40, 64, 130, 512, 600)
MAGIC_OPTION_BIASES = (8, 0, 15)


def check_magic_gemm_options(gen) -> None:
    """K1 at every option it takes, against its plain version at 1e-2 x max
    |ref|: groups 64 and 128, biases
    ``MAGIC_OPTION_BIASES``, layer 1 of a 2-layer stack and an unstacked
    weight, M in ``MAGIC_OPTION_MS``, x contiguous, with padded rows, or
    realigned, bf16 and f32 outputs; K = 4 groups (split at small M), N =
    ``OPTION_N``. Every case runs twice and must give the same bits. Errors
    are gathered on the card and read once."""
    from conch_tpu_torch.kernels.common import sm_count
    from conch_tpu_torch.kernels.quantization.gemm import _magic_gemm_cuda, mixed_gemm_magic_plain, quant_gemm_plan

    n = OPTION_N
    names, errs, refs, same = [], [], [], []
    for group in (128, 64):
        k = 4 * group
        packed = torch.randint(-(2**31), 2**31 - 1, (2, k // 8, n), generator=gen, device="cuda", dtype=torch.int32)
        scales = (torch.rand((2, k // group, n), generator=gen, device="cuda") * 4e-3 + 1e-4).to(torch.bfloat16)
        for m in MAGIC_OPTION_MS:
            plan = quant_gemm_plan("magic", m, n, k, 4, group, sm_count(0))
            for xlabel, x in _option_xs(gen, m, k).items():
                for bias in MAGIC_OPTION_BIASES:
                    for stacked in (True, False):
                        w, sc, li = (packed, scales, 1) if stacked else (packed[1], scales[1], None)
                        for od in (torch.bfloat16, torch.float32):
                            out = _magic_gemm_cuda(x, w, sc, group, bias, li, od)
                            again = _magic_gemm_cuda(x, w, sc, group, bias, li, od)
                            ref = mixed_gemm_magic_plain(x, w, sc, group, bias, li, od)
                            names.append(f"K1 mixed_gemm_magic group {group} M={m} x {xlabel} bias {bias} "
                                         f"{'stacked' if stacked else 'single'} {str(od)[6:]} out "
                                         f"(splits {plan.splits})")
                            errs.append((out.float() - ref.float()).abs().max())
                            refs.append(ref.float().abs().max())
                            same.append(torch.equal(out, again))
    err_list, ref_list, same_list = torch.stack(errs).tolist(), torch.stack(refs).tolist(), torch.tensor(same).tolist()
    bad = [(name, e, r) for name, e, r in zip(names, err_list, ref_list) if not e <= 1e-2 * r]
    print(f"K1 mixed_gemm_magic options: {len(names)} cases, worst max_abs_err / max|ref| "
          f"{max(e / r for e, r in zip(err_list, ref_list)):.3e} (tolerance 1e-2); "
          f"{sum(same_list)} of {len(names)} bit for bit across two calls", flush=True)
    for name, e, r in bad:
        print(f"{name}: max_abs_err {e:.3e} (tolerance {1e-2 * r:.1e})", flush=True)
    if bad:
        raise AssertionError(f"{len(bad)} of {len(names)} K1 option cases exceed 1e-2 x max |ref|")
    if not all(same_list):
        raise AssertionError(f"{len(same_list) - sum(same_list)} K1 option cases differ between two calls")


def _int_mm_library(m: int, k: int, n: int, gen) -> tuple:
    """``torch._int_mm`` (int8 x int8 -> int32, no epilogue) at the smallest
    M from ``m`` up that it takes: (M timed at, callable)."""
    b = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
    for mm in (m, 17, 24, 32):
        a = torch.randint(-127, 128, (mm, k), generator=gen, device="cuda", dtype=torch.int8)
        try:
            torch._int_mm(a, b)
        except RuntimeError:
            continue
        return mm, (lambda a=a: torch._int_mm(a, b))
    return None, None


def k8_weights(gen, k: int, n: int, layers: int | None = NUM_LAYERS_POOL) -> tuple[torch.Tensor, torch.Tensor]:
    """The w8a8 engine's int8 weight of one projection, (layers, K, N) (or
    (K, N) unstacked), and its per-column scales."""
    lead = () if layers is None else (layers,)
    w8 = torch.randint(-127, 128, (*lead, k, n), generator=gen, device="cuda", dtype=torch.int8)
    return w8, torch.rand((*lead, n), generator=gen, device="cuda") * 1e-3 + 1e-4


def k8_rows(gen, m: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """m int8 activation rows and their per-row scales, 10x apart end to end
    (a kernel that swapped sa and sb would fail)."""
    a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    return a, 1e-3 * torch.logspace(0, 1, m, device="cuda")


def kernel_phase_k8(gen) -> dict:
    """K8 (int8 x int8 -> int32, then * sa[m] * sb[n]) at the w8a8 engine's
    shapes, M in GEMM_MS, layer 17 of a 32-layer stack (lm_head unstacked);
    per-row scales spanning 10x, so that a kernel that swapped sa and sb
    would fail; plus float8_e4m3fn inputs with f32 and bf16 outputs and a
    scalar sa. Tolerance 1e-2 x max |ref| (the int path is exact up to its
    epilogue). Library: ``torch._int_mm`` without the epilogue, at the
    smallest M it takes (recorded as ``library_m``)."""
    from conch_tpu_torch.kernels.quantization.gemm import scaled_gemm_launcher as launch, scaled_gemm_plain as plain

    err, detail = 0.0, []
    for (k, n) in (*FUSED_LAYER_SHAPES, LM_HEAD):
        layers = NUM_LAYERS_POOL if (k, n) != LM_HEAD else None
        w8, sb = k8_weights(gen, k, n, layers)
        li = None if layers is None else LAYER
        cyc = _stack_cycle() if layers else itertools.repeat(None)
        # The bf16 matmul of the same shape, for reference (three weights in turn, so not from L2).
        dense = itertools.cycle([torch.randn((k, n), generator=gen, device="cuda").to(torch.bfloat16)
                                 for _ in range(3)])
        for m in GEMM_MS:
            a, sa = k8_rows(gen, m, k)
            xb = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            out_k = launch(a, w8, sa, sb, torch.bfloat16, li)
            out_p = plain(a, w8, sa, sb, torch.bfloat16, li)
            torch.cuda.synchronize()
            scale = out_p.float().abs().max().item()
            e = (out_k.float() - out_p.float()).abs().max().item()
            same = (out_k == out_p).float().mean().item()
            check(f"K8 scaled_gemm int8 M={m} K={k} N={n} (max|ref| {scale:.3f}, {same:.4f} of outputs equal)",
                  e, 1e-2 * scale)
            err = max(err, e)
            lib_m, lib = _int_mm_library(m, k, n, gen)
            bytes_moved = m * k + k * n + m * 4 + n * 4 + m * n * 2
            detail.append(_time_case(
                lambda: launch(a, w8, sa, sb, torch.bfloat16, next(cyc)),
                lambda: plain(a, w8, sa, sb, torch.bfloat16, li), lib, m, k, n, e, bytes_moved, 2 * m * n * k,
                INT8_OPS_PER_S, library_m=lib_m, matmul_ms=time_ms(lambda: torch.matmul(xb, next(dense))),
            ))
        del w8, sb, dense
        torch.cuda.empty_cache()
    # float8_e4m3fn inputs (converted exactly, summed in f32), scalar sa.
    m, k, n = 16, 512, 256
    a8 = torch.randn((m, k), generator=gen, device="cuda").to(torch.float8_e4m3fn)
    b8 = torch.randn((k, n), generator=gen, device="cuda").to(torch.float8_e4m3fn)
    sa, sb = torch.tensor([0.5], device="cuda"), torch.rand((n,), generator=gen, device="cuda") + 0.5
    for dtype in (torch.float32, torch.bfloat16):
        out_k, out_p = launch(a8, b8, sa, sb, dtype), plain(a8, b8, sa, sb, dtype)
        scale = out_p.float().abs().max().item()
        e = (out_k.float() - out_p.float()).abs().max().item()
        check(f"K8 scaled_gemm float8_e4m3fn -> {dtype} (max|ref| {scale:.3f})", e, 1e-2 * scale)
        err = max(err, e)
    row = _layer_row(
        "scaled_gemm", "conch_tpu_torch/csrc/scaled_gemm.cu", "conch_tpu/kernels/quantization/gemm.py:739", err,
        detail, FUSED_LAYER_SHAPES,
    )
    row["library_note"] = ("torch._int_mm without the epilogue, at the M in each detail entry's library_m; "
                           "matmul_ms: a bf16 torch.matmul of the same shape, for reference")
    for m in GEMM_MS:
        matmul = sum(d["matmul_ms"] * FUSED_LAYER_SHAPES[(d["k"], d["n"])] for d in detail
                     if d["m"] == m and (d["k"], d["n"]) in FUSED_LAYER_SHAPES)
        row["by_m"][m]["matmul_ms"] = matmul
        print(f"scaled_gemm one layer at M={m}: bf16 torch.matmul {matmul:.4f} ms", flush=True)
    return row


# K8's option sweep: rows from one to past a 512-row chunk (1 and 17:
# partial row tiles of the 32-row template; 40: the 64-row one; 130, 600:
# several 128-row tiles), a small shape (K 96: a K slice zero-filled past
# K; N 160: a partial column block) with every option, and the served
# shapes (FUSED_LAYER_SHAPES) with one option set each, in turn.
SCALED_OPTION_MS = (1, 8, 16, 17, 31, 32, 40, 130, 512, 600)
SCALED_OPTION_SMALL = (96, 160)
SCALED_OPTIONS = list(itertools.product(
    (torch.float32, torch.bfloat16), ("scalar", "row"), ("scalar", "column"), ("single", "stacked"),
    (0, 64, 40),  # a's row stride past K: contiguous, one TMA takes, one the wrapper realigns
))


def check_scaled_gemm_options(gen) -> None:
    """K8's int8 path against ``scaled_gemm_plain``, every output equal bit
    for bit (``torch.equal``: the sums are exact in int32 and both apply
    ``(float(v) * sa[m]) * sb[n]`` in f32, then round once): M in
    SCALED_OPTION_MS at K 96 / N 160 with every option of SCALED_OPTIONS
    (output f32 or bf16; scale_a one value or per row, 10x apart; scale_b
    one value or per column; a single weight or layer 1 of a 2-layer stack
    with its scales; a's rows contiguous or with a row stride of K + 64 or K
    + 40), and at the served shapes with one option set each (cycling).
    Then w_down's shape (K 14336) at 8 and 32 rows with every value of a
    and b in 125..127: each split's partial sum (K split 8 ways) exceeds
    2^24, so a workspace that held them in f32 would lose bits. Mismatches
    are counted on the card and read once; the case count is printed."""
    from conch_tpu_torch.kernels.quantization.gemm import scaled_gemm_launcher as launch, scaled_gemm_plain as plain

    names, same = [], []

    def run(m: int, k: int, n: int, options: list, low: int = -127) -> None:
        w = torch.randint(low, 128, (2, k, n), generator=gen, device="cuda", dtype=torch.int8)
        sb_stack = torch.rand((2, n), generator=gen, device="cuda") * 1e-3 + 1e-4
        a_wide = torch.randint(low, 128, (m, k + 64), generator=gen, device="cuda", dtype=torch.int8)
        sa_row = 1e-3 * torch.logspace(0, 1, m, device="cuda")
        scalar = torch.tensor([2.5e-3], device="cuda")
        for out_dtype, sa_kind, sb_kind, weight, pad in options:
            a = a_wide[:, :k] if pad == 64 else torch.empty((m, k + pad), dtype=torch.int8, device="cuda")[:, :k]
            if pad != 64:
                a.copy_(a_wide[:, :k])
            sa = scalar if sa_kind == "scalar" else sa_row
            b, sb, layer = (w[1], sb_stack[1], None) if weight == "single" else (w, sb_stack, 1)
            if sb_kind == "scalar":
                sb = scalar
            out = launch(a, b, sa, sb, out_dtype, layer)
            names.append(f"K8 M {m} K {k} N {n} out {str(out_dtype)[6:]} sa {sa_kind} sb {sb_kind} {weight} "
                         f"a stride {a.stride(0)}")
            same.append(torch.equal(out, plain(a, b, sa, sb, out_dtype, layer)))

    for m in SCALED_OPTION_MS:
        run(m, *SCALED_OPTION_SMALL, SCALED_OPTIONS)
    turn = itertools.cycle(SCALED_OPTIONS)
    for k, n in FUSED_LAYER_SHAPES:
        for m in SCALED_OPTION_MS:
            run(m, k, n, [next(turn)])
        torch.cuda.empty_cache()
    for m in (8, 32):
        run(m, INTER, HIDDEN, [(torch.float32, "row", "column", "stacked", 0)], low=125)
    same_list = torch.tensor(same).tolist()
    print(f"K8 scaled_gemm options: {len(names)} cases, {sum(same_list)} equal to the plain version bit for bit",
          flush=True)
    bad = [name for name, ok in zip(names, same_list) if not ok]
    for name in bad[:20]:
        print(f"{name}: differs from the plain version", flush=True)
    if bad:
        raise AssertionError(f"{len(bad)} of {len(names)} K8 option cases differ from the plain version")


GATE = (4096, 14336)  # Llama-3-8B's gate projection (K, N); its (N, K) weight is quantized


def _k12q_case(launch, plain, wt: torch.Tensor, blocksize: int, quant_type: str) -> None:
    """K12q against its plain version on one input, byte for byte."""
    got, ref = launch(wt, blocksize, quant_type), plain(wt, blocksize, quant_type)
    torch.cuda.synchronize()
    bad = int((got[0] != ref[0]).sum().item()) + int((got[1] != ref[1]).sum().item())
    name = f"K12q quantize4 {quant_type} blocksize {blocksize} {tuple(wt.shape)} {wt.dtype}"
    print(f"{name}: {bad} bytes or absmax differ (tolerance 0)", flush=True)
    if bad:
        raise AssertionError(f"{name}: {bad} outputs differ from the plain version")


def kernel_phase_k12q(gen) -> dict:
    """K12q (NF4 and FP4 encode, blocksize 64) on every (N, K) weight the
    nf4 init quantizes, transposed and rounded to bf16 as ``nf4_from_dense``
    hands it over, with an all-zero block; on the gate projection also at
    blocksize 4096 (the loop over a block read twice) and from f16; packed
    bytes and absmax held byte for byte against the plain version. The row
    times the gate projection at blocksize 64; ``detail`` also at 4096."""
    from conch_tpu_torch.kernels.quantization.bitsandbytes.blockwise import (
        quantize4_launcher as launch,
        quantize4_plain as plain,
    )

    detail = []
    for (k, n) in (*NF4_LAYER_SHAPES, LM_HEAD):
        wt = (0.02 * torch.randn((n, k), generator=gen, device="cuda")).to(torch.bfloat16)
        wt[3, :NF4_BLOCK] = 0.0  # an all-zero block: absmax 0, reciprocal 0
        for quant_type in ("nf4", "fp4") if (k, n) == GATE else ("nf4",):
            _k12q_case(launch, plain, wt, NF4_BLOCK, quant_type)
        if (k, n) == GATE:
            wt[5, :4096] = 0.0  # an all-zero block at 4096
            for quant_type in ("nf4", "fp4"):
                _k12q_case(launch, plain, wt, 4096, quant_type)
            for blocksize in (NF4_BLOCK, 4096):
                _k12q_case(launch, plain, wt.half(), blocksize, "nf4")
            size = n * k
            for blocksize in (NF4_BLOCK, 4096):
                bytes_moved = size * 2 + size // 2 + (size // blocksize) * 4
                b_ms, b_by = bound(bytes_moved, 18 * size, F32_OPS_PER_S)  # abs, max, scale, 15 compares
                detail.append({
                    "k": k, "n": n, "blocksize": blocksize, "max_abs_err": 0.0, "bound_ms": b_ms, "bound_by": b_by,
                    "ms": time_ms(lambda: launch(wt, blocksize, "nf4")),
                    "paced_ms": paced_ms(lambda: launch(wt, blocksize, "nf4")),
                    "plain_ms": time_ms(lambda: plain(wt, blocksize, "nf4"), iters=3, warmup=1), "library_ms": None,
                })
        del wt
    for d in detail:
        print(f"quantize4 nf4 {d['n']} x {d['k']} blocksize {d['blocksize']}: {d['ms']:.4f} ms (paced "
              f"{d['paced_ms']:.4f}, plain {d['plain_ms']:.4f}, bound {d['bound_ms']:.5f} by {d['bound_by']})",
              flush=True)
    d = detail[0]
    row = _kernel_row(
        "quantize4", "conch_tpu_torch/csrc/quantize4.cu",
        "conch_tpu/kernels/quantization/bitsandbytes/blockwise.py:324", 0.0, d, d["bound_ms"], d["bound_by"],
    )
    row["detail"] = detail
    return row


def kernel_phase_k12d(gen) -> dict:
    """K12d (NF4 and FP4 decode) on Llama-3-8B's gate projection (14336 x
    4096, bf16, encoded by K12q with an all-zero block) at blocksize 64 and
    4096, into bf16, f32 and f16, held bit for bit against the plain
    version. The row times nf4 at blocksize 64 into bf16 (QLoRA's storage);
    ``detail`` every output dtype and blocksize 4096. No single PyTorch
    call decodes NF4, so no library time."""
    from conch_tpu_torch.kernels.quantization.bitsandbytes.blockwise import (
        dequantize4_launcher as launch,
        dequantize4_plain as plain,
        quantize4_launcher,
    )

    k, n = GATE
    wt = (0.02 * torch.randn((n, k), generator=gen, device="cuda")).to(torch.bfloat16)
    wt[3, :NF4_BLOCK] = 0.0
    size, detail = n * k, []
    for quant_type in ("nf4", "fp4"):
        for blocksize in (NF4_BLOCK, 4096):
            packed, absmax = quantize4_launcher(wt, blocksize, quant_type)
            for dtype in (torch.bfloat16, torch.float32, torch.float16):
                check_equal(f"K12d dequantize4 {quant_type} blocksize {blocksize} {n} x {k} into {dtype}",
                            launch(packed, absmax, blocksize, quant_type, dtype),
                            plain(packed, absmax, blocksize, quant_type, dtype))
                if quant_type == "nf4":
                    elem = torch.empty((), dtype=dtype).element_size()
                    b_ms, b_by = bound(size // 2 + (size // blocksize) * 4 + size * elem, size, F32_OPS_PER_S)
                    detail.append({
                        "case": f"nf4 blocksize {blocksize} into {dtype}", "max_abs_err": 0.0, "bound_ms": b_ms,
                        "bound_by": b_by,
                        "ms": time_ms(lambda: launch(packed, absmax, blocksize, quant_type, dtype)),
                        "paced_ms": paced_ms(lambda: launch(packed, absmax, blocksize, quant_type, dtype)),
                        "plain_ms": time_ms(lambda: plain(packed, absmax, blocksize, quant_type, dtype), iters=3,
                                            warmup=1),
                        "library_ms": None,
                    })
            del packed, absmax
    del wt
    torch.cuda.empty_cache()
    for d in detail:
        print(f"K12d {d['case']}: {d['ms']:.4f} ms (paced {d['paced_ms']:.4f}, plain {d['plain_ms']:.4f}, bound "
              f"{d['bound_ms']:.5f} by {d['bound_by']})", flush=True)
    d = detail[0]
    row = _kernel_row(
        "dequantize4", "conch_tpu_torch/csrc/dequantize4.cu",
        "conch_tpu/kernels/quantization/bitsandbytes/blockwise.py:367", 0.0, d, d["bound_ms"], d["bound_by"],
    )
    row["detail"] = detail
    return row


# tests/rms_norm_test.py's tolerances (atol and rtol) for K4 and K4b
# against their plain versions: the two sum the squares in another order.
NORM_TOLERANCES = {torch.float32: 1e-5, torch.float16: 1e-3, torch.bfloat16: 2e-2}
K4B_CASES = ((8, torch.bfloat16), (2048, torch.bfloat16), (2048, torch.float32), (2048, torch.float16))


def kernel_phase_k4b(gen) -> dict:
    """K4b (fused residual add + RMS norm) at Llama-3-8B's hidden size: bf16
    at 8 and 2048 rows, f32 and f16 at 2048. ``out`` against the plain
    version at NORM_TOLERANCES, the sum ``x + r`` bit for bit. The row has
    the 2048-row bf16 numbers (a prefill chunk); no single PyTorch call
    computes both outputs, so no library time."""
    from conch_tpu_torch.kernels.normalization.rms_norm import (
        fused_add_rms_norm_launcher as launch,
        fused_add_rms_norm_plain as plain,
    )

    eps = 1e-5
    err, detail = 0.0, []
    for rows, dtype in K4B_CASES:
        x, r = (torch.randn((rows, HIDDEN), generator=gen, device="cuda").to(dtype) for _ in range(2))
        w = (1.0 + 0.1 * torch.randn((HIDDEN,), generator=gen, device="cuda")).to(dtype)
        (out, res), (ref_out, ref_res) = launch(x, r, w, eps), plain(x, r, w, eps)
        torch.cuda.synchronize()
        name = f"K4b fused_add_rms_norm rows={rows} {dtype}"
        check_equal(f"{name} x + r", res, ref_res)
        e = check_close(name, out, ref_out, NORM_TOLERANCES[dtype])
        err = max(err, e)
        if rows == 2048:
            b_ms, b_by = bound(4 * rows * HIDDEN * x.element_size() + HIDDEN * w.element_size(), 6 * rows * HIDDEN,
                               F32_OPS_PER_S)
            detail.append({
                "case": f"{rows}x{HIDDEN} {dtype}", "max_abs_err": e, "bound_ms": b_ms, "bound_by": b_by,
                "ms": time_ms(lambda: launch(x, r, w, eps)), "paced_ms": paced_ms(lambda: launch(x, r, w, eps)),
                "plain_ms": time_ms(lambda: plain(x, r, w, eps)), "library_ms": None,
            })
    for d in detail:
        print(f"K4b {d['case']}: {d['ms']:.4f} ms (paced {d['paced_ms']:.4f}, plain {d['plain_ms']:.4f}, bound "
              f"{d['bound_ms']:.5f} by {d['bound_by']})", flush=True)
    row = _kernel_row(
        "fused_add_rms_norm", "conch_tpu_torch/csrc/rms_norm.cu", "conch_tpu/kernels/normalization/rms_norm.py:42",
        err, detail[0], detail[0]["bound_ms"], detail[0]["bound_by"],
    )
    row["detail"] = detail
    return row


def kernel_phase_k4(gen) -> dict:
    """K4 at 8 and 512 rows x 4096; the row has the 8-row (decode) numbers."""
    from conch_tpu_torch.kernels.normalization.rms_norm import rms_norm_launcher as launch, rms_norm_plain as plain

    eps = 1e-5
    w = (1.0 + 0.1 * torch.randn((HIDDEN,), generator=gen, device="cuda")).to(torch.bfloat16)
    lib = getattr(torch.nn.functional, "rms_norm", None)
    err, detail = 0.0, []
    for dtype in (torch.float32, torch.float16):  # the other dtypes K4 takes, at 512 rows
        x = torch.randn((512, HIDDEN), generator=gen, device="cuda").to(dtype)
        e = check_close(f"K4 rms_norm rows=512 {dtype}", launch(x, w.to(dtype), eps), plain(x, w.to(dtype), eps),
                        NORM_TOLERANCES[dtype])
        err = max(err, e)
    for rows in (8, 512):
        x = torch.randn((rows, HIDDEN), generator=gen, device="cuda").to(torch.bfloat16)
        e = (launch(x, w, eps).float() - plain(x, w, eps).float()).abs().max().item()
        check(f"K4 rms_norm rows={rows}", e, 2e-2)
        err = max(err, e)
        b_ms, b_by = bound(2 * rows * HIDDEN * 2 + HIDDEN * 2, 4 * rows * HIDDEN)
        detail.append({
            "rows": rows, "max_abs_err": e, "bound_ms": b_ms, "bound_by": b_by,
            "ms": time_ms(lambda: launch(x, w, eps)),
            "paced_ms": paced_ms(lambda: launch(x, w, eps)),
            "plain_ms": time_ms(lambda: plain(x, w, eps)),
            "library_ms": time_ms(lambda: lib(x, (HIDDEN,), w, eps)) if lib else None,
        })
    for d in detail:
        print(f"K4 rows={d['rows']}: {d['ms']:.4f} ms (paced {d['paced_ms']:.4f}, plain {d['plain_ms']:.4f}, "
              f"F.rms_norm {d['library_ms']}, bound {d['bound_ms']:.5f} by {d['bound_by']})", flush=True)
    row = _kernel_row(
        "rms_norm", "conch_tpu_torch/csrc/rms_norm.cu", "conch_tpu/kernels/normalization/rms_norm.py:34", err,
        detail[0], detail[0]["bound_ms"], detail[0]["bound_by"],
    )
    row["detail"] = detail
    return row


def kernel_phase_k6(gen) -> dict:
    """K6 on fused halves at 8 and 512 rows x 2*14336, and on parts once;
    the row has the 8-row halves (decode) numbers."""
    from conch_tpu_torch.kernels.activation.silu_and_mul import (
        silu_and_mul_launcher as launch,
        silu_and_mul_parts_launcher as launch_parts,
        silu_and_mul_parts_plain as plain_parts,
        silu_and_mul_plain as plain,
    )

    err, detail = 0.0, []
    for rows in (8, 512):
        x = torch.randn((rows, 2 * INTER), generator=gen, device="cuda").to(torch.bfloat16)
        e = (launch(x).float() - plain(x).float()).abs().max().item()
        check(f"K6 silu_and_mul halves rows={rows}", e, 1e-2)
        err = max(err, e)
        b_ms, b_by = bound(rows * INTER * 3 * 2, 6 * rows * INTER)
        detail.append({
            "rows": rows, "max_abs_err": e, "bound_ms": b_ms, "bound_by": b_by,
            "ms": time_ms(lambda: launch(x)),
            "paced_ms": paced_ms(lambda: launch(x)),
            "plain_ms": time_ms(lambda: plain(x)), "library_ms": None,
        })
    gate, up = x[:, :INTER], x[:, INTER:]  # row-strided parts of the last input
    e = (launch_parts(gate, up).float() - plain_parts(gate, up).float()).abs().max().item()
    check("K6 silu_and_mul parts rows=512", e, 1e-2)
    err = max(err, e)
    for d in detail:
        print(f"K6 halves rows={d['rows']}: {d['ms']:.4f} ms (paced {d['paced_ms']:.4f}, plain {d['plain_ms']:.4f}, "
              f"bound {d['bound_ms']:.5f} by {d['bound_by']})", flush=True)
    row = _kernel_row(
        "silu_and_mul", "conch_tpu_torch/csrc/silu_and_mul.cu", "conch_tpu/kernels/activation/silu_and_mul.py:27",
        err, detail[0], detail[0]["bound_ms"], detail[0]["bound_by"],
    )
    row["detail"] = detail
    return row


# Gemma-2-2B (GemmaConfig.gemma2_2b()): hidden 2304, intermediate 9216, 8
# query heads over 4 KV heads of 256, 26 layers, softcap 50 on the
# attention logits, scale 256 ** -0.5, a 4096-token window on even layers.
G_QH, G_KH, G_D, G_LAYERS = 8, 4, 256, 26
G_HIDDEN, G_INTER = 2304, 9216
G_SOFTCAP, G_WINDOW, G_SCALE = 50.0, 4096, 256.0**-0.5
G_Q_GAIN = 12.0  # query scale in the K3/K7 checks, so the logits reach the softcap

# K3's timed decode steps, each on a pool and block table of its own:
# name -> (model, rows, table pages, row -> context (other rows idle),
# (source row, reading row, shared pages), windows). The kernel table's
# lines: Llama-3-8B's decode batch of 8 and Gemma-2-2B's, each with an idle
# row, lengths off page multiples and a shared prefix, Gemma's past the
# window. The served steps: the int4 Llama engine (the README example,
# max_batch_size 32) decodes 32 rows, 8 of them live at contexts 40 to 932
# (prompts of 40 to 900 plus 32 generated tokens), over its 64-page table;
# the Gemma-2-2B engine (max_batch_size 16) 16 rows, 8 live at 4200 to
# 6000, over a 384-page table (the served engine's 320 pages stop at 5120
# tokens).
K3_SERVED_LLAMA = dict(zip((0, 3, 4, 9, 15, 20, 26, 31), (40, 131, 262, 395, 540, 690, 812, 932)))
K3_SERVED_GEMMA = dict(zip((0, 2, 3, 6, 8, 11, 13, 15), (4200, 4457, 4713, 4970, 5228, 5485, 5742, 6000)))
K3_CASES = {
    "llama3_8b table line": ("llama", 8, MAX_PAGES_PER_SEQ, dict(enumerate([0, 1, 17, 64, 200, 333, 511, 540])),
                             (4, 5, 4), (0,)),
    "gemma2 table line": ("gemma", 8, 384, dict(enumerate([4600, 1, 17, 0, 300, 4096, 4097, 6000])), (0, 5, 8),
                          (0, G_WINDOW)),
    "llama3_8b int4 served decode": ("llama", 32, 64, K3_SERVED_LLAMA, (0, 0, 0), (0,)),
    "gemma2 served decode": ("gemma", 16, 384, K3_SERVED_GEMMA, (0, 0, 0), (0, G_WINDOW)),
}


def k3_inputs(gen, rng, name: str, cache: str | None = None) -> dict:
    """K3_CASES[name] on the card: ``args``, the launcher's arguments up to
    the window (query, pools, block table, seq_lens, scale, layer 17,
    softcap); ``windows``, ``seq_lens``, ``bt`` (the table in numpy),
    ``idle`` (rows of length 0) and ``shape`` (QH, KH, D). Llama-3-8B: 32
    query heads over 8 KV heads of 128, a 32-layer pool, scale D^-0.5,
    queries N(0, 1). Gemma-2-2B: 8 over 4 of 256, 26 layers, softcap 50,
    scale 1/16, queries N(0, G_Q_GAIN^2). Pools are bf16, or int8 / e4m3
    (``cache``) through the quantizing store."""
    model, rows, max_pages, lens, (src, dst, shared), windows = K3_CASES[name]
    qh, kh, d, layers, softcap, scale, gain = {
        "llama": (QH, KH, D, NUM_LAYERS_POOL, 0.0, D**-0.5, 1.0),
        "gemma": (G_QH, G_KH, G_D, G_LAYERS, G_SOFTCAP, G_SCALE, G_Q_GAIN),
    }[model]
    seq_lens = [lens.get(i, 0) for i in range(rows)]
    num_pages = sum(-(-n // PS) for n in seq_lens) + 1
    kc, vc = kv_pools(gen, num_pages, layers, kh, d, cache)
    bt = paged_layout(rng, seq_lens, num_pages, share=(src, dst), shared_pages=shared, max_pages=max_pages)
    q = (gain * torch.randn((rows, qh, d), generator=gen, device="cuda")).to(torch.bfloat16)
    sl_t = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    return {
        "args": (q, kc, vc, torch.from_numpy(bt).cuda(), sl_t, scale, LAYER, softcap), "windows": windows,
        "seq_lens": seq_lens, "bt": bt, "idle": [i for i, n in enumerate(seq_lens) if n == 0], "shape": (qh, kh, d),
    }


def k3_bound(case: dict, window: int) -> tuple[float, str]:
    """K3's bound on ``case`` (k3_inputs) under ``window``: the query read
    and the output written in bf16, each visible cached K and V row read
    once (shared pages once), the table entries of the visible pages and
    seq_lens; 4 * QH * D operations a visible token."""
    qh, kh, d = case["shape"]
    seq_lens, kc = case["seq_lens"], case["args"][1]
    starts = [max(n - window, 0) if window else 0 for n in seq_lens]
    pages = sum(-(-n // PS) - a // PS for n, a in zip(seq_lens, starts) if n > a)
    bytes_moved = (2 * case["args"][0].numel() * 2 + 2 * unique_kv_rows(case["bt"], seq_lens, starts) * kh * d
                   * kc.element_size() + pages * 4 + len(seq_lens) * 4)
    return bound(bytes_moved, 4 * qh * d * sum(n - a for n, a in zip(seq_lens, starts)))


# K7's timed prefill steps: name -> (model, rows, table pages, q_lens,
# seq_lens, (source, reading sequence, shared pages), windows). Llama-3-8B:
# a 128-row step as the engine packs it: a mixed-in decode row (context
# 300), a fresh 50-token prompt, the last 40-token chunk of a 340-token
# prompt, a 30-token chunk whose first 4 pages are shared with that prompt,
# then zero-length padding sequences and 7 padding rows. Gemma-2-2B: a
# 512-row step: a mixed-in decode row at context 4200, a 7-token prompt,
# the last 400-token chunk of a 4600-token prompt, zero-length padding
# sequences (16 in all, the served run's batch) and 104 padding rows, on a
# global layer (no window) and a local one (window 4096).
K7_CASES = {
    "llama3_8b table line": ("llama", 128, MAX_PAGES_PER_SEQ, [1, 50, 40, 30, 0, 0, 0, 0],
                             [300, 50, 340, 94, 0, 0, 0, 0], (2, 3, 4), (0,)),
    "gemma2 table line": ("gemma", 512, 384, [1, 7, 400] + [0] * 13, [4200, 7, 4600] + [0] * 13, (0, 0, 0),
                          (0, G_WINDOW)),
}


def k7_inputs(gen, rng, name: str, cache: str | None = None) -> dict:
    """K7_CASES[name] on the card: ``args``, the launcher's arguments up to
    the window (query, pools, cu_seqlens_q, seq_lens, block table, scale,
    causal, layer 17, softcap); ``windows``, ``q_lens``, ``seq_lens``,
    ``bt`` (the table in numpy), ``total`` (rows before the padding) and
    ``shape`` (QH, KH, D). Shapes, scales and query gains as ``k3_inputs``;
    pools bf16, or int8 / e4m3 (``cache``) through the quantizing store."""
    model, rows, max_pages, q_lens, seq_lens, (src, dst, shared), windows = K7_CASES[name]
    qh, kh, d, layers, softcap, scale, gain = {
        "llama": (QH, KH, D, NUM_LAYERS_POOL, 0.0, D**-0.5, 1.0),
        "gemma": (G_QH, G_KH, G_D, G_LAYERS, G_SOFTCAP, G_SCALE, G_Q_GAIN),
    }[model]
    num_pages = sum(-(-n // PS) for n in seq_lens) + 1
    kc, vc = kv_pools(gen, num_pages, layers, kh, d, cache)
    bt = paged_layout(rng, seq_lens, num_pages, share=(src, dst), shared_pages=shared, max_pages=max_pages)
    q = (gain * torch.randn((rows, qh, d), generator=gen, device="cuda")).to(torch.bfloat16)
    cu = torch.tensor(np.concatenate([[0], np.cumsum(q_lens)]), dtype=torch.int32, device="cuda")
    sl_t = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    return {
        "args": (q, kc, vc, cu, sl_t, torch.from_numpy(bt).cuda(), scale, True, LAYER, softcap), "windows": windows,
        "q_lens": q_lens, "seq_lens": seq_lens, "bt": bt, "total": sum(q_lens), "shape": (qh, kh, d),
    }


def k7_bound(case: dict, window: int) -> tuple[float, str]:
    """K7's bound on ``case`` (k7_inputs) under ``window``: the live query
    rows read and every row written in bf16, each cached K and V row that a
    row sees read once (shared pages once; a sequence's first row has the
    earliest window start), the block table, cu_seqlens_q and seq_lens; 4 *
    QH * D operations a visible (row, key) pair."""
    qh, kh, d = case["shape"]
    q_lens, seq_lens, bt, kc = case["q_lens"], case["seq_lens"], case["bt"], case["args"][1]
    rows = case["args"][0].shape[0]
    row_pos = [s - ql + j for ql, s in zip(q_lens, seq_lens) for j in range(ql)]
    row_start = [max(p - window + 1, 0) if window else 0 for p in row_pos]
    starts = [max(s - ql - window + 1, 0) if window else 0 for ql, s in zip(q_lens, seq_lens)]
    bytes_moved = ((case["total"] + rows) * qh * d * 2 + 2 * unique_kv_rows(bt, seq_lens, starts) * kh * d
                   * kc.element_size() + bt.size * 4 + (len(q_lens) + 1 + len(seq_lens)) * 4)
    return bound(bytes_moved, 4 * qh * d * sum(p + 1 - a for p, a in zip(row_pos, row_start)))


# tests/gemma_rms_norm_test.py's tolerances (atol and rtol) for K10a.
GEMMA_NORM_TOLERANCES = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-3}
# K10a's timed steps: the kernel table's 8 rows (the row's numbers),
# Gemma-2-2B's served decode step (16) and a 512-row prefill chunk.
K10A_ROWS = (8, 16, 512)


def kernel_phase_k10a(gen) -> dict:
    """K10a at K10A_ROWS x 2304 in f32, f16 and bf16 (timed), weights
    random (so a kernel that dropped the (1 + w) would fail), at
    GEMMA_NORM_TOLERANCES; each step timed beside its bound, plain version
    and ``F.rms_norm`` with the weight 1 + w (``detail``). The row has the
    8-row numbers."""
    from conch_tpu_torch.kernels.normalization.gemma_rms_norm import (
        gemma_rms_norm_launcher as launch,
        gemma_rms_norm_plain as plain,
    )

    eps = 1e-6
    lib = getattr(torch.nn.functional, "rms_norm", None)
    err, detail = 0.0, []
    for rows in K10A_ROWS:
        for dtype in (torch.float32, torch.float16, torch.bfloat16):
            w = (0.5 * torch.randn((G_HIDDEN,), generator=gen, device="cuda")).to(dtype)
            x = torch.randn((rows, G_HIDDEN), generator=gen, device="cuda").to(dtype)
            got, ref = launch(x, w, eps), plain(x, w, eps)
            err = max(err, check_close(f"K10a gemma_rms_norm rows={rows} {dtype}", got, ref,
                                       GEMMA_NORM_TOLERANCES[dtype]))
        # One library call computes the same function given the weight 1 + w.
        w1 = (1.0 + w.float()).to(torch.bfloat16)
        b_ms, b_by = bound(2 * rows * G_HIDDEN * 2 + G_HIDDEN * 2, 5 * rows * G_HIDDEN)
        detail.append({
            "rows": rows, "bound_ms": b_ms, "bound_by": b_by,
            "ms": time_ms(lambda: launch(x, w, eps)),
            "paced_ms": paced_ms(lambda: launch(x, w, eps)),
            "plain_ms": time_ms(lambda: plain(x, w, eps)),
            "library_ms": time_ms(lambda: lib(x, (G_HIDDEN,), w1, eps)) if lib else None,
        })
    for d in detail:
        print(f"K10a rows={d['rows']}: {d['ms']:.4f} ms (paced {d['paced_ms']:.4f}, plain {d['plain_ms']:.4f}, "
              f"F.rms_norm(1+w) {d['library_ms']}, bound {d['bound_ms']:.6f} by {d['bound_by']})", flush=True)
    row = _kernel_row(
        "gemma_rms_norm", "conch_tpu_torch/csrc/gemma_rms_norm.cu",
        "conch_tpu/kernels/normalization/gemma_rms_norm.py:26", err, detail[0], detail[0]["bound_ms"],
        detail[0]["bound_by"],
    )
    row["detail"] = detail
    return row


# K10a's options (check_gemma_rms_norm_options): rows, widths (JAX's 128,
# 531 and 3072, Gemma-2-2B's 2304 and 2048, Gemma-2-9B's 3584, 27B's 4608,
# and 36872, past the register path in every dtype: the looped path) and
# layouts (contiguous; rows at a stride 64 elements longer; rows one
# element longer; contiguous rows from a base one element off).
NORM_OPTION_ROWS = (0, 1, 3, 8, 16, 512, 4096)
NORM_OPTION_HIDDEN = (128, 531, 2048, 2304, 3072, 3584, 4608, 36872)
NORM_OPTION_LAYOUTS = ("contiguous", "strided", "misaligned rows", "misaligned base")


def check_gemma_rms_norm_options(gen) -> None:
    """K10a over every option it takes (NORM_OPTION_*, f32, bf16 and f16,
    random weights, the programmatic-dependent launch on every other case)
    against the plain version at GEMMA_NORM_TOLERANCES; counts the cases on
    each path of ``gemma_norm_plan``."""
    from conch_tpu_torch.kernels.common import aligned16
    from conch_tpu_torch.kernels.normalization.gemma_rms_norm import (
        gemma_norm_plan,
        gemma_rms_norm_launcher as launch,
        gemma_rms_norm_plain as plain,
    )

    eps = 1e-6
    saved, failed, paths, cases, err = launch.pdl, [], {}, 0, {}
    try:
        for hidden, dtype in itertools.product(NORM_OPTION_HIDDEN, GEMMA_NORM_TOLERANCES):
            tol = GEMMA_NORM_TOLERANCES[dtype]
            w = (0.5 * torch.randn((hidden,), generator=gen, device="cuda")).to(dtype)
            for rows, layout in itertools.product(NORM_OPTION_ROWS, NORM_OPTION_LAYOUTS):
                x = _flat_rows(gen, rows, hidden, dtype, layout, hidden + 64 if layout == "strided" else None)
                plan = gemma_norm_plan(rows, hidden, x.element_size(), x.stride(0), aligned16(x))
                paths[plan.path] = paths.get(plan.path, 0) + 1
                launch.pdl = cases % 2 == 1
                got, ref = launch(x, w, eps), plain(x, w, eps)
                cases += 1
                name = f"{dtype} rows {rows} hidden {hidden} {layout}"
                if got.shape != ref.shape or not got.is_contiguous():
                    failed.append(f"{name}: shape {tuple(got.shape)}")
                elif rows:
                    diff = (got.float() - ref.float()).abs()
                    err[dtype] = max(err.get(dtype, 0.0), diff.max().item())
                    if not bool((diff <= tol + tol * ref.float().abs()).all()):
                        failed.append(f"{name}: max_abs_err {diff.max().item():.3e}")
                del x, got, ref
    finally:
        launch.pdl = saved
    torch.cuda.synchronize()
    names = {0: "vector", 1: "scalar", 2: "looped vector", 3: "looped scalar"}
    print(f"K10a options: {cases} cases (" + ", ".join(f"{names[k]} {v}" for k, v in sorted(paths.items()))
          + "); max_abs_err " + ", ".join(
              f"{dt} {e:.3e} (tolerance {GEMMA_NORM_TOLERANCES[dt]:.0e} + {GEMMA_NORM_TOLERANCES[dt]:.0e} * |ref|)"
              for dt, e in err.items()), flush=True)
    if failed:
        raise AssertionError(f"K10a options: {len(failed)} of {cases} cases failed: " + "; ".join(failed[:10]))
    torch.cuda.empty_cache()


def kernel_phase_k10b(gen) -> dict:
    """K10b on fused halves at 8 and 512 rows x 2*9216 in bf16 (timed) and
    f32, and on row-strided parts; tolerances of tests/activation_test.py:16.
    The row has the 8-row halves numbers."""
    from conch_tpu_torch.kernels.activation.gelu_tanh_and_mul import (
        gelu_tanh_and_mul_launcher as launch,
        gelu_tanh_and_mul_parts_launcher as launch_parts,
        gelu_tanh_and_mul_parts_plain as plain_parts,
        gelu_tanh_and_mul_plain as plain,
    )

    err, detail = 0.0, []
    for rows in (8, 512):
        for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 1e-2)):
            x = (2.0 * torch.randn((rows, 2 * G_INTER), generator=gen, device="cuda")).to(dtype)
            err = max(err, check_close(f"K10b gelu_tanh_and_mul halves rows={rows} {dtype}", launch(x), plain(x), tol))
            gate, up = x[:, :G_INTER], x[:, G_INTER:]  # row-strided parts
            err = max(err, check_close(
                f"K10b gelu_tanh_and_mul parts rows={rows} {dtype}", launch_parts(gate, up), plain_parts(gate, up), tol
            ))
        b_ms, b_by = bound(rows * G_INTER * 3 * 2, 10 * rows * G_INTER)
        detail.append({
            "rows": rows, "bound_ms": b_ms, "bound_by": b_by,
            "ms": time_ms(lambda: launch(x)),
            "paced_ms": paced_ms(lambda: launch(x)),
            "plain_ms": time_ms(lambda: plain(x)), "library_ms": None,
        })
    for d in detail:
        print(f"K10b halves rows={d['rows']}: {d['ms']:.4f} ms (paced {d['paced_ms']:.4f}, plain "
              f"{d['plain_ms']:.4f}, bound {d['bound_ms']:.5f} by {d['bound_by']})", flush=True)
    row = _kernel_row(
        "gelu_tanh_and_mul", "conch_tpu_torch/csrc/gelu_tanh_and_mul.cu",
        "conch_tpu/kernels/activation/gelu_tanh_and_mul.py:31", err, detail[0], detail[0]["bound_ms"],
        detail[0]["bound_by"],
    )
    row["detail"] = detail
    return row


def gemma_attention_phases(gen, rng, cache: str | None = None) -> dict[str, list[dict]]:
    """K3 and K7 at Gemma-2-2B's shapes (QH 8 / KH 4 / D 256, a 26-layer pool
    read at layer 17, softcap 50, scale 1/16), on a global layer (no window)
    and a local one (window 4096), with lengths past the window:
    - K3: a decode batch of 8 with lengths 1 to 6000 and an idle row that is
      not first (tolerance 3e-2, tests/paged_attention_test.py:21);
    - K7: a 512-row prefill step as the engine packs it: a mixed-in decode
      row at context 4200, a 7-token prompt, the last 400-token chunk of a
      4600-token prompt, zero-length padding sequences (16 in all, the
      served run's batch) and 104 padding rows (tolerance 2e-2,
      tests/varlen_attention_test.py:25).
    Queries are N(0, G_Q_GAIN^2), so the scaled logits have a standard
    deviation of about 12 and reach the cap: softcap 50 bends them by tens
    of percent, and the softmax is sharp enough that the rows come out of
    order 1, not averages near 0. Both kernels are held elementwise at
    ``tol + tol * |ref|``, as the JAX tests hold them. A kernel that drops
    the softcap, caps before the scale, or ignores the window fails these
    checks (``python3 -m conch_tpu_torch.tools.attention_mutants``).
    With ``cache`` ("int8", "fp8") the pool is quantized and read at
    KV_SCALES[cache]. Returns detail entries (timed, with bounds) for each
    kernel's row."""
    from conch_tpu_torch.kernels.attention.paged_attention import (
        paged_attention_launcher as k3_kv,
        paged_attention_plain as k3_plain_kv,
    )
    from conch_tpu_torch.kernels.attention.varlen_attention import (
        varlen_attention_launcher as k7_kv,
        varlen_attention_plain as k7_plain_kv,
    )

    dec = k3_inputs(gen, rng, "gemma2 table line", cache)
    pre = k7_inputs(gen, rng, "gemma2 table line", cache)
    k3, k3_plain, k7, k7_plain = (with_kv_scales(fn, cache) for fn in (k3_kv, k3_plain_kv, k7_kv, k7_plain_kv))
    out: dict[str, list[dict]] = {"paged_attention": [], "varlen_attention": []}
    for window in dec["windows"]:
        tag = f"gemma2 softcap {G_SOFTCAP:g} window {window}" + (f" {cache} cache" if cache else "")
        args = (*dec["args"], window)
        got, ref = k3(*args), k3_plain(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all() or got[dec["idle"]].abs().max().item() != 0.0:
            raise AssertionError(f"K3 ({tag}): the idle row must come out as finite zeros")
        err = check_close(f"K3 paged_attention {tag}", got, ref, 3e-2)
        b_ms, b_by = k3_bound(dec, window)
        out["paged_attention"].append({
            "case": tag, "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
            "ms": time_ms(lambda: k3(*args)), "paced_ms": paced_ms(lambda: k3(*args)),
            "plain_ms": time_ms(lambda: k3_plain(*args), iters=5), "library_ms": None,
        })

        args = (*pre["args"], window)
        got, ref = k7(*args), k7_plain(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all() or got[pre["total"]:].abs().max().item() != 0.0:
            raise AssertionError(f"K7 ({tag}): padding rows must come out as finite zeros")
        err = check_close(f"K7 varlen_attention {tag}", got, ref, 2e-2)
        b_ms, b_by = k7_bound(pre, window)
        out["varlen_attention"].append({
            "case": tag, "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
            "ms": time_ms(lambda: k7(*args)), "paced_ms": paced_ms(lambda: k7(*args)),
            "plain_ms": time_ms(lambda: k7_plain(*args), iters=5), "library_ms": None,
        })
    del pre, dec
    torch.cuda.empty_cache()
    for name, cases in out.items():
        for d in cases:
            print(f"{name} ({d['case']}): {d['ms']:.4f} ms (paced {d['paced_ms']:.4f}, plain {d['plain_ms']:.4f}, "
                  f"bound {d['bound_ms']:.5f} by {d['bound_by']})", flush=True)
    return out


def check_to_rms(name: str, out: torch.Tensor, ref: torch.Tensor, tol: float) -> float:
    """Hold ``out`` to ``ref`` elementwise at ``|out - ref| <= tol * (|ref| +
    rms)``, rms that of ref over the last dimension (one head of one row):
    a limit that follows the output's size, so that a flat softmax's small
    outputs are held as tightly as a peaked one's, and an idle row must be
    exactly zero. One ulp of bf16 is at most 2^-7 |ref|. Returns the max
    abs error."""
    ref32 = ref.float()
    limit = tol * (ref32.abs() + ref32.pow(2).mean(-1, keepdim=True).sqrt())
    diff = (out.float() - ref32).abs()
    err = diff.max().item()
    worst = (diff / limit.clamp_min(torch.finfo(torch.float32).tiny)).max().item() * tol
    print(f"{name}: max_abs_err {err:.3e}, worst |out - ref| / (|ref| + rms) {worst:.3e} (tolerance {tol:.0e})",
          flush=True)
    if not bool((diff <= limit).all()):
        msg = f"{name}: outside {tol} x (|ref| + rms) (max_abs_err {err}, worst ratio {worst})"
        raise AssertionError(msg)
    return err


def kernel_phase_k3_served(gen, rng) -> list[dict]:
    """K3 at the served decode steps of K3_CASES (Gemma without and with
    the 4096 window), against the plain version at 1e-2 x (|ref| + the
    head's rms) (``check_to_rms``: Llama's N(0, 1) queries give a nearly
    flat softmax over hundreds of tokens, outputs near 0.05, which the
    table lines' 3e-2 + 3e-2 x |ref| would hold too loosely), idle rows
    exactly zero; timed. Returns detail entries of K3's row."""
    from conch_tpu_torch.kernels.attention.paged_attention import (
        paged_attention_launcher as launch,
        paged_attention_plain as plain,
    )

    cases = []
    for label in ("llama3_8b int4 served decode", "gemma2 served decode"):
        case = k3_inputs(gen, rng, label)
        live = len(case["seq_lens"]) - len(case["idle"])
        for window in case["windows"]:
            tag = f"{label}, {live} of {len(case['seq_lens'])} rows live, window {window}"
            args = (*case["args"], window)
            got, ref = launch(*args), plain(*args)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all() or got[case["idle"]].abs().max().item() != 0.0:
                raise AssertionError(f"K3 ({tag}): idle rows must come out as finite zeros")
            err = check_to_rms(f"K3 paged_attention {tag}", got, ref, 1e-2)
            b_ms, b_by = k3_bound(case, window)
            entry = {
                "case": tag, "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
                "ms": time_ms(lambda: launch(*args)), "paced_ms": paced_ms(lambda: launch(*args)),
                "plain_ms": time_ms(lambda: plain(*args), iters=3, warmup=1), "library_ms": None,
            }
            print(f"paged_attention ({tag}): {entry['ms']:.4f} ms (paced {entry['paced_ms']:.4f}, plain "
                  f"{entry['plain_ms']:.4f}, bound {b_ms:.5f} by {b_by})", flush=True)
            cases.append(entry)
        del case
        torch.cuda.empty_cache()
    return cases


# DeepSeek-V2-Lite (DeepseekV2Config.v2_lite()): 16 heads, packed latent
# rows of 640 (c_kv 512 | k_pe 64 | pad 64), 27 layers, softmax scale
# 1 / sqrt(128 + 64).
DS_HEADS, DS_PACKED, DS_LATENT, DS_ROPE, DS_LAYERS = 16, 640, 512, 64, 27
DS_LAYER = 13  # a non-zero layer inside the 27-layer pool
DS_SCALE = 1.0 / math.sqrt(192)
# K11 against its plain version: f32 at tests/mla_attention_test.py:83's
# 2e-4; bf16 at the port's K3/K7 attention tolerance, 3e-2 + 3e-2 x |ref|.
K11_TOLERANCES = {torch.float32: 2e-4, torch.bfloat16: 3e-2}


def k11_inputs(gen, rng, cache: str | None = None) -> dict:
    """K11's cases at DeepSeek-V2-Lite's shapes over a 27-layer latent pool
    read at layer 13 (``kernel_phase_k11``'s, and the tools'):
    - "decode": a decode step of batch 8 at lengths 0 (an idle row, first)
      to 4000;
    - "prefill": a 512-row prefill step as the engine packs it: a mixed-in
      decode row at context 1500, a fresh 200-token prompt, a 150-token
      chunk at context 1800, a 100-token chunk at context 164 whose first 4
      pages are another sequence's, 12 zero-length padding sequences (16 in
      all, the served run's batch) and 61 padding rows.
    Queries and rows have zero pad columns, as the model writes them. With
    ``cache`` ("int8", "fp8") the latent pool is quantized at kv_scale
    KV_SCALES[cache][0]. ``cases`` maps a case to (queries in f32, cu_seqlens_q,
    max_seqlen_q, seq_lens, block table)."""
    max_pages = 256
    dec_lens = [0, 1, 17, 300, 1000, 2047, 3000, 4000]
    pre_q = [1, 200, 150, 100] + [0] * 12
    pre_k = [1500, 200, 1800, 164] + [0] * 12
    rows = 512
    num_pages = sum(-(-n // PS) for n in dec_lens + pre_k) + 1
    bt_all = paged_layout(rng, dec_lens + pre_k, num_pages, share=(10, 11), shared_pages=4, max_pages=max_pages)
    bt_dec, bt_pre = bt_all[: len(dec_lens)], bt_all[len(dec_lens) :]
    pool = torch.randn((DS_LAYERS, num_pages, PS, DS_PACKED), generator=gen, device="cuda")
    pool[..., DS_LATENT + DS_ROPE :] = 0.0
    kv_scale = 1.0 if cache is None else KV_SCALES[cache][0]
    if cache is not None:
        from conch_tpu_torch.kernels.cache.reshape_and_cache import quantize_store

        pool = quantize_store(pool, kv_scale, KV_CACHES[cache])
    q_all = torch.randn((len(dec_lens) + rows, DS_HEADS, DS_PACKED), generator=gen, device="cuda")
    q_all[..., DS_LATENT + DS_ROPE :] = 0.0
    cu_pre = np.concatenate([[0], np.cumsum(pre_q)]).astype(np.int32)
    return {"pool": pool, "kv_scale": kv_scale, "total_prefill": sum(pre_q), "cases": {
        "decode": (q_all[: len(dec_lens)], np.arange(len(dec_lens) + 1, dtype=np.int32), 1, dec_lens, bt_dec),
        "prefill": (q_all[len(dec_lens) :], cu_pre, 256, pre_k, bt_pre),
    }}


def k11_args(inputs: dict, case: str, dtype: torch.dtype) -> tuple[tuple, dict]:
    """(args, keyword arguments) of one ``k11_inputs`` case for queries of
    ``dtype``, read at layer DS_LAYER (a float pool in ``dtype``)."""
    pool = inputs["pool"]
    layer = pool[DS_LAYER] if pool.dtype in (torch.int8, torch.float8_e4m3fn) else pool[DS_LAYER].to(dtype)
    q, cu, max_q, kv_lens, bt = inputs["cases"][case]
    args = (q.to(dtype), layer, torch.from_numpy(cu).cuda(), max_q,
            torch.tensor(kv_lens, dtype=torch.int32, device="cuda"), torch.from_numpy(bt).cuda())
    return args, {"scale": DS_SCALE, "latent": DS_LATENT, "kv_scale": inputs["kv_scale"]}


def kernel_phase_k11(gen, rng, cache: str | None = None) -> dict:
    """K11 on ``k11_inputs``' decode and prefill steps, in f32 and bf16,
    against its plain version. The row has the bf16 decode numbers;
    ``detail`` every case. With ``cache`` ("int8", "fp8") the pool is
    quantized and read by bf16 queries (f32 queries over such caches are
    held in ``check_mla_attention_options``)."""
    from conch_tpu_torch.kernels.attention.mla_attention import (
        mla_attention_launcher as launch,
        mla_attention_plain as plain,
    )

    inputs = k11_inputs(gen, rng, cache)
    total = inputs["total_prefill"]
    detail, err_all = [], 0.0
    for dtype in (torch.float32, torch.bfloat16) if cache is None else (torch.bfloat16,):
        for case in inputs["cases"]:
            args, kw = k11_args(inputs, case, dtype)
            q, layer, cu, bt = args[0], args[1], inputs["cases"][case][1], inputs["cases"][case][4]
            kv_lens = inputs["cases"][case][3]
            got, ref = launch(*args, **kw), plain(*args, **kw)
            torch.cuda.synchronize()
            zero_rows = got[0] if case == "decode" else got[total:]
            if not torch.isfinite(got).all() or zero_rows.abs().max().item() != 0.0:
                raise AssertionError(f"K11 ({case}): idle and padding rows must come out as finite zeros")
            tag = f"{case} {str(dtype).removeprefix('torch.')}" + (f" {cache} cache" if cache else "")
            err = check_close(f"K11 mla_attention {tag}", got, ref, K11_TOLERANCES[dtype])
            err_all = max(err_all, err)
            entry = {"case": tag, "max_abs_err": err}
            if dtype == torch.bfloat16:
                q_lens = np.diff(cu).tolist()
                visible = sum(s - ql + j + 1 for ql, s in zip(q_lens, kv_lens) for j in range(ql))
                bytes_moved = (unique_kv_rows(bt, kv_lens) * DS_PACKED * layer.element_size() + q.numel() * 2
                               + q.shape[0] * DS_HEADS * DS_LATENT * 2 + bt.size * 4 + (len(cu) + len(kv_lens)) * 4)
                b_ms, b_by = bound(bytes_moved, 2 * DS_HEADS * (DS_PACKED + DS_LATENT) * visible)
                entry.update({
                    "bound_ms": b_ms, "bound_by": b_by, "ms": time_ms(lambda: launch(*args, **kw)),
                    "paced_ms": paced_ms(lambda: launch(*args, **kw)),
                    "plain_ms": time_ms(lambda: plain(*args, **kw), iters=5), "library_ms": None,
                })
                print(f"K11 mla_attention ({entry['case']}): {entry['ms']:.4f} ms (paced {entry['paced_ms']:.4f}, "
                      f"plain {entry['plain_ms']:.4f}, bound {b_ms:.5f} by {b_by})", flush=True)
            detail.append(entry)
    del inputs
    torch.cuda.empty_cache()
    main = next(d for d in detail if d["case"].startswith("decode bfloat16"))
    row = _kernel_row(
        "mla_attention", "conch_tpu_torch/csrc/mla_attention.cu", "conch_tpu/kernels/attention/mla_attention.py:51",
        err_all, main, main["bound_ms"], main["bound_by"],
    )
    row["detail"] = detail
    return row


# K11's option sweep: (query, latent cache) dtypes, head counts (64-row
# tiles hold 4 tokens of 16 heads, 64 tokens of 1, 21 tokens and a third
# of 3, half a token of 128), (latent, packed) widths, and three ragged
# steps over tables of 8 pages (one split) and 64 pages (splits of 128
# keys): a decode step with an idle row and lengths at stage (32) and
# split (128) edges, a prefill step with zero-length sequences, a decode
# row, a chunk at a split edge and padding rows after a zero-length last
# sequence, and a step whose last sequence is real with padding rows
# after it. In each step two sequences share their first two pages.
MLA_OPTION_TYPES = (
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8),
    (torch.bfloat16, torch.float8_e4m3fn), (torch.float32, torch.int8), (torch.float32, torch.float8_e4m3fn),
)
MLA_OPTION_HEADS = (16, 1, 3, 128)
MLA_OPTION_WIDTHS = ((512, 640), (128, 128), (256, 384), (384, 512), (512, 896))
MLA_OPTION_STEPS = {  # name: (q_lens, seq_lens, rows, the sequences that share pages)
    "decode": ([1, 1, 1, 1, 1, 1, 1], [0, 31, 32, 33, 128, 129, 257], 9, (2, 3)),
    "prefill": ([1, 40, 0, 9, 33, 1, 0], [100, 40, 0, 121, 128, 300, 0], 90, (3, 4)),
    "last real": ([1, 9, 40], [0, 121, 40], 64, (1, 2)),
}


def check_mla_attention_options(gen, rng) -> None:
    """K11 at every option it takes, against its plain version: the
    (query, cache) dtypes of MLA_OPTION_TYPES (1-byte caches at
    KV_SCALES[..][0], read by bf16 and by f32 queries), heads
    MLA_OPTION_HEADS, (latent, packed) MLA_OPTION_WIDTHS, causal and not,
    the steps of MLA_OPTION_STEPS over 8- and 64-page tables, with
    ``max_seqlen_q`` the real maximum or 3 above it. Tolerance
    K11_TOLERANCES of the matrix-unit type (bf16 for bf16 queries and for
    e4m3 caches, whose rows the TPU kernel multiplies in bf16; f32
    otherwise), padding rows included (copies of the last sequence's
    tokens, or zeros); pages that no row may see are NaN in the pool the
    kernel reads (float caches); every case twice, bit for bit. Errors are
    gathered on the card and read once."""
    from conch_tpu_torch.kernels.attention.mla_attention import (
        mla_attention_launcher as launch,
        mla_attention_plain as plain,
        mla_tile_plan,
    )
    from conch_tpu_torch.kernels.cache.reshape_and_cache import quantize_store
    from conch_tpu_torch.kernels.common import sm_count

    names, errs, over, same, splits_seen = [], [], [], [], set()
    for step, (q_lens, lens, rows, share) in MLA_OPTION_STEPS.items():
        for table in (8, 64):
            lens_t = [min(n, table * PS) for n in lens]
            num_pages = sum(-(-n // PS) for n in lens_t) + 2
            poison = num_pages - 1
            bt = paged_layout(rng, lens_t, num_pages - 1, share=share, shared_pages=2, max_pages=table)
            bt[bt == 0] = poison  # the table's padding (page 0 is never drawn)
            bt_t = torch.from_numpy(bt).cuda()
            cu_t = torch.tensor(np.concatenate([[0], np.cumsum(q_lens)]), dtype=torch.int32, device="cuda")
            sl_t = torch.tensor(lens_t, dtype=torch.int32, device="cuda")
            for latent, packed in MLA_OPTION_WIDTHS:
                base = torch.randn((num_pages, PS, packed), generator=gen, device="cuda")
                for q_dt, c_dt in MLA_OPTION_TYPES:
                    one_byte = c_dt in (torch.int8, torch.float8_e4m3fn)
                    kv_scale = KV_SCALES["int8" if c_dt == torch.int8 else "fp8"][0] if one_byte else 1.0
                    pool = quantize_store(base, kv_scale, c_dt) if one_byte else base.to(c_dt)
                    if not one_byte:
                        pool = pool.clone()
                        pool[poison] = float("nan")
                    mxu = torch.bfloat16 if q_dt == torch.bfloat16 or c_dt == torch.float8_e4m3fn else torch.float32
                    tol = K11_TOLERANCES[mxu]
                    for heads in MLA_OPTION_HEADS:
                        q = torch.randn((rows, heads, packed), generator=gen, device="cuda").to(q_dt)
                        for causal in (True, False):
                            plan = mla_tile_plan(rows, len(lens), table, PS, heads, packed, latent, causal,
                                                 sm_count(0))
                            splits_seen.add(plan.splits)
                            max_q = max(q_lens) + (3 if (heads + causal) % 2 else 0)
                            args = (q, pool, cu_t, max_q, sl_t, bt_t)
                            kw = {"scale": packed**-0.5, "latent": latent, "causal": causal, "kv_scale": kv_scale}
                            out, again = launch(*args, **kw), launch(*args, **kw)
                            ref_pool = pool if one_byte else base.to(c_dt)
                            ref = plain(q, ref_pool, cu_t, max_q, sl_t, bt_t, **kw)
                            names.append(f"K11 {step} table {table} q {str(q_dt)[6:]} cache {str(c_dt)[6:]} heads "
                                         f"{heads} latent {latent} packed {packed} "
                                         f"{'causal' if causal else 'non-causal'} max_seqlen_q {max_q} "
                                         f"({plan.splits} splits)")
                            diff = (out.float() - ref.float()).abs()
                            errs.append(diff.max())
                            over.append((diff - tol - tol * ref.float().abs()).max())  # <= 0: inside
                            same.append(torch.equal(out, again))
                del base
    err_list, over_list, same_list = (torch.stack(errs).tolist(), torch.stack(over).tolist(),
                                      torch.tensor(same).tolist())
    print(f"K11 mla_attention options: {len(names)} cases (splits {sorted(splits_seen)}), worst max_abs_err "
          f"{max(err_list):.3e}; {sum(same_list)} bit for bit across two calls", flush=True)
    bad = [(name, e) for name, e, o in zip(names, err_list, over_list) if not o <= 0.0]
    for name, e in bad[:40]:
        print(f"{name}: max_abs_err {e:.3e} outside the tolerance", flush=True)
    if bad:
        raise AssertionError(f"{len(bad)} of {len(names)} K11 option cases fail")
    if not all(same_list):
        raise AssertionError(f"{len(same_list) - sum(same_list)} K11 option cases differ between two calls")


# K12q's option sweep: every power-of-two blocksize from 8 to 4096 (the
# vector path) and 2, 6, 100 and 1000 (the scalar path), sizes of 5 blocks
# and of 3 blocks and 6 elements (a ragged last block whose last chunk is
# not whole), inputs starting 16-, 8- and 4-byte aligned.
QUANTIZE4_OPTION_BLOCKSIZES = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 2, 6, 100, 1000)
QUANTIZE4_OPTION_OFFSETS = (0, 8, 4)  # bytes past a 16-byte boundary


def check_quantize4_options(gen) -> None:
    """K12q at every option it takes, byte for byte against its plain
    version: QUANTIZE4_OPTION_BLOCKSIZES, f32, bf16 and f16 inputs, nf4 and
    fp4, the sizes and start offsets above. Block 0 is all zeros (absmax 0,
    reciprocal 0); in f32 inputs block 1 holds 1 and -1 and, where it has
    room, every NF4 and FP4 threshold exactly (zeros elsewhere, so its
    absmax is 1), so a compare that is not strict changes a code. Mismatches are gathered on the card and read
    once."""
    from conch_tpu_torch.kernels.quantization.bitsandbytes.blockwise import (
        FP4_THRESHOLDS,
        nf4_thresholds,
        quantize4_launcher as launch,
        quantize4_plain as plain,
    )

    edges = torch.cat([torch.tensor([1.0, -1.0], device="cuda"), nf4_thresholds("cuda"),
                       torch.tensor(FP4_THRESHOLDS, dtype=torch.float32, device="cuda"),
                       -torch.tensor(FP4_THRESHOLDS, dtype=torch.float32, device="cuda")])
    names, bad = [], []
    for blocksize in QUANTIZE4_OPTION_BLOCKSIZES:
        for size in (5 * blocksize, 3 * blocksize + 6):
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                for offset in QUANTIZE4_OPTION_OFFSETS:
                    pad = offset * 8 // torch.finfo(dtype).bits  # elements
                    buf = torch.randn(size + 16, generator=gen, device="cuda").to(dtype)
                    x = buf[pad : pad + size]
                    x[:blocksize] = 0.0
                    if dtype == torch.float32 and size > blocksize:
                        n = min(blocksize, edges.numel(), size - blocksize)
                        x[blocksize : 2 * blocksize] = 0.0  # absmax 1: every edge value is scaled by exactly 1
                        x[blocksize : blocksize + n] = edges[:n]
                    for quant_type in ("nf4", "fp4"):
                        got, ref = launch(x, blocksize, quant_type), plain(x, blocksize, quant_type)
                        names.append(f"K12q {quant_type} blocksize {blocksize} size {size} {str(dtype)[6:]} "
                                     f"start +{offset} bytes")
                        bad.append((got[0] != ref[0]).sum() + (got[1] != ref[1]).sum())
    bad_list = torch.stack(bad).tolist()
    print(f"K12q quantize4 options: {len(names)} cases, {sum(b == 0 for b in bad_list)} byte for byte", flush=True)
    for name, b in zip(names, bad_list):
        if b:
            print(f"{name}: {b} bytes or absmax differ", flush=True)
    if any(bad_list):
        raise AssertionError(f"{sum(b != 0 for b in bad_list)} of {len(names)} K12q option cases differ")


# K9 at a decode batch and a prefill chunk of Llama-3-8B's hidden size, and
# at a hidden size off the TPU kernel's 128 lanes whose element count
# leaves a tail past the kernel's 8-element loads; from f32, bf16 and f16.
K9_SHAPES = ((8, HIDDEN), (512, HIDDEN), (7, 4097))
K9_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
K9_SCALE = 0.37  # here x * f32(1 / scale) and x / scale truncate differently on some inputs


def kernel_phase_k9(gen) -> dict:
    """K9 through its public ops (``scaled_int8_quant``, ``scaled_fp8_quant``),
    its only callers: every K9_SHAPES x K9_DTYPES input of N(0, 100^2)
    values (past both ranges) to int8 and to e4m3, held byte for byte
    against the plain versions. No model calls K9, so its launches are
    those of these public-op calls (counted from 0 just before them). The
    row has the int8 numbers at 512 x 4096 bf16; ``detail`` int8 and fp8
    at 8 and 512 rows."""
    from conch_tpu_torch.kernels.quantization.fp8 import (
        static_scaled_fp8_quant_launcher as fp8_kernel,
        static_scaled_fp8_quant_plain as fp8_plain,
    )
    from conch_tpu_torch.kernels.quantization.int8 import (
        static_scaled_int8_quant_launcher as int8_kernel,
        static_scaled_int8_quant_plain as int8_plain,
    )
    from conch_tpu_torch.ops.quantization import scaled_fp8_quant, scaled_int8_quant

    scale = torch.tensor([K9_SCALE], device="cuda")
    inputs = {
        (r, h, dt): (100.0 * torch.randn((r, h), generator=gen, device="cuda")).to(dt)
        for r, h in K9_SHAPES for dt in K9_DTYPES
    }
    ops = {"int8": (scaled_int8_quant, int8_plain, int8_kernel), "fp8": (scaled_fp8_quant, fp8_plain, fp8_kernel)}
    int8_kernel.launches = fp8_kernel.launches = 0
    outs = {(kind, key): op(x, scale)[0] for kind, (op, _, _) in ops.items() for key, x in inputs.items()}
    torch.cuda.synchronize()
    launches = int8_kernel.launches + fp8_kernel.launches
    if launches != len(outs):
        raise AssertionError(f"K9: {launches} launches for {len(outs)} public-op calls")
    differing = 0
    for (kind, key), out in outs.items():
        ref = ops[kind][1](inputs[key], scale)
        if out.dtype != ref.dtype or out.shape != ref.shape:
            raise AssertionError(f"K9 {kind} {key}: {out.dtype} {tuple(out.shape)}, expected {ref.dtype}")
        differing += int((cache_bytes(out) != cache_bytes(ref)).sum())
    check(f"K9 static_scaled_quant, {len(outs)} cases: bytes differing", float(differing), 0.0)
    detail = []
    for kind, (_, plain, kernel) in ops.items():
        for rows in (8, 512):
            x = inputs[(rows, HIDDEN, torch.bfloat16)]
            b_ms, b_by = bound(x.numel() * 3 + 4, 2 * x.numel(), F32_OPS_PER_S)
            detail.append({
                "case": f"{kind} {rows}x{HIDDEN} bf16", "max_abs_err": 0.0, "bound_ms": b_ms, "bound_by": b_by,
                "ms": time_ms(lambda: kernel(x, scale)), "paced_ms": paced_ms(lambda: kernel(x, scale)),
                "plain_ms": time_ms(lambda: plain(x, scale)), "library_ms": None,
            })
    for d in detail:
        print(f"K9 {d['case']}: {d['ms']:.4f} ms (paced {d['paced_ms']:.4f}, plain {d['plain_ms']:.4f}, "
              f"bound {d['bound_ms']:.5f} by {d['bound_by']})", flush=True)
    main = detail[1]
    row = _kernel_row(
        "static_scaled_quant", "conch_tpu_torch/csrc/static_quant.cu",
        "conch_tpu/kernels/quantization/int8.py:22; conch_tpu/kernels/quantization/fp8.py:25", float(differing),
        main, main["bound_ms"], main["bound_by"],
    )
    row["detail"] = detail
    row["phase_launches"] = launches
    return row


def check_attention_scales(gen) -> None:
    """K3 and K7 apply the dequantization scales over a plain f32 cache
    (``kv_cache_dtype`` "auto"), as the JAX kernels do: f32, batch 2, QH 4 /
    KH 1 / D 128, page 16, 8 pages, seq_lens [37, 50], k_scale 2, v_scale 3,
    and for K7 five causal query rows (cu_seqlens_q [0, 2, 5]) and q_scale
    1.5, held against the plain versions at the JAX tests' f32 2e-3."""
    from conch_tpu_torch.kernels.attention.paged_attention import (
        paged_attention_launcher as k3,
        paged_attention_plain as k3_plain,
    )
    from conch_tpu_torch.kernels.attention.varlen_attention import (
        varlen_attention_launcher as k7,
        varlen_attention_plain as k7_plain,
    )

    kc, vc = (torch.randn((1, 8, 1, PS, D), generator=gen, device="cuda") for _ in range(2))
    bt = torch.tensor([[0, 1, 2, 0], [3, 4, 5, 6]], dtype=torch.int32, device="cuda")
    sl = torch.tensor([37, 50], dtype=torch.int32, device="cuda")
    scale, scales = 1.0 / math.sqrt(D), {"k_scale": 2.0, "v_scale": 3.0}
    q = torch.randn((2, 4, D), generator=gen, device="cuda")
    args = (q, kc, vc, bt, sl, scale, 0)
    check_close("K3 paged_attention f32 cache, k_scale 2, v_scale 3", k3(*args, **scales), k3_plain(*args, **scales),
                2e-3)
    q = torch.randn((5, 4, D), generator=gen, device="cuda")
    cu = torch.tensor([0, 2, 5], dtype=torch.int32, device="cuda")
    args, scales = (q, kc, vc, cu, sl, bt, scale, True, 0), {**scales, "q_scale": 1.5}
    check_close("K7 varlen_attention f32 cache, q_scale 1.5, k_scale 2, v_scale 3", k7(*args, **scales),
                k7_plain(*args, **scales), 2e-3)


# K3's option sweep: (query, cache) dtypes, GQA groups, head sizes (34:
# rows copied 4 bytes at a time, or element by element for 1-byte caches),
# softcap, windows (37: not a page multiple), and a wide block table (up to
# 1024 tokens: several splits, merged) and a narrow one (one split).
PAGED_OPTION_TYPES = (
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.int8), (torch.bfloat16, torch.float8_e4m3fn), (torch.float32, torch.int8),
    (torch.float32, torch.float8_e4m3fn),
)
PAGED_OPTION_GROUPS = (1, 4, 8)
PAGED_OPTION_HEADS = (64, 128, 256, 34)
PAGED_OPTION_LENS = [0, 1, 17, 300, 700, 1000]  # row 0 idle; row 4 shares row 3's first 8 pages
PAGED_OPTION_KH, PAGED_OPTION_LAYERS = 2, 3


def _option_pool(gen, num_pages: int, d: int, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    shape = (PAGED_OPTION_LAYERS, num_pages, PAGED_OPTION_KH, PS, d)
    if dtype in (torch.int8, torch.float8_e4m3fn):
        cache = "int8" if dtype == torch.int8 else "fp8"
        return quant_pool(gen, num_pages, PAGED_OPTION_LAYERS, PAGED_OPTION_KH, d, cache)
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(2))


def _poisoned(pool: torch.Tensor, pages: list[int]) -> torch.Tensor:
    """A copy of ``pool`` with ``pages`` (of every layer) set to NaN (e4m3:
    its NaN code), so that a read of them shows in the output."""
    out = pool.clone()
    if out.dtype == torch.float8_e4m3fn:
        out.view(torch.uint8)[:, pages] = 0x7F
    else:
        out[:, pages] = float("nan")
    return out


def check_paged_attention_options(gen, rng) -> None:
    """K3 at every option it takes, against its plain version: the (query,
    cache) dtypes of ``PAGED_OPTION_TYPES`` (1-byte caches at KV_SCALES),
    GQA groups ``PAGED_OPTION_GROUPS``, head sizes ``PAGED_OPTION_HEADS``,
    softcap 0 and 30, windows 0, 37 and 500, a 64-page block table (KV
    splits merged) and a 4-page one (one split), idle row 0, shared prefix
    pages, layer 2 of a 3-layer pool. Tolerance 3e-2 (3e-2 + 3e-2 x |ref|
    on 1-byte caches); idle rows exactly zero; every case twice, bit for
    bit. On float caches every page that no row may see (the block table's
    padding, pages wholly before a window) is NaN in the pool the kernel
    reads, so a read of one fails the case. Then one call is captured in a
    CUDA graph: its replay must equal the eager call, and again after
    seq_lens changed in place (the wrapper reads no value on the host).
    Errors are gathered on the card and read once."""
    from conch_tpu_torch.kernels.attention.paged_attention import (
        paged_attention_launcher as launch,
        paged_attention_plain as plain,
        paged_split_plan,
    )
    from conch_tpu_torch.kernels.common import sm_count

    lens = PAGED_OPTION_LENS
    num_pages = sum(-(-n // PS) for n in lens) + 2
    poison_page = num_pages - 1
    bt = paged_layout(rng, lens, num_pages - 1, share=(3, 4), shared_pages=8, max_pages=64)
    bt[bt == 0] = poison_page  # padding entries (page 0 is never drawn by paged_layout)
    tables = {"wide": (bt, lens), "narrow": (bt[:, :4].copy(), [min(n, 4 * PS) for n in lens])}
    names, errs, tols, same, idle, splits_seen = [], [], [], [], [], set()
    for q_dt, c_dt in PAGED_OPTION_TYPES:
        one_byte = c_dt in (torch.int8, torch.float8_e4m3fn)
        ks, vs = KV_SCALES["int8" if c_dt == torch.int8 else "fp8"] if one_byte else (1.0, 1.0)
        for group in PAGED_OPTION_GROUPS:
            for d in PAGED_OPTION_HEADS:
                kc, vc = _option_pool(gen, num_pages, d, c_dt)
                q = (6.0 * torch.randn((len(lens), group * PAGED_OPTION_KH, d), generator=gen, device="cuda")).to(q_dt)
                scale = d**-0.5
                for tlabel, (table, seq_lens) in tables.items():
                    bt_t = torch.from_numpy(table).cuda()
                    sl_t = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
                    for window in (0, 37, 500):
                        seen = {int(table[b, pos // PS]) for b, n in enumerate(seq_lens)
                                for pos in range(max(n - window, 0) if window else 0, n)}
                        hidden = sorted({int(p) for p in table.reshape(-1)} - seen)
                        kp, vp = (kc, vc) if c_dt == torch.int8 else (_poisoned(kc, hidden), _poisoned(vc, hidden))
                        plan = paged_split_plan(sl_t, bt_t, PS, PAGED_OPTION_KH, window, sm_count(0))
                        splits_seen.add(plan.splits)
                        for softcap in (0.0, 30.0):
                            args = (q, kp, vp, bt_t, sl_t, scale, 2, softcap, window, ks, vs)
                            out, again = launch(*args), launch(*args)
                            ref = plain(q, kc, vc, bt_t, sl_t, scale, 2, softcap, window, ks, vs)
                            names.append(f"K3 q {str(q_dt)[6:]} cache {str(c_dt)[6:]} G {group} D {d} {tlabel} table "
                                         f"({plan.splits} splits) window {window} softcap {softcap:g}")
                            diff = (out.float() - ref.float()).abs()
                            tol = 3e-2 + (3e-2 * ref.float().abs() if one_byte else 0.0)
                            errs.append(diff.max())
                            tols.append((diff - tol).max())  # <= 0 when every element is inside
                            same.append(torch.equal(out, again))
                            idle.append(out[0].float().abs().max())
    err_list, over, same_list, idle_list = (torch.stack(errs).tolist(), torch.stack(tols).tolist(),
                                            torch.tensor(same).tolist(), torch.stack(idle).tolist())
    print(f"K3 paged_attention options: {len(names)} cases (splits {sorted(splits_seen)}), worst max_abs_err "
          f"{max(err_list):.3e}; {sum(same_list)} bit for bit across two calls", flush=True)
    bad = [(name, e) for name, e, o, i in zip(names, err_list, over, idle_list) if not (o <= 0.0 and i == 0.0)]
    for name, e in bad:
        print(f"{name}: max_abs_err {e:.3e} outside the tolerance, or the idle row not exactly zero", flush=True)
    if bad:
        raise AssertionError(f"{len(bad)} of {len(names)} K3 option cases fail")
    if not all(same_list):
        raise AssertionError(f"{len(same_list) - sum(same_list)} K3 option cases differ between two calls")

    # One call in a CUDA graph, replayed: the same bits as the eager call,
    # and again after seq_lens changed in place.
    kc, vc = _option_pool(gen, num_pages, D, torch.bfloat16)
    q = torch.randn((len(lens), 4 * PAGED_OPTION_KH, D), generator=gen, device="cuda").to(torch.bfloat16)
    bt_t = torch.from_numpy(bt).cuda()
    sl_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    args = (q, kc, vc, bt_t, sl_t, D**-0.5, 2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch(*args)  # warm-up outside the capture (builds and binds the kernel)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = launch(*args)
    for step, new_lens in enumerate((lens, [5, 0, 1000, 64, 999, 333])):
        sl_t.copy_(torch.tensor(new_lens, dtype=torch.int32))
        graph.replay()
        eager = launch(*args)
        torch.cuda.synchronize()
        if not torch.equal(captured, eager):
            diff = (captured.float() - eager.float()).abs().max().item()
            raise AssertionError(f"K3 in a CUDA graph: replay {step} differs from the eager call (max {diff})")
    print("K3 paged_attention in a CUDA graph: two replays (seq_lens changed in place between them) bit for bit "
          "equal to the eager calls", flush=True)


# K7's option sweep: the (query, cache) dtypes and GQA groups of K3's
# sweep, head sizes 64, 128, 256 and 34 (rows copied 4 bytes at a time, or
# element by element for 1-byte caches; zero-padded to 64 in shared
# memory), causal or not, softcap, windows (37: not a page multiple), and
# one ragged step: a decode row mixed in (context 700), a zero-length
# sequence between live ones, a fresh 77-token prompt (tiles crossing the
# diagonal), the last 150-token chunk of a 1000-token prompt and a 40-token
# chunk of a 300-token prompt whose first 8 pages are that prompt's, a
# zero-length padding sequence and 12 padding rows, over a 64-page table
# (its splits merged; under window 37 one split).
VARLEN_OPTION_QLENS = [1, 0, 77, 150, 40, 0]
VARLEN_OPTION_LENS = [700, 0, 77, 1000, 300, 0]
VARLEN_OPTION_ROWS = 280
VARLEN_OPTION_GRAPH = ([5, 20, 0, 200, 43, 0], [64, 20, 0, 1000, 999, 0])  # q_lens, seq_lens after the change


def check_varlen_attention_options(gen, rng) -> None:
    """K7 at every option it takes, against its plain version: the (query,
    cache) dtypes of ``PAGED_OPTION_TYPES`` (1-byte caches at KV_SCALES),
    GQA groups ``PAGED_OPTION_GROUPS`` over 2 KV heads, head sizes
    ``PAGED_OPTION_HEADS``, causal and not, softcap 0 and 30, windows 0, 37
    and 500, on the ragged step of ``VARLEN_OPTION_QLENS`` (layer 2 of a
    3-layer pool). Tolerance 2e-2 + 2e-2 x |ref| (bf16 P in the tensor-core
    PV product; the JAX tests' 2e-2); padding rows exactly zero; every case
    twice, bit for bit. On float caches every page that no row may see (the
    block table's padding, pages wholly before a sequence's first window) is
    NaN in the pool the kernel reads, so a read of one fails the case. Then
    one call is captured in a CUDA graph: its replay must equal the eager
    call, and again after cu_seqlens_q and seq_lens changed in place (the
    wrapper reads no value on the host). Errors are gathered on the card
    and read once; the case count is printed."""
    from conch_tpu_torch.kernels.attention.varlen_attention import (
        varlen_attention_launcher as launch,
        varlen_attention_plain as plain,
        varlen_tile_plan,
    )
    from conch_tpu_torch.kernels.common import sm_count

    q_lens, lens, rows = VARLEN_OPTION_QLENS, VARLEN_OPTION_LENS, VARLEN_OPTION_ROWS
    total = sum(q_lens)
    num_pages = sum(-(-n // PS) for n in lens) + 2
    poison_page = num_pages - 1
    bt = paged_layout(rng, lens, num_pages - 1, share=(3, 4), shared_pages=8, max_pages=64)
    bt[bt == 0] = poison_page  # padding entries (page 0 is never drawn by paged_layout)
    bt_t = torch.from_numpy(bt).cuda()
    cu_t = torch.tensor(np.concatenate([[0], np.cumsum(q_lens)]), dtype=torch.int32, device="cuda")
    sl_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    names, errs, tols, same, pad, splits_seen = [], [], [], [], [], set()
    for q_dt, c_dt in PAGED_OPTION_TYPES:
        one_byte = c_dt in (torch.int8, torch.float8_e4m3fn)
        ks, vs = KV_SCALES["int8" if c_dt == torch.int8 else "fp8"] if one_byte else (1.0, 1.0)
        for group in PAGED_OPTION_GROUPS:
            qh = group * PAGED_OPTION_KH
            for d in PAGED_OPTION_HEADS:
                kc, vc = _option_pool(gen, num_pages, d, c_dt)
                q = (6.0 * torch.randn((rows, qh, d), generator=gen, device="cuda")).to(q_dt)
                scale = d**-0.5
                for window in (0, 37, 500):
                    # A sequence's rows see [its first row's window start, seq_len).
                    seen = {int(bt[b, pos // PS]) for b, (ql, n) in enumerate(zip(q_lens, lens))
                            for pos in range(max(n - ql - window + 1, 0) if window else 0, n)}
                    hidden = sorted({int(p) for p in bt.reshape(-1)} - seen)
                    kp, vp = (kc, vc) if c_dt == torch.int8 else (_poisoned(kc, hidden), _poisoned(vc, hidden))
                    for causal in (True, False):
                        plan = varlen_tile_plan(rows, len(lens), bt.shape[1], PS, qh, PAGED_OPTION_KH, d, causal,
                                                window, sm_count(0))
                        splits_seen.add(plan.splits)
                        for softcap in (0.0, 30.0):
                            args = (q, kp, vp, cu_t, sl_t, bt_t, scale, causal, 2, softcap, window, 1.0, ks, vs)
                            out, again = launch(*args), launch(*args)
                            ref = plain(q, kc, vc, cu_t, sl_t, bt_t, scale, causal, 2, softcap, window, 1.0, ks, vs)
                            names.append(f"K7 q {str(q_dt)[6:]} cache {str(c_dt)[6:]} G {group} D {d} "
                                         f"{'causal' if causal else 'non-causal'} ({plan.splits} splits) window "
                                         f"{window} softcap {softcap:g}")
                            diff = (out[:total].float() - ref[:total].float()).abs()
                            errs.append(diff.max())
                            tols.append((diff - 2e-2 - 2e-2 * ref[:total].float().abs()).max())  # <= 0: inside
                            same.append(torch.equal(out, again))
                            pad.append(out[total:].float().abs().max())
                del kc, vc
    err_list, over, same_list, pad_list = (torch.stack(errs).tolist(), torch.stack(tols).tolist(),
                                           torch.tensor(same).tolist(), torch.stack(pad).tolist())
    print(f"K7 varlen_attention options: {len(names)} cases (splits {sorted(splits_seen)}), worst max_abs_err "
          f"{max(err_list):.3e}; {sum(same_list)} bit for bit across two calls", flush=True)
    bad = [(name, e) for name, e, o, z in zip(names, err_list, over, pad_list) if not (o <= 0.0 and z == 0.0)]
    for name, e in bad:
        print(f"{name}: max_abs_err {e:.3e} outside the tolerance, or a padding row not exactly zero", flush=True)
    if bad:
        raise AssertionError(f"{len(bad)} of {len(names)} K7 option cases fail")
    if not all(same_list):
        raise AssertionError(f"{len(same_list) - sum(same_list)} K7 option cases differ between two calls")

    # One call in a CUDA graph, replayed: the same bits as the eager call,
    # and again after cu_seqlens_q and seq_lens changed in place.
    kc, vc = _option_pool(gen, num_pages, D, torch.bfloat16)
    q = torch.randn((rows, 4 * PAGED_OPTION_KH, D), generator=gen, device="cuda").to(torch.bfloat16)
    bt_t = torch.from_numpy(np.where(bt == poison_page, 0, bt)).cuda()
    args = (q, kc, vc, cu_t, sl_t, bt_t, D**-0.5, True, 2, 30.0, 500)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch(*args)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = launch(*args)
    for step, (new_q, new_lens) in enumerate(((q_lens, lens), VARLEN_OPTION_GRAPH)):
        cu_t.copy_(torch.tensor(np.concatenate([[0], np.cumsum(new_q)]), dtype=torch.int32))
        sl_t.copy_(torch.tensor(new_lens, dtype=torch.int32))
        graph.replay()
        eager = launch(*args)
        torch.cuda.synchronize()
        if not torch.equal(captured, eager):
            diff = (captured.float() - eager.float()).abs().max().item()
            raise AssertionError(f"K7 in a CUDA graph: replay {step} differs from the eager call (max {diff})")
    print("K7 varlen_attention in a CUDA graph: two replays (cu_seqlens_q and seq_lens changed in place between "
          "them) bit for bit equal to the eager calls", flush=True)


def quantized_cache_phases(gen, rng, by_name: dict) -> None:
    """The int8 and e4m3 branches of K2, K3, K7 and K11, each against its
    plain version on the card, as detail entries of those kernels' rows:
    K2's store at Llama-3-8B's and Gemma-2-2B's shapes, K3 and K7 at
    Llama's and at Gemma's (softcap 50, with and without the 4096 window),
    K11 at DeepSeek-V2-Lite's decode and 512-row prefill steps."""
    for cache in KV_CACHES:
        found = {
            "reshape_and_cache_stacked": [
                {**kernel_phase_k2(gen, rng, cache=cache), "case": f"{cache} store, Llama KH {KH} D {D}"},
                {**kernel_phase_k2(gen, rng, G_QH, G_KH, G_D, G_LAYERS, cache), "case": f"{cache} store, gemma2"},
            ],
            "paged_attention": [{**kernel_phase_k3(gen, rng, cache), "case": f"{cache} cache, Llama"}],
            "varlen_attention": [{**kernel_phase_k7(gen, rng, cache), "case": f"{cache} cache, Llama"}],
            "mla_attention": kernel_phase_k11(gen, rng, cache)["detail"],
        }
        for name, cases in gemma_attention_phases(gen, rng, cache).items():
            found[name] += cases
        for name, cases in found.items():
            for case in cases:
                kept = {k: v for k, v in case.items() if k not in ("name", "route", "source", "replaces", "detail")}
                by_name[name].setdefault("detail", []).append(kept)
                if name == "reshape_and_cache_stacked" or "Llama" in kept["case"]:  # the others print their own
                    print(f"{name} ({kept['case']}): {kept['ms']:.4f} ms (paced {kept['paced_ms']:.4f}, plain "
                          f"{kept['plain_ms']:.4f}, bound {kept['bound_ms']:.5f} by {kept['bound_by']})", flush=True)
        torch.cuda.empty_cache()


# --- Vision: BEV pool (K13a, K13b), NMS (K13c), voxelization -----------------
# BEVFusion's camera-to-BEV pool on nuScenes (mit-han-lab/bevfusion,
# DepthLSSTransform): 6 cameras, image 256 x 704 at stride 8 (feature map
# 32 x 88), dbound [1, 60, 0.5] (118 depth bins), xbound / ybound [-54, 54,
# 0.3] (a 360 x 360 grid), zbound [-10, 10, 20] (Z = 1), 80 channels,
# batch 1: 1,993,728 frustum points.
BEV_CAMERAS, BEV_FH, BEV_FW, BEV_STRIDE, BEV_C = 6, 32, 88, 8, 80
BEV_DEPTHS = (1.0, 60.0, 0.5)
BEV_XY, BEV_Z = (-54.0, 54.0, 0.3), (-10.0, 10.0, 20.0)
BEV_GRID = (1, 1, 360, 360)  # batch, Z, X, Y
# nuScenes camera yaws (front, front-right, front-left, back, back-left,
# back-right) and horizontal fields of view, degrees.
BEV_YAWS = (0.0, -55.0, 55.0, 180.0, 110.0, -110.0)
BEV_FOVS = (70.0, 70.0, 70.0, 110.0, 70.0, 70.0)
# PointPillars on KITTI (mmdetection3d configs/_base_/models/
# pointpillars_hv_secfpn_kitti.py): a 432 x 496 x 1 grid, 32 points a pillar.
PILLARS = {"min_range": (0.0, -39.68, -3.0), "max_range": (69.12, 39.68, 1.0), "voxel_dim": (0.16, 0.16, 4.0),
           "max_num_points_per_voxel": 32}
PILLAR_POINTS = 120_000  # about one HDL-64E sweep
NMS_BOXES, NMS_IOU = 4096, 0.5  # the JAX package's benchmarks/nms_benchmark.py


def bevfusion_inputs(gen, rng, dtype=torch.float32) -> dict:
    """The pool's inputs at BEVFusion's size, made from the seed on the card:
    each frustum point (camera, depth bin, feature row and column) is cast
    through its camera (a pinhole with the camera's field of view, its yaw
    and mount jittered by the seed) into the ego frame; points outside the
    grid are dropped (BEVFusion's ``kept``); the rest are sorted by cell
    rank and cut into intervals at rank changes, as BEVFusion's quick
    cumsum does. Features are a depth softmax times a context feature, as
    ``DepthLSSTransform`` makes them."""
    dev = "cuda"
    depths = torch.arange(*BEV_DEPTHS, device=dev)
    u = (torch.arange(BEV_FW, device=dev) + 0.5) * BEV_STRIDE
    v = (torch.arange(BEV_FH, device=dev) + 0.5) * BEV_STRIDE
    width, height = BEV_FW * BEV_STRIDE, BEV_FH * BEV_STRIDE
    xs, ys, zs = [], [], []
    for yaw, fov in zip(BEV_YAWS, BEV_FOVS):
        focal = width / 2 / math.tan(math.radians(fov) / 2)
        yaw = math.radians(yaw + rng.normal(0.0, 1.0))
        mount = (1.0 * math.cos(yaw) + rng.normal(0.0, 0.05), 1.0 * math.sin(yaw) + rng.normal(0.0, 0.05),
                 1.6 + rng.normal(0.0, 0.05))
        d = depths[:, None, None]
        left = -(u[None, None, :] - width / 2) / focal * d  # (D, 1, W)
        up = -(v[None, :, None] - height / 2) / focal * d  # (D, H, 1)
        fwd = d.expand(-1, BEV_FH, BEV_FW)
        left, up = left.expand(-1, BEV_FH, -1), up.expand(-1, -1, BEV_FW)
        xs.append(math.cos(yaw) * fwd - math.sin(yaw) * left + mount[0])
        ys.append(math.sin(yaw) * fwd + math.cos(yaw) * left + mount[1])
        zs.append(up + mount[2])
    x, y, z = (torch.stack(a).reshape(-1) for a in (xs, ys, zs))
    gx = torch.floor((x - BEV_XY[0]) / BEV_XY[2]).to(torch.int32)
    gy = torch.floor((y - BEV_XY[0]) / BEV_XY[2]).to(torch.int32)
    gz = torch.floor((z - BEV_Z[0]) / BEV_Z[2]).to(torch.int32)
    kept = (gx >= 0) & (gx < BEV_GRID[2]) & (gy >= 0) & (gy < BEV_GRID[3]) & (gz >= 0) & (gz < BEV_GRID[1])
    geom = torch.stack([gx, gy, gz, torch.zeros_like(gx)], dim=1)
    context = torch.randn((BEV_CAMERAS, 1, BEV_FH, BEV_FW, BEV_C), generator=gen, device=dev)
    depth = torch.softmax(2.0 * torch.randn((BEV_CAMERAS, len(depths), BEV_FH, BEV_FW, 1), generator=gen,
                                            device=dev), dim=1)
    feats = (depth * context).reshape(-1, BEV_C)
    frustum_points = feats.shape[0]
    feats, geom = feats[kept], geom[kept]
    ranks = geom[:, 0].long() * BEV_GRID[3] + geom[:, 1]  # BEVFusion's rank: x, then y (Z = batch = 1)
    order = torch.argsort(ranks, stable=True)
    feats, geom, ranks = feats[order].to(dtype).contiguous(), geom[order].contiguous(), ranks[order]
    starts_mask = torch.ones_like(ranks, dtype=torch.bool)
    starts_mask[1:] = ranks[1:] != ranks[:-1]
    starts = torch.nonzero(starts_mask).squeeze(1).to(torch.int32)
    ends = torch.cat([starts[1:], torch.tensor([ranks.numel()], dtype=torch.int32, device=dev)])
    lengths = ends - starts
    return {"feats": feats, "geom": geom, "starts": starts, "lengths": lengths, "point_cells": ranks,
            "frustum_points": frustum_points, "longest": int(lengths.max())}


def small_bev_cases(rng) -> list[tuple[str, tuple, torch.dtype]]:
    """What the BEVFusion inputs miss, as (name, (feats, geom, starts,
    lengths, grid), dtype) on the card: cells shared by neighbouring
    intervals (scatter-add), cells outside the grid (batch past the end, a
    negative x, y = Y which a flat index would wrap) including one between
    two intervals of one cell, f16, and channel counts that are not a
    multiple of 4."""
    def case(num_intervals, max_len, channels, gx, gy):
        lengths = rng.integers(1, max_len + 1, size=num_intervals)
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        n = int(lengths.sum())
        cells = np.sort(rng.choice(gx * gy, size=num_intervals, replace=False))
        geom = np.zeros((n, 4), dtype=np.int32)
        for s, ln, cell in zip(starts, lengths, cells):
            geom[s : s + ln] = (cell // gy, cell % gy, 0, 0)
        feats = rng.normal(size=(n, channels)).astype(np.float32)
        return feats, geom, starts, lengths, (1, 1, gx, gy)

    feats, geom, starts, lengths, grid = case(700, 9, 24, 32, 32)
    for a, b in ((13, 14), (40, 41), (41, 42)):  # a run of three at 40
        geom[starts[a] : starts[a] + lengths[a]] = geom[starts[b]]
    dup = (feats, geom, starts, lengths, grid)
    feats, geom, starts, lengths, grid = case(60, 6, 16, 8, 8)
    geom[starts[10] : starts[10] + lengths[10]] = geom[starts[9]]  # 9, 10, 12 share a cell; 11 is dropped
    geom[starts[12] : starts[12] + lengths[12]] = geom[starts[9]]
    geom[starts[11] : starts[11] + lengths[11], 3] = 1  # batch past the end
    geom[starts[30] : starts[30] + lengths[30], 0] = -1
    geom[starts[31] : starts[31] + lengths[31], 1] = grid[3]
    geom[starts[-1] : starts[-1] + lengths[-1], 3] = 1
    outside = (feats, geom, starts, lengths, grid)
    cases = [("duplicate cells, C 24", dup, torch.float32), ("cells outside the grid", outside, torch.float32),
             ("f16, C 80", case(40, 9, 80, 16, 16), torch.float16),
             ("C 6", case(40, 9, 6, 16, 16), torch.float32), ("C 5", case(40, 9, 5, 16, 16), torch.float32),
             ("bf16, C 6", case(40, 9, 6, 16, 16), torch.bfloat16)]
    out = []
    for name, (feats, geom, starts, lengths, grid), dtype in cases:
        t = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (feats, geom, starts, lengths)]
        out.append((name, (t[0].to(dtype), t[1], t[2].to(torch.int32), t[3].to(torch.int32), grid), dtype))
    return out


def rounding_step(dtype: torch.dtype) -> float:
    """One rounding step of ``dtype`` relative to |ref|: its machine epsilon;
    f32 is held at the JAX test's 1e-5."""
    return 1e-5 if dtype == torch.float32 else torch.finfo(dtype).eps


def check_bev_forward(name: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    """K13a against its plain version: f32 at 1e-5 + 1e-5 |ref|, bf16 / f16
    at one rounding step times |ref|."""
    tol = rounding_step(ref.dtype)
    if out.dtype != ref.dtype or out.shape != ref.shape:
        raise AssertionError(f"K13a {name}: {out.dtype} {tuple(out.shape)}, expected {ref.dtype} {tuple(ref.shape)}")
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item() if diff.numel() else 0.0
    limit = (1e-5 if ref.dtype == torch.float32 else 0.0) + tol * ref.float().abs()
    print(f"K13a bev_pool_fwd {name}: max_abs_err {err:.3e} (tolerance {tol:.1e} x |ref|"
          f"{' + 1e-5' if ref.dtype == torch.float32 else ''})", flush=True)
    if not bool((diff <= limit).all()):
        raise AssertionError(f"K13a {name}: outside tolerance (max_abs_err {err})")
    return err


def check_equal(name: str, out: torch.Tensor, ref: torch.Tensor) -> None:
    """Bit for bit: same dtype, shape and bytes."""
    same = out.dtype == ref.dtype and out.shape == ref.shape and torch.equal(
        out.reshape(-1).view(torch.uint8), ref.reshape(-1).view(torch.uint8))
    print(f"{name}: {'bit for bit equal' if same else 'DIFFERS'}", flush=True)
    if not same:
        raise AssertionError(f"{name}: differs from its plain version")


def nms_boxes(rng, n: int, ties: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """``n`` boxes of 5 to 50 units across a 1000 x 1000 field, and scores on
    the card; with ``ties``, scores on a 1/64 grid (about 64 boxes a score)."""
    centers = rng.uniform(0, 1000, size=(n, 2))
    sizes = rng.uniform(5, 50, size=(n, 2))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], 1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    if ties:
        scores = np.round(scores * 64) / 64
    return torch.from_numpy(boxes).cuda(), torch.from_numpy(scores.astype(np.float32)).cuda()


def kernel_phases_vision(gen, rng) -> list[dict]:
    """K13a and K13b at BEVFusion's size (f32 and bf16) and on the small
    cases; K13c at 4096 boxes (IoU 0.5, tied scores) and on N = 1, 513,
    identical boxes and ties. Rows: the f32 pool, its backward, NMS at
    4096; ``detail`` the rest."""
    from conch_tpu_torch.kernels.vision.bev_pool import (
        bev_pool_backward_launcher as bwd,
        bev_pool_backward_plain as bwd_plain,
        bev_pool_forward_launcher as fwd,
        bev_pool_plain as fwd_plain,
    )
    from conch_tpu_torch.kernels.vision.nms import nms_keep_mask_launcher as keep_mask, sorted_boxes
    from conch_tpu_torch.kernels.vision.nms import nms_keep_mask_plain as keep_plain

    for name, (feats, geom, starts, lengths, grid), _ in small_bev_cases(rng):
        check_bev_forward(name, fwd(feats, geom, starts, lengths, *grid), fwd_plain(feats, geom, starts, lengths, *grid))
        g = torch.randn((*grid, feats.shape[1]), generator=gen, device="cuda").to(feats.dtype)
        check_equal(f"K13b bev_pool_bwd {name}", bwd(g, geom, starts, lengths, feats.shape[0]),
                    bwd_plain(g, geom, starts, lengths, feats.shape[0]))
    fwd_detail, bwd_detail = [], []
    for dtype in (torch.float32, torch.bfloat16):
        bev = bevfusion_inputs(gen, np.random.default_rng(SEED), dtype)
        feats, geom, starts, lengths = bev["feats"], bev["geom"], bev["starts"], bev["lengths"]
        n, ni, es = feats.shape[0], starts.numel(), feats.element_size()
        label = f"BEVFusion {str(dtype).split('.')[-1]}, {n} of {bev['frustum_points']} points kept, {ni} intervals"
        print(f"{label}, longest {bev['longest']} points", flush=True)
        args = (feats, geom, starts, lengths, *BEV_GRID)
        out = fwd(*args)
        err = check_bev_forward(label, out, fwd_plain(*args))
        grid_rows = math.prod(BEV_GRID)
        lib_out = torch.zeros((grid_rows, BEV_C), dtype=dtype, device="cuda")
        cells = bev["point_cells"]
        b_ms, b_by = bound(n * BEV_C * es + grid_rows * BEV_C * es + ni * 24, n * BEV_C, F32_OPS_PER_S)
        fwd_detail.append({
            "case": label, "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by, "ms": time_ms(lambda: fwd(*args)),
            "paced_ms": paced_ms(lambda: fwd(*args)), "plain_ms": time_ms(lambda: fwd_plain(*args), iters=3, warmup=1),
            "library_ms": time_ms(lambda: lib_out.index_add_(0, cells, feats)),
        })
        grad = torch.randn((*BEV_GRID, BEV_C), generator=gen, device="cuda").to(dtype)
        bargs = (grad, geom, starts, lengths, n)
        check_equal(f"K13b bev_pool_bwd {label}", bwd(*bargs), bwd_plain(*bargs))
        grad_rows = grad.view(-1, BEV_C)
        b_ms, b_by = bound(ni * BEV_C * es + n * BEV_C * es + ni * 24, 0, F32_OPS_PER_S)
        bwd_detail.append({
            "case": label, "max_abs_err": 0.0, "bound_ms": b_ms, "bound_by": b_by, "ms": time_ms(lambda: bwd(*bargs)),
            "paced_ms": paced_ms(lambda: bwd(*bargs)), "plain_ms": time_ms(lambda: bwd_plain(*bargs), iters=3, warmup=1),
            "library_ms": time_ms(lambda: grad_rows.index_select(0, cells)),
        })
        del bev, feats, geom, starts, lengths, out, lib_out, cells, grad, grad_rows, args, bargs
        torch.cuda.empty_cache()

    identical = (torch.tensor([[0.0, 0.0, 10.0, 10.0]] * 5, device="cuda"),
                 torch.tensor([0.1, 0.9, 0.5, 0.3, 0.7], device="cuda"))
    lattice_boxes, lattice_scores = nms_boxes(rng, 200, ties=True)
    lattice_boxes = torch.round(lattice_boxes / 25.0) * 25.0  # touching boxes, IoU exactly 1/3, 1/2, 0
    nms_cases = [("N 1", nms_boxes(rng, 1)), ("N 513", nms_boxes(rng, 513)), ("identical boxes", identical),
                 ("lattice, tied scores", (lattice_boxes, lattice_scores))]
    for name, (boxes, scores) in nms_cases:
        for t in (0.3, 0.5, 0.7):
            _, parts = sorted_boxes(boxes, scores)
            check_equal(f"K13c nms {name} IoU {t}", keep_mask(*parts, t), keep_plain(*parts, t))
    boxes, scores = nms_boxes(rng, NMS_BOXES, ties=True)
    _, parts = sorted_boxes(boxes, scores)
    kept = keep_mask(*parts, NMS_IOU)
    check_equal(f"K13c nms {NMS_BOXES} boxes IoU {NMS_IOU} (tied scores; {int(kept.sum())} kept)", kept,
                keep_plain(*parts, NMS_IOU))
    pairs = NMS_BOXES * (NMS_BOXES - 1) / 2
    b_ms, b_by = bound(5 * 4 * NMS_BOXES + NMS_BOXES, 20 * pairs, F32_OPS_PER_S)
    nms_timed = {
        "max_abs_err": 0.0, "bound_ms": b_ms, "bound_by": b_by, "ms": time_ms(lambda: keep_mask(*parts, NMS_IOU)),
        "paced_ms": paced_ms(lambda: keep_mask(*parts, NMS_IOU)),
        "plain_ms": time_ms(lambda: keep_plain(*parts, NMS_IOU), iters=1, warmup=0), "library_ms": None,
    }
    rows = []
    for name, source, replaces, detail in (
        ("bev_pool_fwd", "conch_tpu_torch/csrc/bev_pool.cu",
         "conch_tpu/kernels/vision/bev_pool.py:99; conch_tpu/kernels/vision/bev_pool.py:169", fwd_detail),
        ("bev_pool_bwd", "conch_tpu_torch/csrc/bev_pool.cu",
         "conch_tpu/kernels/vision/bev_pool.py:256; conch_tpu/kernels/vision/bev_pool.py:286", bwd_detail),
        ("nms", "conch_tpu_torch/csrc/nms.cu", "conch_tpu/kernels/vision/nms.py:43", [nms_timed]),
    ):
        for d in detail:
            print(f"{name} ({d.get('case', f'{NMS_BOXES} boxes')}): {d['ms']:.4f} ms (paced {d['paced_ms']:.4f}, plain "
                  f"{d['plain_ms']:.4f}, library {d['library_ms']}, bound {d['bound_ms']:.5f} by {d['bound_by']})",
                  flush=True)
        row = _kernel_row(name, source, replaces, max(d["max_abs_err"] for d in detail), detail[0],
                          detail[0]["bound_ms"], detail[0]["bound_by"])
        row["detail"] = detail
        rows.append(row)
    torch.cuda.empty_cache()
    return rows


def pillars_cloud(rng) -> np.ndarray:
    """A KITTI-like sweep at PointPillars' range: points thin out with
    distance from the sensor (about 10% land outside the range), and 3% sit
    on voxel boundaries (x, y = min + k * 0.16 in f32, or one ulp off),
    where a multiplication by the reciprocal and a true division part."""
    n = PILLAR_POINTS
    r = 2.0 + 78.0 * rng.random(n) ** 1.5
    phi = rng.uniform(-math.pi / 2.2, math.pi / 2.2, n)
    pts = np.stack([r * np.cos(phi), r * np.sin(phi), rng.uniform(-3.3, 1.2, n), rng.random(n)], 1).astype(np.float32)
    edge = rng.choice(n, n * 3 // 100, replace=False)
    lo, vd = np.float32(PILLARS["min_range"][1]), np.float32(0.16)
    k = rng.integers(0, 432, edge.size).astype(np.float32)
    pts[edge, 0] = k * vd
    pts[edge, 1] = lo + rng.integers(0, 496, edge.size).astype(np.float32) * vd
    ulp = rng.integers(-1, 2, (edge.size, 2))
    for axis in (0, 1):
        step = np.where(ulp[:, axis] > 0, np.float32(np.inf), np.float32(-np.inf))
        moved = ulp[:, axis] != 0
        pts[edge[moved], axis] = np.nextafter(pts[edge[moved], axis], step[moved])
    return pts


def check_voxelization(rng) -> dict:
    """``generate_voxels``, and ``voxelization_stable`` with
    ``collect_point_features``, at PointPillars' KITTI size on the card and on
    the CPU from the same points: every output equal, element for element.
    Plain torch (no kernel), so this is where a division done another way
    on the card would show."""
    from conch_tpu_torch.ops.vision import (
        VoxelizationParameter, collect_point_features, generate_voxels, voxelization_stable,
    )

    param = VoxelizationParameter(**PILLARS)
    pts = torch.from_numpy(pillars_cloud(rng))

    def run(points):
        gen_out = generate_voxels(points, param)
        stable = voxelization_stable(points, param)
        return (*gen_out, *stable, *collect_point_features(points, stable[0], stable[1], param))

    card = run(pts.cuda())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(pts.cuda())
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = run(pts)
    names = ("num_filled", "point_features", "voxel_indices", "num_points_per_voxel", "stable counts",
             "point_indices", "flat_voxel_indices", "stable num_filled", "collected features", "capped counts")
    for name, a, b in zip(names, card, cpu, strict=True):
        check_equal(f"voxelization {name} card vs CPU {tuple(b.shape)}", a.cpu(), b)
    filled, stable_filled = int(cpu[0]), int(cpu[7])
    print(f"voxelization: {PILLAR_POINTS} points, generate_voxels {filled} voxels, voxelization_stable "
          f"{stable_filled} voxels; both on the card in {card_s * 1e3:.1f} ms (host clock, one call each)", flush=True)
    return {"generate_voxels": filled, "voxelization_stable": stable_filled}


def vision_path(card: str) -> dict:
    """The public vision ops in a perception stack's order, at full size:
    voxelize a PointPillars sweep, pool BEVFusion's camera features onto the
    BEV grid and back-propagate a loss through the pool
    (``loss.backward()``), then NMS over 4096 boxes. Counts set to 0 just
    before, read just after; checks: finite outputs of the expected shapes,
    the gradient equal bit for bit to the plain backward of the loss's
    gradient, the kept boxes equal to the plain keep mask's. Then a profiled
    repeat (after the counts are read)."""
    from conch_tpu_torch.kernels.vision.bev_pool import bev_pool_backward_plain
    from conch_tpu_torch.kernels.vision.nms import nms_keep_mask_plain, sorted_boxes
    from conch_tpu_torch.ops.vision import VoxelizationParameter, bev_pool, generate_voxels, nms

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rng = np.random.default_rng(SEED + 1)
    param = VoxelizationParameter(**PILLARS)
    points = torch.from_numpy(pillars_cloud(rng)).cuda()
    bev = bevfusion_inputs(gen, rng)
    feats = bev["feats"].requires_grad_(True)
    boxes, scores = nms_boxes(rng, NMS_BOXES, ties=True)

    def run():
        feats.grad = None
        num_filled, voxel_feats, _, _ = generate_voxels(points, param)
        pooled = bev_pool(feats, bev["geom"], bev["starts"], bev["lengths"], *BEV_GRID)
        loss = (pooled**2).sum()
        loss.backward()
        return num_filled, voxel_feats, pooled, loss, nms(boxes, scores, NMS_IOU)

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    num_filled, voxel_feats, pooled, loss, keep = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launch_counts()
    if pooled.shape != (*BEV_GRID, BEV_C) or not bool(torch.isfinite(pooled).all()) or not math.isfinite(loss.item()):
        raise AssertionError(f"vision path: pooled {tuple(pooled.shape)}, not finite or not of the grid's shape")
    if voxel_feats.shape != (param.max_num_voxels, 32, 4) or int(num_filled) <= 0:
        raise AssertionError("vision path: voxelization gave no voxels")
    check_equal("vision path: feats.grad vs the plain backward of 2 * pooled", feats.grad,
                bev_pool_backward_plain(2 * pooled.detach(), bev["geom"], bev["starts"], bev["lengths"],
                                        feats.shape[0]))
    order, parts = sorted_boxes(boxes, scores)
    check_equal("vision path: nms vs the plain keep mask", keep,
                order[nms_keep_mask_plain(*parts, NMS_IOU)].to(torch.int32))
    print(f"vision_bevfusion: voxelized {PILLAR_POINTS} points ({int(num_filled)} pillars), pooled "
          f"{feats.shape[0]} points onto {BEV_GRID} x {BEV_C} and back, kept {keep.numel()} of {NMS_BOXES} boxes in "
          f"{seconds * 1e3:.1f} ms on {card} (host clock, first call); launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    for name in VISION_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the vision path")
    profile_run(run, "vision_bevfusion")
    del bev, feats, pooled, loss, points, voxel_feats
    gc.collect()
    torch.cuda.empty_cache()
    return launches


VISION_KERNELS = ("bev_pool_fwd", "bev_pool_bwd", "nms")

# Llama-3-8B's seven projections of a layer as torch.nn.Linear stores them,
# (out_features, in_features): q, k, v, o, gate, up, down; then lm_head.
LLAMA_LINEARS = ((4096, 4096), (1024, 4096), (1024, 4096), (4096, 4096), (14336, 4096), (14336, 4096), (4096, 14336))
LLAMA_LM_HEAD = (128256, 4096)
QLORA_LAUNCHES = 7 * 32 + 1


def qlora_path(card: str) -> dict:
    """QLoRA's storage of Llama-3-8B, through the public ops: every
    projection of the 32 layers and the lm_head (bf16 random weights from a
    seeded generator, made one layer at a time) to ``quantize_4bit(nf4,
    blocksize 64, compress_statistics=True)`` (K12q, then the 8-bit dynamic
    code of the absmax in plain torch) and back with ``dequantize_4bit``
    (the absmax recovered in f32, then K12d). Counts set to 0 just before,
    read just after: K12q and K12d 225 launches each. Check on every
    weight: the decode is finite bf16 of the weight's size, and each
    ``|w - deq|`` is at most NF4's largest half-gap times the block's
    absmax, plus the double quantization's error of that absmax, plus a
    bf16 rounding (2^-8 of the absmax). Then a profiled repeat of one layer."""
    from conch_tpu_torch.kernels.quantization.bitsandbytes.blockwise import NF4_CODE
    from conch_tpu_torch.ops.quantization.bitsandbytes import dequantize_4bit, dequantize_blockwise, quantize_4bit

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    half_gap = max((b - a) / 2 for a, b in zip(NF4_CODE, NF4_CODE[1:]))
    worst = {"err_over_absmax": 0.0, "absmax_err": 0.0}
    codec_s = 0.0

    def roundtrip(w: torch.Tensor):
        packed, state = quantize_4bit(w, blocksize=NF4_BLOCK, compress_statistics=True, quant_type="nf4")
        return state, dequantize_4bit(packed, state)

    def check_weight(w: torch.Tensor, state, deq: torch.Tensor) -> None:
        if deq.dtype != torch.bfloat16 or deq.shape != (w.numel(),) or not bool(torch.isfinite(deq).all()):
            raise AssertionError(f"QLoRA round trip of {tuple(w.shape)}: {deq.dtype} {tuple(deq.shape)} or not finite")
        blocks = w.float().view(-1, NF4_BLOCK)
        absmax = blocks.abs().amax(dim=1)
        recovered = dequantize_blockwise(state.absmax, quant_state=state.state2) + state.offset
        absmax_err = (recovered - absmax).abs()
        err = (deq.float().view(-1, NF4_BLOCK) - blocks).abs()
        limit = (half_gap + 2**-8) * absmax + absmax_err
        if not bool((err <= limit[:, None] + 1e-12).all()):
            raise AssertionError(f"QLoRA round trip of {tuple(w.shape)}: an error above NF4's half-gap bound")
        worst["err_over_absmax"] = max(worst["err_over_absmax"], (err.amax(dim=1) / absmax).max().item())
        worst["absmax_err"] = max(worst["absmax_err"], (absmax_err / absmax).max().item())

    def make(shape: tuple[int, int]) -> torch.Tensor:
        return (0.02 * torch.randn(shape, generator=gen, device="cuda")).to(torch.bfloat16)

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    values = 0
    for layer in range(NUM_LAYERS_POOL + 1):
        weights = [make(shape) for shape in LLAMA_LINEARS] if layer < NUM_LAYERS_POOL else [make(LLAMA_LM_HEAD)]
        for w in weights:
            values += w.numel()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, deq = roundtrip(w)
            torch.cuda.synchronize()
            codec_s += time.perf_counter() - t1
            check_weight(w, state, deq)
            del state, deq
        last = weights if layer < NUM_LAYERS_POOL else last
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launch_counts()
    print(f"llama3_8b_qlora: {QLORA_LAUNCHES} weights (32 layers x 7 projections + lm_head, {values} values) to "
          f"nf4 with double quantization and back in {seconds:.3f} s on {card} (host clock, weights made and "
          f"checked in it; the codec calls alone {codec_s:.3f} s); largest |w - deq| / absmax "
          f"{worst['err_over_absmax']:.5f} (NF4 half-gap {half_gap:.5f}), largest absmax error of the double "
          f"quantization {worst['absmax_err']:.2e} of the absmax; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    for name in ("quantize4", "dequantize4"):
        if launches[name] != QLORA_LAUNCHES:
            raise AssertionError(f"{name}: {launches[name]} launches on the QLoRA path, expected {QLORA_LAUNCHES}")
    profile_run(lambda: [roundtrip(w) for w in last], "llama3_8b_qlora (one layer)")
    del last, weights
    torch.cuda.empty_cache()
    return launches


STREAM_ROWS = 2048  # a prefill chunk of tokens


def residual_stream_path(card: str) -> dict:
    """K4b through its public op, as a decoder stack calls it: Llama-3-8B's
    residual stream (bf16, hidden 4096) at a 2048-token chunk, each of the
    32 layers' two norms adding the sublayer's new output to the residual
    and normalizing the sum, ``h, residual = fused_add_rms_norm(out,
    residual, w, eps)``. The sublayers' outputs and the norm weights are
    random (seeded). Counts set to 0 just before, read just after: 64
    launches. Check: the final residual bit for bit and the final output at
    NORM_TOLERANCES against the plain op chained on the same inputs."""
    from conch_tpu_torch.kernels.normalization.rms_norm import fused_add_rms_norm_plain
    from conch_tpu_torch.ops.normalization import fused_add_rms_norm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    eps = 1e-5
    sublayers = 2 * NUM_LAYERS_POOL
    outs = [torch.randn((STREAM_ROWS, HIDDEN), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(sublayers)]
    norms = [(1.0 + 0.1 * torch.randn((HIDDEN,), generator=gen, device="cuda")).to(torch.bfloat16)
             for _ in range(sublayers)]
    start = torch.randn((STREAM_ROWS, HIDDEN), generator=gen, device="cuda").to(torch.bfloat16)

    def run(op):
        h, residual = None, start
        for out, w in zip(outs, norms):
            h, residual = op(out, residual, w, eps)
        return h, residual

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    h, residual = run(fused_add_rms_norm)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launch_counts()
    ref_h, ref_residual = run(fused_add_rms_norm_plain)
    check_equal("residual stream: the final residual", residual, ref_residual)
    check_close("residual stream: the final normalized output", h, ref_h, NORM_TOLERANCES[torch.bfloat16])
    print(f"llama3_8b_residual_stream: {sublayers} fused_add_rms_norm calls at {STREAM_ROWS} x {HIDDEN} bf16 in "
          f"{seconds * 1e3:.2f} ms on {card} (host clock, first call); launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    if launches["fused_add_rms_norm"] != sublayers:
        raise AssertionError(f"fused_add_rms_norm: {launches['fused_add_rms_norm']} launches, expected {sublayers}")
    del outs, norms, start, h, residual, ref_h, ref_residual
    torch.cuda.empty_cache()
    return launches


def gemm_output_types(gen, by_name: dict) -> None:
    """``mixed_precision_gemm(..., output_dtype=torch.float32)`` from bf16
    activations through K1 (int4 magic, group 128), K1b (int8 planar) and
    K1c (NF4 rows) at Llama-3-8B's wo (K = N = 4096), M = 8 and 512, layer
    17 of a 32-layer stack: the f32 store against the plain version at the
    kernels' tolerance (1e-2 x max |ref|), timed beside the bf16 store
    (``out_f32`` in each row). A float16 output must raise on the card; a
    bfloat16 acc_dtype is recorded only (JAX's kernels never read it), so
    its call must equal the float32 acc_dtype call bit for bit."""
    from conch_tpu_torch.kernels.quantization.bitsandbytes.blockwise import NF4_CODE
    from conch_tpu_torch.kernels.quantization.gemm import (
        mixed_gemm_magic_plain,
        mixed_gemm_planar_plain,
        mixed_gemm_rows_plain,
    )
    from conch_tpu_torch.ops.quantization import mixed_precision_gemm

    k = n = HIDDEN

    def stack(words_per_k: int, groups: int, scale_dtype) -> tuple[torch.Tensor, torch.Tensor]:
        packed = torch.randint(-(2**31), 2**31 - 1, (NUM_LAYERS_POOL, k // words_per_k, n), generator=gen,
                               device="cuda", dtype=torch.int32)
        scales = (torch.rand((NUM_LAYERS_POOL, k // groups, n), generator=gen, device="cuda") * 4e-3 + 1e-4)
        return packed, scales.to(scale_dtype)

    cases = {
        "mixed_gemm_magic": (*stack(8, GROUP, torch.bfloat16), (4, 8, GROUP), {"layout": "magic"},
                             mixed_gemm_magic_plain, lambda p, s: (p, s, GROUP, 8)),
        "mixed_gemm_planar": (*stack(4, GROUP, torch.bfloat16), (8, 128, GROUP), {"layout": "planar"},
                              mixed_gemm_planar_plain, lambda p, s: (p, s, None, 8, 128, GROUP)),
        "mixed_gemm_rows": (*stack(8, NF4_BLOCK, torch.float32), (4, 0, NF4_BLOCK),
                            {"layout": "gptq", "codebook": NF4_CODE},
                            mixed_gemm_rows_plain, lambda p, s: (p, s, None, 4, 0, NF4_BLOCK, NF4_CODE)),
    }
    for name, (packed, scales, (bits, bias, group), kw, plain, plain_args) in cases.items():
        by_name[name]["out_f32"] = []
        for m in (8, 512):
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)

            def op(out_dtype, layer=LAYER):
                return mixed_precision_gemm(x, packed, scales, None, bits, bias, group, output_dtype=out_dtype,
                                            layer_index=layer, **kw)

            out = op(torch.float32)
            ref = plain(x, *plain_args(packed, scales), LAYER, torch.float32)
            torch.cuda.synchronize()
            if out.dtype != torch.float32 or ref.dtype != torch.float32:
                raise AssertionError(f"{name}: output_dtype float32 gave {out.dtype} (plain {ref.dtype})")
            scale = ref.abs().max().item()
            e = (out - ref).abs().max().item()
            check(f"{name} f32 store M={m} K={k} N={n} (max|ref| {scale:.3f})", e, 1e-2 * scale)
            layers = _stack_cycle()
            case = {"m": m, "k": k, "n": n, "max_abs_err": e,
                    "ms": time_ms(lambda: op(torch.float32, next(layers))),
                    "bf16_store_ms": time_ms(lambda: op(torch.bfloat16, next(layers)))}
            by_name[name]["out_f32"].append(case)
            print(f"{name} M={m}: f32 store {case['ms']:.4f} ms, bf16 store {case['bf16_store_ms']:.4f} ms", flush=True)
        try:
            mixed_precision_gemm(x, packed, scales, None, bits, bias, group, layer_index=LAYER, output_dtype=torch.float16,
                                 **kw)
        except NotImplementedError as exc:
            if "float16" not in str(exc):
                raise AssertionError(f"{name} output_dtype float16: the error does not name float16: {exc}") from exc
        else:
            raise AssertionError(f"{name} output_dtype float16: no error on the card")
        acc = {dt: mixed_precision_gemm(x, packed, scales, None, bits, bias, group, layer_index=LAYER, acc_dtype=dt,
                                        **kw) for dt in (torch.bfloat16, torch.float32)}
        if not torch.equal(acc[torch.bfloat16], acc[torch.float32]):
            raise AssertionError(f"{name}: acc_dtype bfloat16 differs from acc_dtype float32 on the card")
        print(f"{name} M={x.shape[0]}: acc_dtype bfloat16 equal to acc_dtype float32 bit for bit", flush=True)
        del packed, scales
    torch.cuda.empty_cache()


TP = 8  # Llama-3-8B's tensor-parallel degree on an 8-card host
RING_SIZES = (1, 2, 4, 8)
# (rows, cols) of one rank's shard: a 512-row prefill chunk over 8 ranks at
# Llama-3-8B's width, and rows 1 x cols 4097, whose bytes are no multiple of
# 16 (bf16 8194, f32 16388, int8 4097: 2-, 4- and 1-byte copies).
RING_SHAPES = ((512 // TP, HIDDEN), (1, HIDDEN + 1))
RING_LONG = (2048, HIDDEN)  # long context: 128 MiB out per rank in bf16, 1 GiB over the ring
RING_SKEW_CYCLES = 200_000  # about 0.1 ms of torch.cuda._sleep ahead of a late rank


def ring_shards(gen, n: int, shape: tuple[int, int], dtype: torch.dtype) -> list[torch.Tensor]:
    """n random shards, each in a buffer of its own on the card."""
    if dtype == torch.int8:
        return [torch.randint(-128, 128, shape, generator=gen, device="cuda", dtype=torch.int8) for _ in range(n)]
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(n)]


def check_ring(name: str, out: list[torch.Tensor], shards: list[torch.Tensor], quiet: bool = False) -> None:
    """Every rank's K14 result bit for bit equal to its plain version."""
    from conch_tpu_torch.kernels.collectives.ring_all_gather import ring_all_gather_plain

    ref = ring_all_gather_plain(shards)
    same = len(out) == len(ref) and all(
        o.dtype == r.dtype and o.shape == r.shape
        and torch.equal(o.reshape(-1).view(torch.uint8), r.reshape(-1).view(torch.uint8))
        for o, r in zip(out, ref)
    )
    if not quiet or not same:
        print(f"{name}: {'every rank bit for bit equal' if same else 'DIFFERS'}", flush=True)
    if not same:
        raise AssertionError(f"{name}: differs from its plain version")


def check_ring_error(phase: str) -> None:
    """Fail loudly if a K14 wait timed out in ``phase``."""
    from conch_tpu_torch.kernels.collectives.ring_all_gather import decode_ring_error, ring_error

    code = ring_error()
    print(f"K14 error word after {phase}: {code:#x} ({decode_ring_error(code)})", flush=True)
    if code:
        raise AssertionError(f"K14 {phase}: {decode_ring_error(code)}")


def kernel_phase_k14(gen) -> dict:
    """K14 on rings of 1, 2, 4 and 8 virtual ranks on the card, every result
    bit for bit against the plain version: both launch modes (one
    cooperative launch; one launch per rank on its own stream), f32, bf16
    and int8, the TP-8 shard (several blocks a rank) and a 1 x 4097 one (one
    block a rank); 100 back-to-back calls on one flag buffer, modes
    alternating, each checked; per-rank launches with ``torch.cuda._sleep``
    queued ahead of some ranks' streams so they enter late; a deliberate
    timeout (a rank more than the 2 s timeout late) that must set the error
    word and make ``check_ring_error`` raise, then a clean call. The error
    word is read after every phase. Timed at the TP-8 shard (64 x 4096
    bf16, 8 ranks: 4 MiB out per rank) and the long-context one (2048 x
    4096), beside the plain version and n ``torch.cat`` calls; bound =
    (n^2 + n) shard bytes / 3.35 TB/s: each input read once, each output
    written once, on the one HBM all ranks share."""
    from conch_tpu_torch.kernels.collectives.ring_all_gather import (
        TIMEOUT_S,
        check_ring_error as raise_on_ring_error,
        ring_all_gather_launcher as launch,
        ring_all_gather_plain as plain,
        ring_error,
    )

    streams = [torch.cuda.Stream() for _ in range(max(RING_SIZES))]
    calls = 0
    for n in RING_SIZES:
        for shape in RING_SHAPES:
            for dtype in (torch.float32, torch.bfloat16, torch.int8):
                shards = ring_shards(gen, n, shape, dtype)
                for per_rank in (False, True):
                    out = launch(shards, rank_streams=streams[:n] if per_rank else None)
                    mode = "per-rank" if per_rank else "cooperative"
                    check_ring(f"K14 n={n} {shape} {dtype} {mode}", out, shards, quiet=True)
                    calls += 1
    torch.cuda.synchronize()
    print(f"K14: {calls} calls on rings of {RING_SIZES} ranks, both modes, every rank bit for bit equal", flush=True)
    check_ring_error("the mode, size and dtype cases")

    # 100 back-to-back calls on one flag buffer (n = 8, the TP-8 shard), the
    # modes alternating, the inputs rotated so every call's result differs.
    base = ring_shards(gen, TP, RING_SHAPES[0], torch.bfloat16)
    runs = []
    for c in range(100):
        shards = base[c % TP:] + base[: c % TP]
        runs.append((shards, launch(shards, rank_streams=streams[:TP] if c % 2 else None)))
    torch.cuda.synchronize()
    for c, (shards, out) in enumerate(runs):
        check_ring(f"K14 back-to-back call {c}", out, shards, quiet=True)
    print("K14: 100 back-to-back calls on one flag buffer, every rank of every call bit for bit equal", flush=True)
    del runs
    check_ring_error("the back-to-back calls")

    # Skewed entry: sleeps queued ahead of some ranks' streams.
    for n in (2, 4, 8):
        shards = ring_shards(gen, n, RING_SHAPES[0], torch.bfloat16)
        for pattern, late in (("odd ranks", range(1, n, 2)), ("rank 0", (0,)), ("all but the last", range(n - 1))):
            for r in late:
                with torch.cuda.stream(streams[r]):
                    torch.cuda._sleep(RING_SKEW_CYCLES * (1 + r % 3))
            out = launch(shards, rank_streams=streams[:n])
            check_ring(f"K14 n={n} per-rank, {pattern} late", out, shards)
    torch.cuda.synchronize()
    check_ring_error("the skewed per-rank launches")

    # A timeout must become an error word and an exception, never a hang;
    # the ring works after it. Rank 1 enters half a second after rank 0's
    # wait has run out, then times out itself waiting for rank 0's step.
    shards = ring_shards(gen, 2, RING_SHAPES[1], torch.float32)
    with torch.cuda.stream(streams[1]):
        torch.cuda._sleep(int((TIMEOUT_S + 0.5) * SM_CYCLES_PER_S))
    launch(shards, rank_streams=streams[:2])
    torch.cuda.synchronize()
    code = ring_error()
    print(f"K14 deliberate timeout: error word {code:#x}", flush=True)
    try:
        raise_on_ring_error()
    except RuntimeError as e:
        print(f"K14 deliberate timeout raised: {e}", flush=True)
    else:
        raise AssertionError(f"K14: a rank {TIMEOUT_S + 0.5} s late under a {TIMEOUT_S} s timeout did not raise")
    check_ring("K14 after the deliberate timeout", launch(shards, rank_streams=streams[:2]), shards)
    torch.cuda.synchronize()
    check_ring_error("the call after the deliberate timeout")

    def timed(shape: tuple[int, int]) -> dict:
        shards = ring_shards(gen, TP, shape, torch.bfloat16)
        shard_bytes = shards[0].numel() * 2
        b_ms, b_by = bound((TP * TP + TP) * shard_bytes, 0)
        case = {
            "case": f"{TP} ranks x {shape} bf16", "max_abs_err": 0.0, "bound_ms": b_ms, "bound_by": b_by,
            "ms": time_ms(lambda: launch(shards)), "paced_ms": paced_ms(lambda: launch(shards)),
            "per_rank_ms": time_ms(lambda: launch(shards, rank_streams=streams[:TP])),
            "plain_ms": time_ms(lambda: plain(shards)),
            "library_ms": time_ms(lambda: [torch.cat(shards) for _ in range(TP)]),
        }
        print(f"K14 {case['case']}: {case['ms']:.4f} ms (paced {case['paced_ms']:.4f}, per-rank launches "
              f"{case['per_rank_ms']:.4f}, plain {case['plain_ms']:.4f}, "
              f"{TP} torch.cat {case['library_ms']:.4f}, bound {b_ms:.5f} by {b_by}; "
              f"virtual ranks on one card)", flush=True)
        return case

    detail = [timed(RING_SHAPES[0]), timed(RING_LONG)]
    check_ring_error("the timed calls")
    row = _kernel_row("ring_all_gather", "conch_tpu_torch/csrc/ring_all_gather.cu",
                      "conch_tpu/kernels/collectives/ring_all_gather.py:44", 0.0, detail[0], detail[0]["bound_ms"],
                      detail[0]["bound_by"])
    row["detail"] = detail
    torch.cuda.empty_cache()
    return row


def tp8_collectives_path(card: str) -> tuple[dict, list[dict]]:
    """The collectives layer as Llama-3-8B's tensor parallelism at TP 8 calls
    it, on a ring of 8 virtual ranks on the card (``create_mesh(model=8,
    devices=[cuda:0] * 8)``), through ``conch_tpu_torch.parallel``:
    ``ring_all_gather`` of a 512-row prefill chunk (shards 64 x 4096 bf16)
    and of a long-context one (2048 x 4096 shards); in f32 and bf16,
    ``overlapped_allgather_matmul`` (x 512 x 4096 K-sharded to 512 x 512,
    w_local 4096 x 768: the fused wqkv's 6144 columns over 8) and
    ``overlapped_matmul_reduce_scatter`` (x_local 512 x 1792: w_down's 14336
    rows over 8; w_shard 1792 x 4096). Counts set to 0 just before, read
    just after: K14 launches twice. Checks: each gather bit for bit against
    the plain version and the unsharded input; each collective matmul
    against the unsharded product (f32 at 1e-4 + 1e-4 |ref|, bf16 within
    1e-2 x max |ref|). Then each is timed in bf16 beside the unsharded
    product (on virtual ranks: correctness and cost, no overlap)."""
    from conch_tpu_torch.parallel import (
        create_mesh,
        overlapped_allgather_matmul,
        overlapped_matmul_reduce_scatter,
        ring_all_gather,
    )

    if torch.get_float32_matmul_precision() != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("f32 matmuls must run in full f32 (no TF32), as JAX's preferred_element_type=f32")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    ranks = create_mesh(model=TP, devices=[torch.device("cuda", 0)] * TP).axis_devices("model")

    def split(t: torch.Tensor, dim: int) -> list[torch.Tensor]:
        return [c.to(d, copy=True).contiguous() for c, d in zip(t.chunk(TP, dim=dim), ranks)]

    chunk = torch.randn((512, HIDDEN), generator=gen, device="cuda").to(torch.bfloat16)
    long = torch.randn((RING_LONG[0] * TP, HIDDEN), generator=gen, device="cuda").to(torch.bfloat16)
    qkv_cols, down_k = 6144, INTER
    matmuls = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((512, HIDDEN), generator=gen, device="cuda")
        w = torch.randn((HIDDEN, qkv_cols), generator=gen, device="cuda") / math.sqrt(HIDDEN)
        x2 = torch.randn((512, down_k), generator=gen, device="cuda")
        w2 = torch.randn((down_k, HIDDEN), generator=gen, device="cuda") / math.sqrt(down_k)
        x, w, x2, w2 = (t.to(dtype) for t in (x, w, x2, w2))
        matmuls[dtype] = {"ag": (x, w, split(x, 1), split(w, 1)), "rs": (x2, w2, split(x2, 1), split(w2, 0))}
    gathers = {"prefill": split(chunk, 0), "long": split(long, 0)}

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    gathered = {name: ring_all_gather(shards) for name, shards in gathers.items()}
    products = {
        dtype: (overlapped_allgather_matmul(m["ag"][2], m["ag"][3]), overlapped_matmul_reduce_scatter(m["rs"][2], m["rs"][3]))
        for dtype, m in matmuls.items()
    }
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launch_counts()
    check_ring_error("the TP-8 collectives path")
    for name, shards in gathers.items():
        check_ring(f"tp8 ring_all_gather ({name})", gathered[name], shards)
        whole = chunk if name == "prefill" else long
        if not all(torch.equal(g, whole) for g in gathered[name]):
            raise AssertionError(f"tp8 ring_all_gather ({name}): a rank's result is not the unsharded input")
    for dtype, (ag, rs) in products.items():
        for label, outs, (x, w, _, _) in (("allgather_matmul", ag, matmuls[dtype]["ag"]),
                                          ("matmul_reduce_scatter", rs, matmuls[dtype]["rs"])):
            got = torch.cat(outs, dim=1)
            ref = torch.matmul(x.float(), w.float())
            name = f"tp8 overlapped_{label} {dtype}"
            if dtype == torch.float32:
                check_close(name, got, ref, 1e-4)
            else:
                scale = ref.abs().max().item()
                check(f"{name} (max|ref| {scale:.3f})", (got.float() - ref).abs().max().item(), 1e-2 * scale)
    print(f"llama3_8b_tp8_collectives: 2 gathers and 4 collective matmuls on {TP} virtual ranks in "
          f"{seconds * 1e3:.2f} ms on {card} (host clock, first call); launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    if launches["ring_all_gather"] != len(gathers):
        raise AssertionError(f"ring_all_gather: {launches['ring_all_gather']} launches, expected {len(gathers)}")

    # A collective matmul is about 310 eager launches at TP 8 (per hop and
    # rank: two upcasts, a product, an add, a copy). Device times come from
    # two calls, whose launches all fit in CUDA's launch queue behind
    # time_ms's sleep; with more the host blocks on the full queue and the
    # events time its pacing.
    x, w, xs, ws = matmuls[torch.bfloat16]["ag"]
    x2, w2, xs2, ws2 = matmuls[torch.bfloat16]["rs"]
    timings = [
        {"case": "overlapped_allgather_matmul bf16, x 512 x 512 x 8, w_local 4096 x 768",
         "ms": time_ms(lambda: overlapped_allgather_matmul(xs, ws), iters=2),
         "paced_ms": paced_ms(lambda: overlapped_allgather_matmul(xs, ws)),
         "unsharded_ms": time_ms(lambda: torch.matmul(x, w))},
        {"case": "overlapped_matmul_reduce_scatter bf16, x_local 512 x 1792, w_shard 1792 x 4096",
         "ms": time_ms(lambda: overlapped_matmul_reduce_scatter(xs2, ws2), iters=2),
         "paced_ms": paced_ms(lambda: overlapped_matmul_reduce_scatter(xs2, ws2)),
         "unsharded_ms": time_ms(lambda: torch.matmul(x2, w2))},
    ]
    for t in timings:
        print(f"tp8 {t['case']}: {t['ms']:.4f} ms (paced {t['paced_ms']:.4f}), unsharded product "
              f"{t['unsharded_ms']:.4f} ms on {card} (virtual ranks: no overlap)", flush=True)
    del gathers, gathered, products, matmuls, chunk, long
    torch.cuda.empty_cache()
    return launches, timings


def kernel_phases() -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    rows = [
        kernel_phase_k1(gen), kernel_phase_k2(gen, rng), kernel_phase_k3(gen, rng), kernel_phase_k4(gen),
        kernel_phase_k5(gen, rng), kernel_phase_k6(gen), kernel_phase_k7(gen, rng), kernel_phase_k10a(gen),
        kernel_phase_k10b(gen), kernel_phase_k1b(gen), kernel_phase_k1c(gen), kernel_phase_k8(gen),
        kernel_phase_k12q(gen), kernel_phase_k11(gen, rng), kernel_phase_k9(gen), *kernel_phases_vision(gen, rng),
        kernel_phase_k4b(gen), kernel_phase_k12d(gen), kernel_phase_k14(gen),
    ]
    # The Gemma-2-2B shapes of K2, K3, K5 and K7 go into their rows' detail
    # beside the Llama-3-8B numbers the rows keep.
    by_name = {r["name"]: r for r in rows}
    gemma = gemma_attention_phases(gen, rng)
    gemma["reshape_and_cache_stacked"] = [kernel_phase_k2(gen, rng, G_QH, G_KH, G_D, G_LAYERS)]
    gemma["rotary_embedding"] = [kernel_phase_k5(gen, rng, G_QH, G_KH, G_D, 10000.0, K5_TOKENS["gemma"])]
    for name, cases in gemma.items():
        for case in cases:
            kept = {k: v for k, v in case.items() if k not in ("name", "route", "source", "replaces")}
            entry = {"case": f"gemma2 KH {G_KH} D {G_D}", **kept}
            by_name[name].setdefault("detail", []).append(entry)
            if name in ("reshape_and_cache_stacked", "rotary_embedding"):
                print(f"{name} (gemma2 KH {G_KH} D {G_D}): {case['ms']:.4f} ms (paced {case['paced_ms']:.4f}, plain "
                      f"{case['plain_ms']:.4f}, bound {case['bound_ms']:.5f} by {case['bound_by']})", flush=True)
    by_name["paged_attention"]["served"] = kernel_phase_k3_served(gen, rng)
    row_kernel_pairs(gen, rng, by_name)
    check_rope_options(gen, rng)
    check_gemma_rms_norm_options(gen)
    check_attention_scales(gen)
    quantized_cache_phases(gen, rng, by_name)
    gemm_output_types(gen, by_name)
    check_quant_gemm_options(gen)
    check_magic_gemm_options(gen)
    check_paged_attention_options(gen, rng)
    check_varlen_attention_options(gen, rng)
    check_scaled_gemm_options(gen)
    check_mla_attention_options(gen, rng)
    check_quantize4_options(gen)
    for r in rows:
        print(
            f"{r['name']}: {r['ms']:.4f} ms (paced {r['paced_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.5f} ms by "
            f"{r['bound_by']}, library {r['library_ms']})", flush=True,
        )
    torch.cuda.empty_cache()
    return rows


# Each kernel row's launchers: K6's and K10b's kernels have two entry points.
def _launchers() -> dict:
    from conch_tpu_torch.kernels.activation.gelu_tanh_and_mul import (
        gelu_tanh_and_mul_launcher,
        gelu_tanh_and_mul_parts_launcher,
    )
    from conch_tpu_torch.kernels.activation.silu_and_mul import silu_and_mul_launcher, silu_and_mul_parts_launcher
    from conch_tpu_torch.kernels.attention.mla_attention import mla_attention_launcher
    from conch_tpu_torch.kernels.attention.paged_attention import paged_attention_launcher
    from conch_tpu_torch.kernels.attention.varlen_attention import varlen_attention_launcher
    from conch_tpu_torch.kernels.cache.reshape_and_cache import reshape_and_cache_stacked_launcher
    from conch_tpu_torch.kernels.collectives.ring_all_gather import ring_all_gather_launcher
    from conch_tpu_torch.kernels.embedding.rotary_embedding import rotary_embedding_launcher
    from conch_tpu_torch.kernels.normalization.gemma_rms_norm import gemma_rms_norm_launcher
    from conch_tpu_torch.kernels.normalization.rms_norm import fused_add_rms_norm_launcher, rms_norm_launcher
    from conch_tpu_torch.kernels.quantization.bitsandbytes.blockwise import dequantize4_launcher, quantize4_launcher
    from conch_tpu_torch.kernels.quantization.fp8 import static_scaled_fp8_quant_launcher
    from conch_tpu_torch.kernels.quantization.int8 import static_scaled_int8_quant_launcher
    from conch_tpu_torch.kernels.quantization.gemm import (
        mixed_gemm_magic_launcher,
        mixed_gemm_planar_launcher,
        mixed_gemm_rows_launcher,
        scaled_gemm_launcher,
    )
    from conch_tpu_torch.kernels.vision.bev_pool import bev_pool_backward_launcher, bev_pool_forward_launcher
    from conch_tpu_torch.kernels.vision.nms import nms_keep_mask_launcher

    return {
        "mixed_gemm_magic": (mixed_gemm_magic_launcher,),
        "mixed_gemm_planar": (mixed_gemm_planar_launcher,),
        "mixed_gemm_rows": (mixed_gemm_rows_launcher,),
        "scaled_gemm": (scaled_gemm_launcher,),
        "quantize4": (quantize4_launcher,),
        "dequantize4": (dequantize4_launcher,),
        "fused_add_rms_norm": (fused_add_rms_norm_launcher,),
        "reshape_and_cache_stacked": (reshape_and_cache_stacked_launcher,),
        "paged_attention": (paged_attention_launcher,),
        "rms_norm": (rms_norm_launcher,),
        "rotary_embedding": (rotary_embedding_launcher,),
        "silu_and_mul": (silu_and_mul_launcher, silu_and_mul_parts_launcher),
        "varlen_attention": (varlen_attention_launcher,),
        "gemma_rms_norm": (gemma_rms_norm_launcher,),
        "gelu_tanh_and_mul": (gelu_tanh_and_mul_launcher, gelu_tanh_and_mul_parts_launcher),
        "mla_attention": (mla_attention_launcher,),
        "static_scaled_quant": (static_scaled_int8_quant_launcher, static_scaled_fp8_quant_launcher),
        "bev_pool_fwd": (bev_pool_forward_launcher,),
        "bev_pool_bwd": (bev_pool_backward_launcher,),
        "nms": (nms_keep_mask_launcher,),
        "ring_all_gather": (ring_all_gather_launcher,),
    }


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for fns in _launchers().values():
        for fn in fns:
            fn.launches = 0


def read_launch_counts() -> dict:
    """Each kernel row's launches since the last reset."""
    return {name: sum(fn.launches for fn in fns) for name, fns in _launchers().items()}


def to_device(tree, device: str):
    """A copy of a param tree on ``device``."""
    from conch_tpu_torch.models.linear import QuantizedLinear

    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, QuantizedLinear):
        return QuantizedLinear(tree.kind, to_device(tree.arrays, device), dict(tree.meta))
    return tree.to(device)


# Tolerances of the 2-layer prefill check, card (kernels) vs CPU (plain
# versions). f32: the JAX package's f32 attention tolerance (2e-3, atol and
# rtol); the two sides differ only in summation order. bf16: max |diff| <=
# 3e-2 * max |logit|, the bf16 attention tolerance relative to the logits'
# scale. cuBLAS and the CPU round bf16 intermediates differently, and an
# error in the hidden state reaches every logit in proportion to the
# logits' scale (about 6 here), not to each logit's own size.
PREFILL_TOLERANCES = {torch.float32: 2e-3, torch.bfloat16: 3e-2}
# w8a8 rounds every projection's input to whole int8 steps per row, so the
# bf16 rounding differences between card and CPU flip activation codes, and
# the flips spread through the layers. On the CPU (2 layers, hidden 1024;
# python3 -m conch_tpu_torch.tools.w8a8_sensitivity) bf16 against f32
# activations moves the logits by 3.5% of max |logit| in w8a8 against 0.7%
# in int8, and one ulp of noise on the norms moves them by 1.6% in w8a8 and
# by less than 0.01% in int8. Held at 1e-1 x max |ref|: a fault of wiring (a
# wrong layer, scale or row) moves them by about max |ref|.
W8A8_PREFILL_TOLERANCE = 1e-1


def random_norm_weights(params: dict, gen: torch.Generator) -> dict:
    """Gemma params with every norm weight drawn at random (std 0.3), in
    place: the init's zeros make ``(1 + w)`` 1, where a dropped weight
    would pass."""
    for tensor in [params["final_norm"], *(w for n, w in params["layers"].items() if n.endswith("_norm"))]:
        tensor.copy_(0.3 * torch.randn(tensor.shape, generator=gen, device=tensor.device))
    return params


# (weights, activation dtype, KV cache dtype; None: the activation dtype).
# "int4-g64": int4 at group 64.
LLAMA_PREFILL_CASES = (
    ("bf16", torch.float32, None), ("bf16", torch.bfloat16, None), ("int4", torch.bfloat16, None),
    ("int4-g64", torch.bfloat16, None),
    ("int8", torch.bfloat16, None), ("nf4", torch.bfloat16, None), ("w8a8", torch.bfloat16, None),
    ("bf16", torch.bfloat16, torch.int8), ("bf16", torch.bfloat16, torch.float8_e4m3fn),
)
GEMMA_PREFILL_CASES = (
    (torch.float32, None), (torch.bfloat16, None), (torch.bfloat16, torch.int8),
    (torch.bfloat16, torch.float8_e4m3fn),
)


def check_prefill_logits(llama_cases=LLAMA_PREFILL_CASES, gemma_cases=GEMMA_PREFILL_CASES) -> None:
    """First-token logits of a 2-layer, full-width prefill on the card
    (kernels) against the same prefill on the CPU (plain versions), for
    Llama-3-8B (bf16 weights in f32 and in bf16, then int4 (K1), int8 (K1b),
    nf4 (K1c, init through K12q) and w8a8 (K8) weights in bf16, the only
    activation dtype those kernels take on the card; bf16 weights over an
    int8 and an e4m3 KV cache, quantized on store at ``kv_cache_scale``)
    and Gemma-2-2B (bf16 weights in f32 and bf16, and over int8 and e4m3
    caches in bf16, random norm weights, the window cut to 16 so that layer
    0's mask bites in these 24- and 13-token prompts);
    PREFILL_TOLERANCES."""
    import dataclasses

    from conch_tpu_torch.models.gemma import GemmaConfig, gemma_prefill, init_gemma_params
    from conch_tpu_torch.models.llama import (
        LlamaConfig, fuse_llama_params, init_kv_caches, init_llama_params, llama_prefill,
    )

    rng = np.random.default_rng(SEED)
    q_lens, rows, batch, num_pages = [24, 13], 48, 4, 8
    total = sum(q_lens)
    vocab = min(LlamaConfig.llama3_8b().vocab_size, GemmaConfig.gemma2_2b().vocab_size)
    tokens = np.zeros(rows, np.int32)
    tokens[:total] = rng.integers(0, vocab, total)
    positions = np.zeros(rows, np.int32)
    positions[:total] = np.concatenate([np.arange(n) for n in q_lens])
    bt = np.zeros((batch, MAX_PAGES_PER_SEQ), np.int32)
    bt[0, :2], bt[1, :1] = [5, 0], [3]
    slots = np.full(rows, -1, np.int32)
    slots[:total] = [int(bt[b, p // PS]) * PS + p % PS for b, n in enumerate(q_lens) for p in range(n)]
    cu = np.array([0, q_lens[0], total, total, total], np.int32)
    seq_lens = np.array(q_lens + [0, 0], np.int32)
    host = [torch.from_numpy(a) for a in (tokens, positions, cu, seq_lens, bt, slots)]

    def cache_tag(cache):
        return "" if cache is None else f", {str(cache).removeprefix('torch.')} KV cache"

    def llama(quant_mode, dtype, cache):
        cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=2, dtype=dtype)
        mode, _, group = quant_mode.partition("-g")
        return f"Llama-3-8B, {quant_mode} weights{cache_tag(cache)}", cfg, cache, llama_prefill, lambda: (
            fuse_llama_params(init_llama_params(SEED, cfg, quant_mode=mode, group_size=int(group or 128),
                                                device="cuda")))

    def gemma(dtype, cache):
        cfg = dataclasses.replace(GemmaConfig.gemma2_2b(), num_layers=2, sliding_window=16, dtype=dtype)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        return f"Gemma-2-2B, bf16 weights{cache_tag(cache)}", cfg, cache, gemma_prefill, lambda: fuse_llama_params(
            random_norm_weights(init_gemma_params(SEED, cfg, device="cuda"), gen))

    cases = [llama(*case) for case in llama_cases] + [gemma(*case) for case in gemma_cases]
    for label, cfg, cache, prefill, make_params in cases:
        tol = W8A8_PREFILL_TOLERANCE if "w8a8" in label else PREFILL_TOLERANCES[cfg.dtype]
        params = make_params()
        kc, vc = init_kv_caches(cfg, num_pages, PS, cache_dtype=cache, device="cuda")
        t = [a.cuda() for a in host]
        logits, _, _ = prefill(params, cfg, t[0], t[1], t[2], rows, t[3], t[4], t[5], kc, vc)
        logits = logits.cpu()
        cpu_params = to_device(params, "cpu")
        del params, kc, vc
        torch.cuda.empty_cache()
        kc, vc = init_kv_caches(cfg, num_pages, PS, cache_dtype=cache, device="cpu")
        ref, _, _ = prefill(cpu_params, cfg, host[0], host[1], host[2], rows, host[3], host[4], host[5], kc, vc)
        del cpu_params
        if not torch.isfinite(logits).all() or logits.shape != (batch, cfg.vocab_size):
            raise AssertionError(f"prefill logits: shape {tuple(logits.shape)} or non-finite values")
        err = (logits - ref).abs().max().item()
        scale = ref.abs().max().item()
        if cfg.dtype == torch.float32:
            ok = bool(((logits - ref).abs() <= tol + tol * ref.abs()).all())
            rule = f"{tol:.0e} + {tol:.0e} * |ref| elementwise"
        else:
            ok = err <= tol * scale
            rule = f"{tol:.0e} * max|ref| = {tol * scale:.3e}"
        print(f"2-layer prefill logits, {label}, {cfg.dtype}, card vs plain path on the CPU: "
              f"max_abs_err {err:.3e}, max|ref| {scale:.3f}, tolerance {rule}", flush=True)
        if not ok:
            raise AssertionError(f"2-layer prefill logits ({label}, {cfg.dtype}) disagree with the plain path")


# A routing divergence between card and CPU is accepted only at a near
# tie: where the CPU's k-th and (k+1)-th expert probabilities (of 64) lie
# within this gap. Card and CPU round differently (summation order; in
# bf16 the hidden state itself), which moves a probability by about 1e-7
# in f32 and 1e-4 in bf16, against a typical gap of 1e-3.
ROUTING_NEAR_TIE = {torch.float32: 1e-5, torch.bfloat16: 1e-3}


DEEPSEEK_PREFILL_CASES = (
    (torch.float32, None), (torch.bfloat16, None), (torch.bfloat16, torch.int8),
    (torch.bfloat16, torch.float8_e4m3fn),
)


def check_deepseek_logits(cases=DEEPSEEK_PREFILL_CASES) -> None:
    """First-token logits of a 2-layer, full-width DeepSeek-V2-Lite prefill
    (layer 0 dense, layer 1 MoE; bf16 weights, random norm weights) on the
    card (K4, K6, K11) against the same prefill on the CPU (plain
    versions), in f32 and bf16, and in bf16 over int8 and e4m3 latent
    caches, at PREFILL_TOLERANCES; and the MoE layer's routing of every
    real token compared expert set by expert set, a divergence accepted
    only at a near tie (ROUTING_NEAR_TIE)."""
    import dataclasses

    import conch_tpu_torch.models.deepseek as ds

    rng = np.random.default_rng(SEED)
    q_lens, rows, batch, num_pages = [24, 13], 48, 4, 8
    total = sum(q_lens)
    tokens = np.zeros(rows, np.int32)
    tokens[:total] = rng.integers(0, ds.DeepseekV2Config.v2_lite().vocab_size, total)
    positions = np.zeros(rows, np.int32)
    positions[:total] = np.concatenate([np.arange(n) for n in q_lens])
    bt = np.zeros((batch, MAX_PAGES_PER_SEQ), np.int32)
    bt[0, :2], bt[1, :1] = [5, 0], [3]
    slots = np.full(rows, -1, np.int32)
    slots[:total] = [int(bt[b, p // PS]) * PS + p % PS for b, n in enumerate(q_lens) for p in range(n)]
    cu = np.array([0, q_lens[0], total, total, total], np.int32)
    seq_lens = np.array(q_lens + [0, 0], np.int32)
    host = [torch.from_numpy(a) for a in (tokens, positions, cu, seq_lens, bt, slots)]

    routes: list = []
    route = ds.deepseek_route

    def recording_route(hidden, router_w, config, bias=None):
        weights, experts = route(hidden, router_w, config, bias=bias)
        probs = torch.softmax(hidden.float() @ router_w.float(), dim=-1)
        routes.append((experts[:total].cpu(), probs[:total].cpu()))
        return weights, experts

    ds.deepseek_route = recording_route
    try:
        for dtype, cache in cases:
            tag = f"{dtype}" + ("" if cache is None else f", {str(cache).removeprefix('torch.')} latent cache")
            cfg = dataclasses.replace(ds.DeepseekV2Config.v2_lite(), num_layers=2, dtype=dtype)
            params = ds.fuse_deepseek_params(ds.init_deepseek_params(SEED, cfg, device="cuda"))
            gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
            norms = [params["final_norm"]] + [
                w for stack in ("layers_dense", "layers_moe") for n, w in params[stack].items() if n.endswith("_norm")
            ]
            for w in norms:
                w.copy_(1.0 + 0.3 * torch.randn(w.shape, generator=gen, device="cuda"))
            kc = ds.init_deepseek_kv_cache(cfg, num_pages, PS, dtype=cache, device="cuda")
            vc = torch.zeros(0, dtype=dtype, device="cuda")
            t = [a.cuda() for a in host]
            routes.clear()
            logits, _, _ = ds.deepseek_prefill(params, cfg, t[0], t[1], t[2], rows, t[3], t[4], t[5], kc, vc)
            logits = logits.cpu()
            (card_experts, _), = routes
            cpu_params = to_device(params, "cpu")
            del params, kc, vc
            torch.cuda.empty_cache()
            routes.clear()
            kc = ds.init_deepseek_kv_cache(cfg, num_pages, PS, dtype=cache, device="cpu")
            ref, _, _ = ds.deepseek_prefill(
                cpu_params, cfg, host[0], host[1], host[2], rows, host[3], host[4], host[5], kc, torch.zeros(0)
            )
            (cpu_experts, cpu_probs), = routes
            del cpu_params
            if not torch.isfinite(logits).all() or logits.shape != (batch, cfg.vocab_size):
                raise AssertionError(f"DeepSeek prefill logits: shape {tuple(logits.shape)} or non-finite values")
            k = cfg.num_experts_per_tok
            same = (card_experts.sort(dim=-1).values == cpu_experts.sort(dim=-1).values).all(dim=-1)
            ranked = cpu_probs.sort(dim=-1, descending=True).values
            gaps = (ranked[:, k - 1] - ranked[:, k])[~same].tolist()
            print(f"2-layer DeepSeek-V2-Lite prefill, {tag}: MoE routing card vs CPU: {int(same.sum())} of "
                  f"{total} tokens route to the same {k} experts; k-th/(k+1)-th probability gaps at the "
                  f"divergences {gaps} (near tie <= {ROUTING_NEAR_TIE[dtype]:.0e})", flush=True)
            if any(g > ROUTING_NEAR_TIE[dtype] for g in gaps):
                raise AssertionError(f"DeepSeek routing ({tag}) diverges from the CPU away from a near tie")
            tol = PREFILL_TOLERANCES[dtype]
            err = (logits - ref).abs().max().item()
            scale = ref.abs().max().item()
            if dtype == torch.float32:
                ok = bool(((logits - ref).abs() <= tol + tol * ref.abs()).all())
                rule = f"{tol:.0e} + {tol:.0e} * |ref| elementwise"
            else:
                ok = err <= tol * scale
                rule = f"{tol:.0e} * max|ref| = {tol * scale:.3e}"
            print(f"2-layer prefill logits, DeepSeek-V2-Lite, bf16 weights, {tag}, card vs plain path on the CPU: "
                  f"max_abs_err {err:.3e}, max|ref| {scale:.3f}, tolerance {rule}", flush=True)
            if not ok:
                raise AssertionError(f"2-layer DeepSeek prefill logits ({tag}) disagree with the plain path")
    finally:
        ds.deepseek_route = route


def bf16_prompts(rng: np.random.Generator, vocab: int) -> list[list[int]]:
    """4 prompts of 40/128/300/500 tokens; the last two share 64 tokens."""
    prefix = rng.integers(0, vocab, 64).tolist()
    return [
        rng.integers(0, vocab, 40).tolist(),
        rng.integers(0, vocab, 128).tolist(),
        prefix + rng.integers(0, vocab, 236).tolist(),
        prefix + rng.integers(0, vocab, 436).tolist(),
    ]


# The README's serving example: 16 prompts of 40 to 900 tokens, two of
# them sharing a 128-token prefix (a prefix-cache hit).
INT4_PROMPT_LENS = (40, 900, 64, 300, 700, 96, 450, 800, 150, 600, 256, 520, 380, 60)
INT4_SHARED_TAILS = (72, 372)


def int4_prompts(rng: np.random.Generator, vocab: int) -> list[list[int]]:
    prefix = rng.integers(0, vocab, 128).tolist()
    prompts = [rng.integers(0, vocab, n).tolist() for n in INT4_PROMPT_LENS]
    return prompts + [prefix + rng.integers(0, vocab, n).tolist() for n in INT4_SHARED_TAILS]


def quant_prompts(rng: np.random.Generator, vocab: int) -> list[list[int]]:
    """8 prompts of 40 to 900 tokens, for the int8, nf4 and w8a8 runs."""
    return [rng.integers(0, vocab, n).tolist() for n in (40, 900, 64, 300, 700, 96, 450, 800)]


def deepseek_prompts(rng: np.random.Generator, vocab: int) -> list[list[int]]:
    """8 prompts of 40 to 1800 tokens (4450 in all)."""
    return [rng.integers(0, vocab, n).tolist() for n in (40, 900, 64, 300, 1800, 96, 450, 800)]


def gemma_prompts(rng: np.random.Generator, vocab: int) -> list[list[int]]:
    """8 prompts of 40 to 4600 tokens; the longest crosses the 4096 window
    of the local layers, in prefill (K7) and in decode (K3)."""
    return [rng.integers(0, vocab, n).tolist() for n in (40, 64, 128, 300, 600, 900, 2000, 4600)]


ATTENTION = ("varlen_attention", "paged_attention")  # K7 once per layer of a prefill step, K3 of a decode step

# Launches a model step makes, with wqkv and gate|up fused. Llama-3-8B, 32
# layers: K1 4 per layer, K4 2 per layer plus the final norm, K6 1 per
# layer, attention 1 per layer. Gemma-2-2B, 26 layers: K10a 4 per layer
# (input, post-attention, pre- and post-feedforward) plus the final norm,
# K10b 1 per layer, attention 1 per layer.
# int8 and w8a8 also quantize lm_head: K1b and K8 4 per layer plus 1; nf4
# stays unfused and quantizes lm_head: K1c 7 per layer plus 1. K12q runs
# during nf4 init (once per projection and layer, plus lm_head) and never
# while serving.
LLAMA_PER_STEP = {"mixed_gemm_magic": 4 * 32, "rms_norm": 2 * 32 + 1, "silu_and_mul": 32, ATTENTION: 32}
GEMMA_PER_STEP = {"gemma_rms_norm": 4 * 26 + 1, "gelu_tanh_and_mul": 26, ATTENTION: 26}
_LLAMA_REST = {"rms_norm": 2 * 32 + 1, "silu_and_mul": 32, ATTENTION: 32, "mixed_gemm_magic": 0, "quantize4": 0}
INT8_PER_STEP = {"mixed_gemm_planar": 4 * 32 + 1, **_LLAMA_REST}
NF4_PER_STEP = {"mixed_gemm_rows": 7 * 32 + 1, **_LLAMA_REST}
W8A8_PER_STEP = {"scaled_gemm": 4 * 32 + 1, **_LLAMA_REST}
NF4_INIT_LAUNCHES = 7 * 32 + 1
# DeepSeek-V2-Lite, 27 layers (1 dense, 26 MoE): K11 1 per layer, K4 3 per
# layer (input, kv_a and post-attention norms) plus the final norm, K6 1
# per layer (the fused dense gate|up, then the shared experts' gate|up;
# the routed experts' SwiGLU is plain PyTorch, as in the JAX package). The
# latent cache write and the interleaved RoPE are plain PyTorch too, so no
# K2, K3, K5 or K7.
DEEPSEEK_PER_STEP = {
    "mla_attention": 27, "rms_norm": 3 * 27 + 1, "silu_and_mul": 27, ATTENTION: 0, "reshape_and_cache_stacked": 0,
    "rotary_embedding": 0,
}
DEEPSEEK_KERNELS = ("mla_attention", "rms_norm", "silu_and_mul")


def count_steps(engine) -> list[int]:
    """Wrap the engine's model step functions so that each call adds one to
    the returned counters: the model steps of a run (then its prefill and
    its decode steps), counted apart from the kernels' launches."""
    counter = [0, 0, 0]

    def counted(fn, kind):
        def step(*args, **kwargs):
            counter[0] += 1
            counter[kind] += 1
            return fn(*args, **kwargs)

        return step

    engine._prefill_fn, engine._decode_fn = counted(engine._prefill_fn, 1), counted(engine._decode_fn, 2)
    return counter


def serve(
    card: str, label: str, cfg, make_params, model_fns: dict, engine_kwargs: dict, make_prompts,
    expect: tuple[str, ...], per_step: dict, init_launches: dict | None = None,
) -> dict:
    """LLMEngine at full width (random weights from the seed) serving greedy
    requests of 32 tokens through ``model_fns`` (Llama's by default);
    returns each kernel's launch count in that run. Fails unless every
    kernel in ``expect`` launched, and launched ``per_step`` times in each
    model step (attention: K3 and K7 together). ``init_launches``: kernels
    that the params' init must launch, with the count (counted from just
    before the init to the engine's start; returned as those kernels'
    counts). Fails at its start if more than 1 GiB is still allocated: an
    earlier run's model was not freed."""
    from conch_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    if held > 2**30:
        raise AssertionError(f"{held / 2**30:.1f} GiB still allocated before the {label} run: a model was not freed")
    t0 = time.perf_counter()
    reset_launch_counts()
    params = make_params(cfg)
    engine = LLMEngine(params, cfg, EngineConfig(**engine_kwargs), **model_fns)
    del params
    cache_dtype = model_fns.get("cache_dtype", cfg.dtype)
    if engine.k_caches.dtype != cache_dtype:
        raise AssertionError(f"{label}: the engine's cache is {engine.k_caches.dtype}, asked for {cache_dtype}")
    torch.cuda.synchronize()
    at_init = read_launch_counts()
    print(f"{label} engine ready in {time.perf_counter() - t0:.1f} s ({engine.ecfg}), "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated; launches during init: "
          f"{ {k: v for k, v in at_init.items() if v} }", flush=True)
    for name, want in (init_launches or {}).items():
        if at_init[name] != want:
            raise AssertionError(f"{name}: {at_init[name]} launches during the {label} init, expected {want}")
    prompts = make_prompts(np.random.default_rng(SEED), cfg.vocab_size)
    max_tokens = 32
    steps = count_steps(engine)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outputs = engine.generate(prompts, SamplingParams(max_tokens=max_tokens))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launch_counts()
    for out in outputs:
        if len(out) != max_tokens or not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"request finished with {len(out)} tokens, some outside the vocabulary")
    print(f"{label}: served {len(prompts)} requests (prompts {[len(p) for p in prompts]}, {max_tokens} tokens "
          f"each) in {seconds:.3f} s: {len(prompts) * max_tokens / seconds:.2f} generated tok/s on {card}; "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB peak allocated; prefix-cache hits "
          f"{engine.prefix_cache_hits} tokens", flush=True)
    n_steps = steps[0]
    print(f"{label}: launches in the served run ({n_steps} model steps: {steps[1]} prefill, {steps[2]} decode): "
          f"{launches}", flush=True)
    for name in expect:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the {label} path")
    for names, per in per_step.items():
        got = sum(launches[n] for n in ((names,) if isinstance(names, str) else names))
        if got != per * n_steps:
            raise AssertionError(f"{names}: {got} launches on the {label} path, expected {per} x {n_steps} steps")
    print(f"{label}: launches per model step: "
          f"{ {n: launches[n] / n_steps for n in launches if launches[n]} }", flush=True)
    engine_params, ecfg = engine.params, engine.ecfg
    del engine
    torch.cuda.empty_cache()
    profile_served_run(engine_params, cfg, ecfg, model_fns, prompts, max_tokens, label)
    return {**launches, **{name: at_init[name] for name in init_launches or {}}}


def profile_served_run(params: dict, cfg, ecfg, model_fns: dict, prompts: list, max_tokens: int, label: str) -> None:
    """The same requests on a fresh engine under torch.profiler (not the
    timed run): ``profile_run``'s breakdown."""
    from conch_tpu_torch.serving import LLMEngine, SamplingParams

    engine = LLMEngine(params, cfg, ecfg, **model_fns)
    profile_run(lambda: engine.generate(prompts, SamplingParams(max_tokens=max_tokens)), label)


def profile_run(fn, label: str) -> None:
    """``fn()`` under torch.profiler: device time by kernel group, from the
    trace's kernel events, and the device's idle share of the wall time;
    for the kernels of K1 to K11 their events' sum and the part of it after
    the end of the kernel before (a programmatic dependent's event starts
    under its predecessor)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        trace = f"{tmp}/trace.json"
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        print(f"{label} profile: the trace holds no kernel events; device time not measured", flush=True)
        return
    groups: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for e in kernels:
        name = e["name"]
        low = name.lower()
        # cuBLAS names its Hopper matmul kernels nvjet_*, older ones *gemm*.
        matmul = "conch" not in low and any(tag in low for tag in ("nvjet", "gemm", "sm90", "cutlass"))
        group = "conch kernels" if "conch" in low else "matmul" if matmul else "other"
        groups[group] = groups.get(group, 0.0) + e["dur"] / 1e3
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + e["dur"] / 1e3
    busy = sum(groups.values())
    window = (max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)) / 1e3
    print(f"{label} profile ({len(kernels)} kernels): wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, "
          f"idle share of the kernels' window {1 - busy / window:.3f}; "
          + ", ".join(f"{g} {t:.1f} ms" for g, t in sorted(groups.items(), key=lambda x: -x[1])), flush=True)
    top = sorted(by_name.items(), key=lambda x: -x[1])[:8]
    print(f"{label} profile top kernels: " + "; ".join(f"{n} {t:.1f} ms" for n, t in top), flush=True)
    # A programmatic-dependent kernel's event starts under the kernel
    # before it: its time after the latest end of the kernels that started
    # before it is its own.
    own, last_end = {}, float("-inf")
    for e in sorted(kernels, key=lambda e: e["ts"]):
        end = e["ts"] + e["dur"]
        own[id(e)] = max(0.0, end - max(e["ts"], last_end)) / 1e3
        last_end = max(last_end, end)
    # The kernels one K1, K1b, K1c or K8 call may launch (the GEMM, the
    # split reduction, K1b's x row-sum pre-pass), and K3's, K7's and K11's
    # two each (the split walk, the merge).
    for tag, names in (("K1/K1b/K1c/K8", ("qgemm::", "group_row_sums")), ("K3", ("paged_split", "paged_merge")),
                       ("K7", ("varlen_tile", "varlen_merge", "varlen_rows")), ("K11", ("mla_",)),
                       ("K5", ("rope_kernel",)), ("K10a", ("gemma_rms_norm_kernel",))):
        found = {n: t for n, t in by_name.items() if any(key in n for key in names)}
        if found:
            counts = {n: sum(1 for e in kernels if e["name"][:60] == n) for n in found}
            mine = {n: sum(own[id(e)] for e in kernels if e["name"][:60] == n) for n in found}
            print(f"{label} profile {tag} kernels: " + "; ".join(
                f"{n} {t:.1f} ms in {counts[n]} launches ({mine[n]:.1f} ms after the kernel before ended)"
                for n, t in sorted(found.items(), key=lambda x: -x[1])), flush=True)


# K1's, K1b's and K1c's templates in a mangled kernel name: layout, bits (K1: group), flag, rows a block.
QGEMM_TEMPLATE = re.compile(r"quant_gemm_kernel.*?(RowsLayout|PlanarLayout|MagicLayout)ILi(\d+)ELb(\d)EEELi(\d+)E")


def build() -> None:
    """Build the kernels and print ptxas's report: every register and spill
    line and every wgmma serialization warning, then one line per K1b / K1c
    template (layout, bits, its flag, rows a block) with its registers and
    spills."""
    from conch_tpu_torch.kernels.common import BUILD_DIR, kernel_library

    t0 = time.perf_counter()
    kernel_library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    template, spills = None, ""
    for line in (BUILD_DIR / "nvcc.log").read_text().splitlines():
        if "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line) or "Performance Loss" in line:
            print("nvcc:", line.strip())
        if "Compiling entry function" in line:
            match = QGEMM_TEMPLATE.search(line)
            template = None if match is None else "{}<{}, {}> BN {}".format(*match.groups())
        elif template and "spill stores" in line:
            spills = line.strip()
        elif template and "Used" in line and "registers" in line:
            print(f"ptxas {template}: {line.split(':', 1)[1].strip()}; {spills}", flush=True)
            template = None


LLAMA_KERNELS = (
    "mixed_gemm_magic", "reshape_and_cache_stacked", "paged_attention", "rms_norm", "rotary_embedding",
    "silu_and_mul", "varlen_attention",
)
LLAMA_COMMON = tuple(k for k in LLAMA_KERNELS if k != "mixed_gemm_magic")
# The run whose launches a kernel row reports; the others' counts stand
# beside them (``launches_by_path``).
PRIMARY_PATH = {
    "mixed_gemm_magic": "llama3_8b_int4", "rms_norm": "llama3_8b_int4", "silu_and_mul": "llama3_8b_int4",
    "mixed_gemm_planar": "llama3_8b_int8", "mixed_gemm_rows": "llama3_8b_nf4", "quantize4": "llama3_8b_nf4",
    "scaled_gemm": "llama3_8b_w8a8", "mla_attention": "deepseek_v2_lite_bf16",
    "bev_pool_fwd": "vision_bevfusion", "bev_pool_bwd": "vision_bevfusion", "nms": "vision_bevfusion",
    "dequantize4": "llama3_8b_qlora", "fused_add_rms_norm": "llama3_8b_residual_stream",
    "ring_all_gather": "llama3_8b_tp8_collectives",
}
# K9's callers are its public ops: its row's launches are those of its
# kernel phase, and it launches on no served path.
PHASE_PATH_KERNELS = ("static_scaled_quant",)
GEMMA_KERNELS = (
    "reshape_and_cache_stacked", "paged_attention", "rotary_embedding", "varlen_attention", "gemma_rms_norm",
    "gelu_tanh_and_mul",
)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    build()
    rows = kernel_phases()
    check_voxelization(np.random.default_rng(SEED))
    vision_launches = vision_path(card)
    qlora_launches = qlora_path(card)
    stream_launches = residual_stream_path(card)
    tp8_launches, tp8_timings = tp8_collectives_path(card)
    next(r for r in rows if r["name"] == "ring_all_gather")["collective_matmuls"] = tp8_timings
    check_prefill_logits()
    check_deepseek_logits()

    from conch_tpu_torch.models.deepseek import (
        DeepseekV2Config, deepseek_decode_step, deepseek_prefill, init_deepseek_params,
    )
    from conch_tpu_torch.models.gemma import GemmaConfig, gemma_decode_step, gemma_prefill, init_gemma_params
    from conch_tpu_torch.models.llama import LlamaConfig, init_llama_params

    def llama(quant_mode, group_size=128):
        return lambda cfg: init_llama_params(SEED, cfg, quant_mode=quant_mode, group_size=group_size, device="cuda")

    llama_cfg = LlamaConfig.llama3_8b()
    deepseek_fns = {"prefill_fn": deepseek_prefill, "decode_fn": deepseek_decode_step}
    deepseek_engine = {"num_pages": 4096, "max_batch_size": 16, "max_pages_per_seq": 128}
    launches = {
        "llama3_8b_bf16": serve(
            card, "bf16", llama_cfg, llama("bf16"), {},
            {"page_size": 16, "num_pages": 2048, "max_batch_size": 8, "max_prefill_tokens": 128}, bf16_prompts,
            LLAMA_COMMON, {k: v for k, v in LLAMA_PER_STEP.items() if k != "mixed_gemm_magic"},
        ),
        # The README's int4 example.
        "llama3_8b_int4": serve(
            card, "int4", llama_cfg, llama("int4"), {}, {"num_pages": 4096, "max_batch_size": 32}, int4_prompts,
            LLAMA_KERNELS, LLAMA_PER_STEP,
        ),
        # The README's int4 engine with the projections at group 64 (K1's
        # group-64 template), 8 requests.
        "llama3_8b_int4_g64": serve(
            card, "int4-g64", llama_cfg, llama("int4", 64), {}, {"num_pages": 4096, "max_batch_size": 32},
            quant_prompts, LLAMA_KERNELS, LLAMA_PER_STEP,
        ),
        # The other weight formats of the same model (lm_head quantized too).
        "llama3_8b_int8": serve(
            card, "int8", llama_cfg, llama("int8"), {}, {"num_pages": 4096, "max_batch_size": 32}, quant_prompts,
            (*LLAMA_COMMON, "mixed_gemm_planar"), INT8_PER_STEP,
        ),
        "llama3_8b_nf4": serve(
            card, "nf4", llama_cfg, llama("nf4"), {}, {"num_pages": 4096, "max_batch_size": 32}, quant_prompts,
            (*LLAMA_COMMON, "mixed_gemm_rows"), NF4_PER_STEP, {"quantize4": NF4_INIT_LAUNCHES},
        ),
        "llama3_8b_w8a8": serve(
            card, "w8a8", llama_cfg, llama("w8a8"), {}, {"num_pages": 4096, "max_batch_size": 32}, quant_prompts,
            (*LLAMA_COMMON, "scaled_gemm"), W8A8_PER_STEP,
        ),
        # Gemma-2-2B at its published config, 26 layers.
        "gemma2_2b_bf16": serve(
            card, "gemma2-2b", GemmaConfig.gemma2_2b(), lambda cfg: init_gemma_params(SEED, cfg, device="cuda"),
            {"prefill_fn": gemma_prefill, "decode_fn": gemma_decode_step},
            {"num_pages": 4096, "max_batch_size": 16, "max_pages_per_seq": 320}, gemma_prompts, GEMMA_KERNELS,
            GEMMA_PER_STEP,
        ),
        # DeepSeek-V2-Lite at its published config, 27 layers (K11).
        "deepseek_v2_lite_bf16": serve(
            card, "deepseek-v2-lite", DeepseekV2Config.v2_lite(),
            lambda cfg: init_deepseek_params(SEED, cfg, device="cuda"), deepseek_fns,
            deepseek_engine, deepseek_prompts, DEEPSEEK_KERNELS, DEEPSEEK_PER_STEP,
        ),
        # Quantized KV caches (kv_cache_scale 1/16): each run is its bf16-cache
        # twin above with only the cache changed. The README's int4 example
        # over an int8 cache (BASELINE.json, "INT4 weight-only + INT8 KV
        # cache"); bf16 weights over an e4m3 cache (BASELINE.json, "FP8 KV
        # cache"); DeepSeek-V2-Lite over an e4m3 latent cache.
        "llama3_8b_int4_kv_int8": serve(
            card, "int4-kv-int8", llama_cfg, llama("int4"), {"cache_dtype": torch.int8},
            {"num_pages": 4096, "max_batch_size": 32}, int4_prompts, LLAMA_KERNELS, LLAMA_PER_STEP,
        ),
        "llama3_8b_bf16_kv_fp8": serve(
            card, "bf16-kv-fp8", llama_cfg, llama("bf16"), {"cache_dtype": torch.float8_e4m3fn},
            {"page_size": 16, "num_pages": 2048, "max_batch_size": 8, "max_prefill_tokens": 128}, bf16_prompts,
            LLAMA_COMMON, {k: v for k, v in LLAMA_PER_STEP.items() if k != "mixed_gemm_magic"},
        ),
        "deepseek_v2_lite_kv_fp8": serve(
            card, "deepseek-v2-lite-kv-fp8", DeepseekV2Config.v2_lite(),
            lambda cfg: init_deepseek_params(SEED, cfg, device="cuda"),
            {**deepseek_fns, "cache_dtype": torch.float8_e4m3fn}, deepseek_engine, deepseek_prompts,
            DEEPSEEK_KERNELS, DEEPSEEK_PER_STEP,
        ),
    }
    launches["vision_bevfusion"] = vision_launches
    launches["llama3_8b_qlora"] = qlora_launches
    launches["llama3_8b_residual_stream"] = stream_launches
    launches["llama3_8b_tp8_collectives"] = tp8_launches
    # ``launches``: the Gemma run for the kernels it runs, the int4 run for
    # K1, K4 and K6, the int8, nf4 and w8a8 runs for their kernels (K12q:
    # during the nf4 init), the DeepSeek run for K11, K9's phase for K9, the
    # vision path for K13a, K13b and K13c; every path's count beside it (the quantized-cache runs' K2, K3, K7
    # and K11 among them).
    for row in rows:
        by_path = {path: counts[row["name"]] for path, counts in launches.items()}
        if row["name"] in PHASE_PATH_KERNELS:
            row["launches"] = row.pop("phase_launches")
        else:
            row["launches"] = by_path[PRIMARY_PATH.get(row["name"], "gemma2_2b_bf16")]
        row["launches_by_path"] = by_path
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was never launched on its main path")
    print(json.dumps({"kernels": rows}))
    print(card)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
