# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Gemma step by step: the port's gemma_prefill / gemma_decode_step logits
and KV pool against the JAX package's, in f32.

Tiny Gemma-2 (sandwich norms; layer 0 local with a 24-token window, layer
1 global) and Gemma-1, both with attention softcap 50 and final softcap
30: 2 layers, hidden 128, 4 query heads / 2 KV heads of 128, so the JAX
side runs its all-heads Pallas kernels in interpret mode. The norm weights
are set to random values (the init's zeros make ``(1 + w)`` 1, where a
dropped weight would pass). JAX params are carried across with
``gemma_params_from_jax`` and fused on both sides, as both engines do. The
steps, as the engine builds them: a prefill of two fresh prompts (40 and
21 tokens) with padding rows and zero-length padding sequences, a chunked
prefill step with a mixed-in decode row reaching 70 tokens (past the
window), and two decode steps with idle rows. Tolerance: 2e-3, absolute
and relative (the f32 attention tolerance of
tests/paged_attention_test.py:21; the sides differ in summation order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.models.gemma import GemmaConfig as JaxGemmaConfig
from conch_tpu.models.gemma import gemma_decode_step as jax_decode_step
from conch_tpu.models.gemma import gemma_prefill as jax_prefill
from conch_tpu.models.gemma import init_gemma_kv_caches as jax_init_kv_caches
from conch_tpu.models.gemma import init_gemma_params as jax_init_gemma_params
from conch_tpu.models.llama import fuse_llama_params as jax_fuse
from conch_tpu_torch.models.gemma import (
    GemmaConfig,
    gemma_decode_step,
    gemma_params_from_jax,
    gemma_prefill,
    gemma_verify_forward,
    init_gemma_kv_caches,
    init_gemma_params,
)
from conch_tpu_torch.models.llama import fuse_llama_params
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

DIMS = {
    "vocab_size": 128, "hidden_size": 128, "intermediate_size": 256, "num_layers": 2, "num_heads": 4,
    "num_kv_heads": 2, "head_dim": 128, "max_position": 512, "attn_logit_softcap": 50.0,
    "final_logit_softcap": 30.0,
}
VARIANTS = {
    "gemma2": {"gemma2": True, "sliding_window": 24, "query_pre_attn_scalar": 64.0},
    "gemma1": {},
}
TOL = 2e-3
PS, NUM_PAGES, ROWS, BATCH, MAX_PAGES = 16, 16, 64, 4, 6
PAGES = [[3, 7, 1, 9, 10], [0, 5]]  # page 0 is a real page


def _steps():
    """Host-side inputs of each step, as the engine builds them."""
    rng = np.random.default_rng(4)
    bt = np.zeros((BATCH, MAX_PAGES), np.int32)
    for b, pages in enumerate(PAGES):
        bt[b, : len(pages)] = pages

    def slot(b, pos):
        return PAGES[b][pos // PS] * PS + pos % PS

    def prefill(chunks):  # chunks: [(seq, start, length)]
        tokens = np.zeros(ROWS, np.int32)
        positions = np.zeros(ROWS, np.int32)
        slots = np.full(ROWS, -1, np.int32)
        cu = np.zeros(BATCH + 1, np.int32)
        seq_lens = np.zeros(BATCH, np.int32)
        row = 0
        for i, (b, start, n) in enumerate(chunks):
            tokens[row : row + n] = rng.integers(0, DIMS["vocab_size"], n)
            positions[row : row + n] = np.arange(start, start + n)
            slots[row : row + n] = [slot(b, p) for p in range(start, start + n)]
            row += n
            cu[i + 1] = row
            seq_lens[i] = start + n
        cu[len(chunks) + 1 :] = row  # zero-length padding sequences
        table = np.zeros_like(bt)
        table[: len(chunks)] = bt[[b for b, _, _ in chunks]]
        return ("prefill", tokens, positions, cu, seq_lens, table, slots)

    def decode(pos):  # rows 0, 1 active at these positions; rows 2, 3 idle
        tokens = np.zeros(BATCH, np.int32)
        tokens[:2] = rng.integers(0, DIMS["vocab_size"], 2)
        positions = np.array([pos[0], pos[1], 0, 0], np.int32)
        seq_lens = np.array([pos[0] + 1, pos[1] + 1, 0, 0], np.int32)
        slots = np.array([slot(0, pos[0]), slot(1, pos[1]), -1, -1], np.int32)
        return ("decode", tokens, positions, seq_lens, bt, slots)

    return [
        prefill([(0, 0, 40), (1, 0, 21)]),
        prefill([(1, 21, 1), (0, 40, 30)]),
        decode((70, 22)),
        decode((71, 23)),
    ]


def random_norms(numpy_params: dict, seed: int) -> dict:
    """The params with every norm weight drawn at random (std 0.3)."""
    rng = np.random.default_rng(seed)
    layers = dict(numpy_params["layers"])
    for name, w in layers.items():
        if name.endswith("_norm"):
            layers[name] = (0.3 * rng.normal(size=w.shape)).astype(w.dtype)
    final = (0.3 * rng.normal(size=numpy_params["final_norm"].shape)).astype(numpy_params["final_norm"].dtype)
    return {**numpy_params, "layers": layers, "final_norm": final}


def _run_jax(params, cfg, steps):
    params = jax_fuse(jax.tree.map(jnp.asarray, params))
    prefill = jax.jit(lambda p, *a: jax_prefill(p, cfg, *a[:3], ROWS, *a[3:]))
    decode = jax.jit(lambda p, *a: jax_decode_step(p, cfg, *a))
    kc, vc = jax_init_kv_caches(cfg, NUM_PAGES, PS)
    logits = []
    for kind, *arrays in steps:
        fn = prefill if kind == "prefill" else decode
        out, kc, vc = fn(params, *map(jnp.asarray, arrays), kc, vc)
        logits.append(np.asarray(out))
    return logits, np.asarray(kc, np.float32), np.asarray(vc, np.float32)


def _run_port(params, cfg, steps):
    params = fuse_llama_params(params)
    assert "wqkv" in params["layers"] and "w_gateup" in params["layers"]
    kc, vc = init_gemma_kv_caches(cfg, NUM_PAGES, PS, device="cpu")
    logits = []
    for kind, *arrays in steps:
        tensors = [torch.from_numpy(a) for a in arrays]
        if kind == "prefill":
            out, _, _ = gemma_prefill(params, cfg, *tensors[:3], ROWS, *tensors[3:], kc, vc)
        else:
            out, _, _ = gemma_decode_step(params, cfg, *tensors, kc, vc)
        logits.append(out.numpy())
    return logits, kc.float().numpy(), vc.float().numpy()


@pytest.mark.parametrize("variant", ["gemma2", "gemma1"])
def test_gemma_step_logits_match_jax(variant):
    jax_cfg = JaxGemmaConfig(**DIMS, **VARIANTS[variant], dtype=jnp.float32)
    cfg = GemmaConfig(**DIMS, **VARIANTS[variant], dtype=torch.float32)
    numpy_params = random_norms(jax.tree.map(np.asarray, jax_init_gemma_params(0, jax_cfg)), seed=1)
    params = gemma_params_from_jax(numpy_params, cfg, device="cpu")
    steps = _steps()
    jax_logits, jax_kc, jax_vc = _run_jax(numpy_params, jax_cfg, steps)
    logits, kc, vc = _run_port(params, cfg, steps)
    for i, (ours, ref) in enumerate(zip(logits, jax_logits)):
        assert ours.dtype == np.float32 and ours.shape == ref.shape == (BATCH, DIMS["vocab_size"])
        np.testing.assert_allclose(ours, ref, atol=TOL, rtol=TOL, err_msg=f"step {i}")
    assert np.abs(logits[0]).max() <= DIMS["final_logit_softcap"]
    np.testing.assert_allclose(kc, jax_kc, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(vc, jax_vc, atol=TOL, rtol=TOL)


def test_the_window_and_sandwich_norms_change_the_logits():
    """Each Gemma-2 feature is live on this path: without the window, or
    with Gemma-1's norms, the last decode step's logits differ."""
    cfg = GemmaConfig(**DIMS, **VARIANTS["gemma2"], dtype=torch.float32)
    jax_cfg = JaxGemmaConfig(**DIMS, **VARIANTS["gemma2"], dtype=jnp.float32)
    numpy_params = random_norms(jax.tree.map(np.asarray, jax_init_gemma_params(0, jax_cfg)), seed=1)
    params = gemma_params_from_jax(numpy_params, cfg, device="cpu")
    steps = _steps()
    base = _run_port(params, cfg, steps)[0][-1]
    no_window = dataclasses.replace(cfg, sliding_window=10**6)
    assert not np.allclose(_run_port(params, no_window, steps)[0][-1], base, atol=TOL, rtol=TOL)
    gemma1 = dataclasses.replace(cfg, gemma2=False)
    assert not np.allclose(_run_port(params, gemma1, steps)[0][-1], base, atol=TOL, rtol=TOL)


def test_gemma_params_carry_across_bit_for_bit():
    cfg = GemmaConfig(**DIMS, **VARIANTS["gemma2"])
    jax_cfg = JaxGemmaConfig(**DIMS, **VARIANTS["gemma2"])
    numpy_params = random_norms(jax.tree.map(np.asarray, jax_init_gemma_params(2, jax_cfg)), seed=3)
    params = gemma_params_from_jax(numpy_params, cfg, device="cpu")
    for name in ("input_norm", "post_attn_norm", "pre_ff_norm", "post_ff_norm"):
        ours, ref = params["layers"][name], numpy_params["layers"][name]
        assert ours.dtype == torch.bfloat16 and ours.shape == ref.shape
        np.testing.assert_array_equal(ours.view(torch.int16).numpy().view(np.uint16), ref.view(np.uint16))
    w = params["layers"]["w_up"].arrays["w"]
    np.testing.assert_array_equal(
        w.view(torch.int16).numpy().view(np.uint16), numpy_params["layers"]["w_up"].arrays["w"].view(np.uint16)
    )
    np.testing.assert_array_equal(params["cos_sin_cache"].numpy(), numpy_params["cos_sin_cache"])
    layers = dict(numpy_params["layers"])
    del layers["post_ff_norm"]
    with pytest.raises(ValueError, match="post_ff_norm"):
        gemma_params_from_jax({**numpy_params, "layers": layers}, cfg, device="cpu")


def test_init_gemma_params_schema_matches_jax():
    """The port's random init has the JAX schema: same keys, shapes and
    kinds; zero norms; the tied embedding in the model dtype."""
    jax_cfg = JaxGemmaConfig(**DIMS, **VARIANTS["gemma2"])
    cfg = GemmaConfig(**DIMS, **VARIANTS["gemma2"])
    ref = jax_init_gemma_params(0, jax_cfg)
    ours = init_gemma_params(0, cfg, device="cpu")
    assert ours.keys() == ref.keys() and ours["layers"].keys() == ref["layers"].keys()
    for name, value in ref["layers"].items():
        mine = ours["layers"][name]
        if hasattr(value, "arrays"):
            assert mine.kind == "dense" and mine.arrays["w"].shape == value.arrays["w"].shape
            assert abs(mine.arrays["w"].float().std().item() - 0.02) < 2e-3
        else:
            assert mine.shape == value.shape and not mine.any()
    assert ours["embedding"].shape == ref["embedding"].shape and ours["embedding"].dtype == torch.bfloat16
    assert ours["cos_sin_cache"].shape == ref["cos_sin_cache"].shape
    full = GemmaConfig.gemma2_2b()
    assert (full.attn_scale(), full.window(0), full.window(1)) == (1.0 / 16.0, 4096, 0)
    # The quantized modes, once refused, are served (tests/test_torch_gemma_quant.py);
    # a mode the port does not know still raises and names it.
    with pytest.raises(ValueError, match="Unknown quantization mode: int3"):
        init_gemma_params(0, cfg, quant_mode="int3", device="cpu")
    # gemma_verify_forward, once a stub, is ported (tests/test_torch_verify_forward.py);
    # LoRA serves the Llama family only: the JAX Gemma steps take no adapters.
    with pytest.raises(NotImplementedError, match="Gemma takes no LoRA"):
        gemma_verify_forward(ours, cfg, *[None] * 9, lora={})
    with pytest.raises(ValueError, match="even"):
        GemmaConfig(**{**DIMS, "num_layers": 3}, **VARIANTS["gemma2"])
