# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""The int4 slice end to end: the port's Llama with int4 projections (K1's
module) against the JAX package's.

One set of JAX params (``conch_tpu.models.llama.init_llama_params(0, ...,
quant_mode="int4")``: 2 layers, hidden 256, 4 query heads / 1 KV head,
head_dim 128, f32 activations, uint4b8 group-128 magic-packed
projections, bf16 lm_head) is carried over with ``params_from_jax``, bit
for bit. Then:

- one prefill step and one decode step give the JAX package's logits and
  KV pool, within the f32 attention tolerance (2e-3, as
  tests/test_torch_llama_steps.py);
- the port's own on-device int4 init quantizes the draws of its bf16 init.

tests/test_torch_llama_int4_engine.py serves both engines on the same
params; the two files are apart so that neither passes about two minutes
on one test worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from conch_tpu.models.llama import fuse_llama_params as jax_fuse
from conch_tpu.models.llama import init_kv_caches as jax_init_kv_caches
from conch_tpu.models.llama import init_llama_params as jax_init_llama_params
from conch_tpu.models.llama import llama_decode_step as jax_decode_step
from conch_tpu.models.llama import llama_prefill as jax_prefill
from conch_tpu_torch.kernels.quantization.gemm import dequantize_magic
from conch_tpu_torch.models.llama import (
    LlamaConfig,
    fuse_llama_params,
    init_kv_caches,
    init_llama_params,
    llama_decode_step,
    llama_prefill,
    params_from_jax,
)
from conch_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

DIMS = {
    "vocab_size": 256, "hidden_size": 256, "intermediate_size": 512, "num_layers": 2,
    "num_heads": 4, "num_kv_heads": 1, "head_dim": 128,
}
TOL = 2e-3
PS, NUM_PAGES, ROWS, BATCH, MAX_PAGES = 16, 16, 64, 4, 6
PAGES = [[3, 7, 1, 9, 10], [0, 5]]
PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@pytest.fixture(scope="module")
def jax_params():
    cfg = JaxLlamaConfig(**DIMS, dtype=jnp.float32)
    params = jax_init_llama_params(0, cfg, quant_mode="int4")
    return cfg, params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_params_group64():
    """The same tiny model with int4 projections at group 64."""
    cfg = JaxLlamaConfig(**DIMS, dtype=jnp.float32)
    params = jax_init_llama_params(0, cfg, quant_mode="int4", group_size=64)
    return cfg, params, jax.tree.map(np.asarray, params)


def _port_params(numpy_params):
    cfg = LlamaConfig(**DIMS, dtype=torch.float32)
    return cfg, params_from_jax(numpy_params, cfg, device="cpu")


def test_int4_params_carry_bit_for_bit(jax_params):
    _, params, numpy_params = jax_params
    _, ported = _port_params(numpy_params)
    for name in PROJECTIONS:
        ours, ref = ported["layers"][name], params["layers"][name]
        assert ours.kind == ref.kind == "int4" and ours.meta == ref.meta and ours.meta["layout"] == "magic"
        assert ours.arrays["packed"].dtype == torch.int32 and ours.arrays["scales"].dtype == torch.bfloat16
        np.testing.assert_array_equal(ours.arrays["packed"].numpy(), np.asarray(ref.arrays["packed"]))
        scale_bits = np.asarray(ref.arrays["scales"]).view(np.uint16)
        np.testing.assert_array_equal(ours.arrays["scales"].view(torch.int16).numpy().view(np.uint16), scale_bits)
    assert ported["lm_head"].kind == "dense" and ported["lm_head"].arrays["w"].dtype == torch.bfloat16
    fused = fuse_llama_params(ported)["layers"]
    assert fused["wqkv"].kind == fused["w_gateup"].kind == "int4"
    assert fused["wqkv"].arrays["packed"].shape == (2, 256 // 8, 4 * 128 + 2 * 128)


def _steps():
    """A prefill of two fresh prompts (40 and 21 tokens, 3 padding rows,
    2 zero-length padding sequences), then a decode step with 2 idle rows."""
    rng = np.random.default_rng(4)
    bt = np.zeros((BATCH, MAX_PAGES), np.int32)
    for b, pages in enumerate(PAGES):
        bt[b, : len(pages)] = pages

    def slot(b, pos):
        return PAGES[b][pos // PS] * PS + pos % PS

    lens = [40, 21]
    tokens = np.zeros(ROWS, np.int32)
    positions = np.zeros(ROWS, np.int32)
    slots = np.full(ROWS, -1, np.int32)
    tokens[:61] = rng.integers(0, 256, 61)
    positions[:61] = np.concatenate([np.arange(n) for n in lens])
    slots[:61] = [slot(b, p) for b, n in enumerate(lens) for p in range(n)]
    cu = np.array([0, 40, 61, 61, 61], np.int32)
    seq_lens = np.array([40, 21, 0, 0], np.int32)
    prefill = ("prefill", tokens, positions, cu, seq_lens, bt, slots)
    decode = (
        "decode", np.array([5, 9, 0, 0], np.int32), np.array([40, 21, 0, 0], np.int32),
        np.array([41, 22, 0, 0], np.int32), bt, np.array([slot(0, 40), slot(1, 21), -1, -1], np.int32),
    )
    return [prefill, decode]


def test_int4_step_logits_match_jax(jax_params):
    _check_steps_against_jax(*jax_params)


def test_int4_group64_step_logits_match_jax(jax_params_group64):
    """int4 at group 64 carries across with its group in the meta (and
    scales of K / 64 rows), then one prefill and one decode step give JAX's
    logits and KV pool at the tolerance of the group-128 case."""
    _, params, numpy_params = jax_params_group64
    _, ported = _port_params(numpy_params)
    for name in PROJECTIONS:
        ours = ported["layers"][name]
        assert ours.meta == params["layers"][name].meta and ours.meta["group_size"] == 64
        k = ours.arrays["packed"].shape[1] * 8
        assert ours.arrays["scales"].shape[1] == k // 64
    assert fuse_llama_params(ported)["layers"]["wqkv"].meta["group_size"] == 64
    _check_steps_against_jax(*jax_params_group64)


def _check_steps_against_jax(jax_cfg, params, numpy_params):
    cfg, ported = _port_params(numpy_params)
    steps = _steps()

    jparams = jax_fuse(params)
    jprefill = jax.jit(lambda p, *a: jax_prefill(p, jax_cfg, *a[:3], ROWS, *a[3:]))
    jdecode = jax.jit(lambda p, *a: jax_decode_step(p, jax_cfg, *a))
    jkc, jvc = jax_init_kv_caches(jax_cfg, NUM_PAGES, PS)
    ported = fuse_llama_params(ported)
    kc, vc = init_kv_caches(cfg, NUM_PAGES, PS, device="cpu")
    for kind, *arrays in steps:
        tensors = [torch.from_numpy(a) for a in arrays]
        if kind == "prefill":
            ref, jkc, jvc = jprefill(jparams, *map(jnp.asarray, arrays), jkc, jvc)
            out, _, _ = llama_prefill(ported, cfg, *tensors[:3], ROWS, *tensors[3:], kc, vc)
        else:
            ref, jkc, jvc = jdecode(jparams, *map(jnp.asarray, arrays), jkc, jvc)
            out, _, _ = llama_decode_step(ported, cfg, *tensors, kc, vc)
        assert out.dtype == torch.float32 and out.shape == (BATCH, DIMS["vocab_size"])
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL, err_msg=kind)
    np.testing.assert_allclose(kc.numpy(), np.asarray(jkc), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(vc.numpy(), np.asarray(jvc), atol=TOL, rtol=TOL)


def test_int4_init_on_device_quantizes_the_bf16_draws():
    """``init_llama_params(..., "int4")`` quantizes the same float32 draws
    that the bf16 init rounds to bf16: each dequantized weight lies within
    half a quantization step of them (plus bf16 rounding), and the engine
    serves on it with 512-row steps and 32 decode rows, the README's limits."""
    cfg = LlamaConfig(**DIMS, dtype=torch.bfloat16)
    dense = init_llama_params(0, cfg, device="cpu")
    quant = init_llama_params(0, cfg, quant_mode="int4", device="cpu")
    assert quant["lm_head"].kind == "dense"
    torch.testing.assert_close(quant["lm_head"].arrays["w"], dense["lm_head"].arrays["w"], rtol=0, atol=0)
    for name in PROJECTIONS:
        q, w = quant["layers"][name], dense["layers"][name].arrays["w"].float()
        assert q.kind == "int4" and q.arrays["packed"].shape == (2, w.shape[1] // 8, w.shape[2])
        for layer in range(2):
            scales = q.arrays["scales"][layer]
            deq = dequantize_magic(q.arrays["packed"][layer], scales, w.shape[1], 128, 8)
            step = scales.float().repeat_interleave(128, dim=0)
            assert ((deq - w[layer]).abs() <= 0.5 * step + 1e-2 * w[layer].abs() + 1e-6).all()
    engine = LLMEngine(quant, cfg, EngineConfig(num_pages=64, max_batch_size=32), device="cpu")
    assert engine.ecfg.max_prefill_tokens == 512
    assert EngineConfig(max_batch_size=129).max_batch_size == 129  # no 128-row cap
    out = engine.generate([[t % 256 for t in range(600)], list(range(3, 40))], SamplingParams(max_tokens=4))
    assert [len(o) for o in out] == [4, 4] and all(0 <= t < DIMS["vocab_size"] for o in out for t in o)
