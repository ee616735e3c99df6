# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Qwen2's attention biases and a GQA group of 7 in the port, against the
JAX package.

A tiny ``attention_bias=True`` Llama (2 layers, hidden 256, 7 query heads
over 1 KV head of 128: the group of Qwen2-7B's 28 heads over 4, which is
not a power of two) is drawn by ``conch_tpu.models.llama.init_llama_params``
and carried over with ``params_from_jax``. The JAX side runs its Pallas
kernels in interpret mode at group 7. A prefill (two prompts, padding rows
and padding sequences), a chunked prefill step with a mixed-in decode row
and two decode steps go through both models; logits and the KV pool agree
at the port's Llama step tolerances (f32 2e-3). A short engine run gives
the JAX engine's greedy tokens; the JAX engine runs once, its block table
sized to the prompts.
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
from conch_tpu.serving import EngineConfig as JaxEngineConfig
from conch_tpu.serving import LLMEngine as JaxLLMEngine
from conch_tpu.serving import SamplingParams as JaxSamplingParams
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
    "num_heads": 7, "num_kv_heads": 1, "head_dim": 128, "attention_bias": True,
}
TOL = 2e-3  # the port's f32 Llama step tolerance (tests/test_torch_llama_steps.py)
PS, NUM_PAGES, ROWS, BATCH, MAX_PAGES = 16, 16, 64, 4, 6
PAGES = [[3, 7, 1, 9, 10], [0, 5]]
ENGINE = {"page_size": 16, "num_pages": 64, "max_batch_size": 4, "max_pages_per_seq": 8, "max_prefill_tokens": 64}
ENGINE_PROMPTS = (40, 21, 7)


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_llama_params(0, JaxLlamaConfig(**DIMS, dtype=jnp.float32))


def _port_params(jax_params):
    cfg = LlamaConfig(**DIMS, dtype=torch.float32)
    return cfg, params_from_jax(jax.tree.map(np.asarray, jax_params), cfg, device="cpu")


def _steps():
    """The engine's host-side inputs of each step (as in
    tests/test_torch_llama_steps.py)."""
    rng = np.random.default_rng(4)
    bt = np.zeros((BATCH, MAX_PAGES), np.int32)
    for b, pages in enumerate(PAGES):
        bt[b, : len(pages)] = pages

    def slot(b, pos):
        return PAGES[b][pos // PS] * PS + pos % PS

    def prefill(chunks):  # chunks: [(seq, start, length)]
        tokens, positions = np.zeros(ROWS, np.int32), np.zeros(ROWS, np.int32)
        slots, cu, seq_lens = np.full(ROWS, -1, np.int32), np.zeros(BATCH + 1, np.int32), np.zeros(BATCH, np.int32)
        row = 0
        for i, (b, start, n) in enumerate(chunks):
            tokens[row : row + n] = rng.integers(0, 256, n)
            positions[row : row + n] = np.arange(start, start + n)
            slots[row : row + n] = [slot(b, p) for p in range(start, start + n)]
            row += n
            cu[i + 1] = row
            seq_lens[i] = start + n
        cu[len(chunks) + 1 :] = row
        table = np.zeros_like(bt)
        table[: len(chunks)] = bt[[b for b, _, _ in chunks]]
        return ("prefill", tokens, positions, cu, seq_lens, table, slots)

    def decode(pos):
        tokens = np.zeros(BATCH, np.int32)
        tokens[:2] = rng.integers(0, 256, 2)
        positions = np.array([pos[0], pos[1], 0, 0], np.int32)
        seq_lens = np.array([pos[0] + 1, pos[1] + 1, 0, 0], np.int32)
        slots = np.array([slot(0, pos[0]), slot(1, pos[1]), -1, -1], np.int32)
        return ("decode", tokens, positions, seq_lens, bt, slots)

    return [prefill([(0, 0, 40), (1, 0, 21)]), prefill([(1, 21, 1), (0, 40, 30)]), decode((70, 22)), decode((71, 23))]


def test_params_from_jax_carries_the_biases(jax_params):
    cfg, params = _port_params(jax_params)
    for name, dim in (("bq", 7 * 128), ("bk", 128), ("bv", 128)):
        ours = params["layers"][name]
        assert ours.shape == (2, dim) and ours.dtype == torch.float32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_params["layers"][name]))
        assert float(ours.abs().max()) > 0.0
    fused = fuse_llama_params(params)["layers"]
    assert "wqkv" in fused and all(name in fused for name in ("bq", "bk", "bv"))
    plain = dict(jax_params, layers={k: v for k, v in jax_params["layers"].items() if k != "bq"})
    with pytest.raises(ValueError, match="attention_bias"):
        params_from_jax(jax.tree.map(np.asarray, plain), cfg, device="cpu")
    drawn = init_llama_params(0, cfg, quant_mode="int4", device="cpu")["layers"]
    assert drawn["bq"].shape == (2, 7 * 128) and drawn["bk"].dtype == torch.float32


def test_step_logits_match_jax(jax_params):
    """Prefill and decode logits (and the KV pool) at group 7 with biases."""
    cfg, params = _port_params(jax_params)
    jax_cfg = JaxLlamaConfig(**DIMS, dtype=jnp.float32)
    fused = jax_fuse(jax_params)
    prefill = jax.jit(lambda p, *a: jax_prefill(p, jax_cfg, *a[:3], ROWS, *a[3:]))
    decode = jax.jit(lambda p, *a: jax_decode_step(p, jax_cfg, *a))
    jkc, jvc = jax_init_kv_caches(jax_cfg, NUM_PAGES, PS)
    params = fuse_llama_params(params)
    kc, vc = init_kv_caches(cfg, NUM_PAGES, PS, device="cpu")
    for i, (kind, *arrays) in enumerate(_steps()):
        tensors = [torch.from_numpy(a) for a in arrays]
        if kind == "prefill":
            ref, jkc, jvc = prefill(fused, *map(jnp.asarray, arrays), jkc, jvc)
            ours, _, _ = llama_prefill(params, cfg, *tensors[:3], ROWS, *tensors[3:], kc, vc)
        else:
            ref, jkc, jvc = decode(fused, *map(jnp.asarray, arrays), jkc, jvc)
            ours, _, _ = llama_decode_step(params, cfg, *tensors, kc, vc)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL, rtol=TOL, err_msg=f"step {i}")
    np.testing.assert_allclose(kc.numpy(), np.asarray(jkc), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(vc.numpy(), np.asarray(jvc), atol=TOL, rtol=TOL)


def test_biases_change_the_logits(jax_params):
    """The biases reach the output: without them the prefill logits move."""
    cfg, params = _port_params(jax_params)
    kind, *arrays = _steps()[0]
    tensors = [torch.from_numpy(a) for a in arrays]

    def logits(p):
        kc, vc = init_kv_caches(cfg, NUM_PAGES, PS, device="cpu")
        return llama_prefill(p, cfg, *tensors[:3], ROWS, *tensors[3:], kc, vc)[0]

    zeroed = dict(params, layers={k: (torch.zeros_like(v) if k in ("bq", "bk", "bv") else v)
                                  for k, v in params["layers"].items()})
    assert float((logits(params) - logits(zeroed)).abs().max()) > 10 * TOL


def test_engine_greedy_tokens_match_jax(jax_params):
    prompts = [np.random.default_rng(0).integers(0, 256, n).tolist() for n in ENGINE_PROMPTS]
    jax_cfg = JaxLlamaConfig(**DIMS, dtype=jnp.float32)
    expected = JaxLLMEngine(jax_params, jax_cfg, JaxEngineConfig(**ENGINE)).generate(
        prompts, JaxSamplingParams(max_tokens=8)
    )
    cfg, params = _port_params(jax_params)
    out = LLMEngine(params, cfg, EngineConfig(**ENGINE), device="cpu").generate(prompts, SamplingParams(max_tokens=8))
    assert out == expected
