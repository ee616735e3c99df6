# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Quantized KV caches through both engines: the port's LLMEngine with
``cache_dtype=torch.int8`` or ``torch.float8_e4m3fn`` against the JAX
package's with ``jnp.int8`` / ``jnp.float8_e4m3fn``, on the same params.

DeepSeek-V2 (tests/test_torch_deepseek_engine.py's tiny MoE model, 2
layers, f32) over an int8 and over an e4m3 latent cache: the 45-token
prompt is chunk-prefilled over two 32-row steps, the first request then
decodes inside the third prefill step (mixed batching), and the 4-step
greedy decode runs to 8 tokens each. Both engines must give identical
tokens.

Llama and Gemma-2 over either cache, and DeepSeek again, are served by
the port's engine alone here: each must finish every request with its
tokens in the vocabulary, over caches of the asked dtype that hold the
quantized rows. A JAX Llama engine costs about 90 s of interpret-mode
compiles on one worker (the Tier-1 budget), and the Llama and Gemma
steps over both caches are held against the JAX package's in
tests/test_torch_kv_quant_models.py; the engine's scheduling does not
depend on the cache (tests/test_torch_llama_engine.py holds it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.models.deepseek import DeepseekV2Config as JaxDeepseekV2Config
from conch_tpu.models.deepseek import deepseek_decode_step as jax_ds_decode
from conch_tpu.models.deepseek import deepseek_prefill as jax_ds_prefill
from conch_tpu.models.deepseek import init_deepseek_params as jax_init_deepseek
from conch_tpu.serving import EngineConfig as JaxEngineConfig
from conch_tpu.serving import LLMEngine as JaxLLMEngine
from conch_tpu.serving import SamplingParams as JaxSamplingParams
from conch_tpu_torch.models.deepseek import (
    DeepseekV2Config,
    deepseek_decode_step,
    deepseek_params_from_jax,
    deepseek_prefill,
    init_deepseek_params,
)
from conch_tpu_torch.models.gemma import GemmaConfig, gemma_decode_step, gemma_prefill, init_gemma_params
from conch_tpu_torch.models.llama import LlamaConfig, init_llama_params
from conch_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

LLAMA_DIMS = {
    "vocab_size": 256, "hidden_size": 256, "intermediate_size": 512, "num_layers": 2,
    "num_heads": 4, "num_kv_heads": 1, "head_dim": 128,
}
LLAMA_ENGINE = {"page_size": 16, "num_pages": 64, "max_batch_size": 4, "max_prefill_tokens": 128}
DEEPSEEK_DIMS = {
    "vocab_size": 256, "hidden_size": 64, "num_layers": 2, "num_heads": 4, "kv_lora_rank": 32,
    "qk_rope_head_dim": 16, "qk_nope_head_dim": 32, "v_head_dim": 32, "n_routed_experts": 4,
    "n_shared_experts": 1, "num_experts_per_tok": 2, "moe_intermediate_size": 32, "intermediate_size": 64,
    "first_k_dense_replace": 1,
}
DEEPSEEK_ENGINE = {
    "page_size": 16, "num_pages": 64, "max_batch_size": 3, "max_pages_per_seq": 8, "max_prefill_tokens": 32,
    "enable_prefix_caching": False, "multi_step_decode": 4,
}
GEMMA_DIMS = {
    "vocab_size": 256, "hidden_size": 128, "intermediate_size": 256, "num_layers": 2, "num_heads": 4,
    "num_kv_heads": 2, "head_dim": 128, "max_position": 512, "attn_logit_softcap": 50.0,
    "final_logit_softcap": 30.0, "gemma2": True, "sliding_window": 24, "query_pre_attn_scalar": 64.0,
}


def _deepseek_prompts():
    # Prefill steps of one shape (32 rows): [r0 32], [r0 13, r1 19], [r0 decode 1, r1 11, r2 19].
    rng = np.random.default_rng(28)
    return [rng.integers(0, 256, n).tolist() for n in (45, 30, 19)]


@pytest.mark.parametrize("cache", ["int8", "fp8"])
def test_deepseek_quantized_cache_engine_greedy_tokens_match_jax(cache):
    jax_dtype, torch_dtype = {"int8": (jnp.int8, torch.int8), "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}[cache]
    jax_cfg = JaxDeepseekV2Config(**DEEPSEEK_DIMS, dtype=jnp.float32)
    numpy_params = jax.tree.map(np.asarray, jax_init_deepseek(0, jax_cfg))
    jax_engine = JaxLLMEngine(
        jax.tree.map(jnp.asarray, numpy_params), jax_cfg, JaxEngineConfig(**DEEPSEEK_ENGINE),
        cache_dtype=jax_dtype, prefill_fn=jax_ds_prefill, decode_fn=jax_ds_decode,
    )
    jax_tokens = jax_engine.generate(_deepseek_prompts(), JaxSamplingParams(max_tokens=8))
    cfg = DeepseekV2Config(**DEEPSEEK_DIMS, dtype=torch.float32)
    engine = LLMEngine(
        deepseek_params_from_jax(numpy_params, cfg, device="cpu"), cfg, EngineConfig(**DEEPSEEK_ENGINE),
        cache_dtype=torch_dtype, prefill_fn=deepseek_prefill, decode_fn=deepseek_decode_step, device="cpu",
    )
    out = engine.generate(_deepseek_prompts(), SamplingParams(max_tokens=8))
    assert engine.k_caches.dtype == torch_dtype and engine.k_caches.float().abs().max() > 0
    assert [len(o) for o in out] == [8, 8, 8]
    assert out == jax_tokens


def _served(engine, prompts, vocab, cache_dtype):
    out = engine.generate(prompts, SamplingParams(max_tokens=6))
    assert [len(o) for o in out] == [6] * len(prompts) and all(0 <= t < vocab for o in out for t in o)
    assert engine.k_caches.dtype == cache_dtype and engine.k_caches.float().abs().max() > 0
    return out


@pytest.mark.parametrize("cache_dtype", [torch.int8, torch.float8_e4m3fn])
def test_port_engine_serves_each_family_over_quantized_caches(cache_dtype):
    """Llama, Gemma-2 (its 40-token prompt crosses the 24-token window)
    and DeepSeek-V2 through the port's engine alone over either cache."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, n).tolist() for n in (40, 9)]
    llama_cfg = LlamaConfig(**LLAMA_DIMS, dtype=torch.float32)
    engine = LLMEngine(init_llama_params(0, llama_cfg, device="cpu"), llama_cfg, EngineConfig(**LLAMA_ENGINE),
                       cache_dtype=cache_dtype, device="cpu")
    _served(engine, prompts, 256, cache_dtype)
    gemma_cfg = GemmaConfig(**GEMMA_DIMS, dtype=torch.float32)
    engine = LLMEngine(init_gemma_params(0, gemma_cfg, device="cpu"), gemma_cfg, EngineConfig(**LLAMA_ENGINE),
                       cache_dtype=cache_dtype, prefill_fn=gemma_prefill, decode_fn=gemma_decode_step, device="cpu")
    _served(engine, prompts, 256, cache_dtype)
    ds_cfg = DeepseekV2Config(**DEEPSEEK_DIMS, dtype=torch.float32)
    engine = LLMEngine(init_deepseek_params(0, ds_cfg, device="cpu"), ds_cfg, EngineConfig(**DEEPSEEK_ENGINE),
                       cache_dtype=cache_dtype, prefill_fn=deepseek_prefill, decode_fn=deepseek_decode_step,
                       device="cpu")
    _served(engine, prompts, 256, cache_dtype)
