# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Qwen2-shaped int4 at float16 through both engines, and the dense head's
one-time conversion to f16.

A tiny ``attention_bias=True`` Llama (2 layers, hidden 256, 7 query heads
over 1 KV head of 128: Qwen2-7B's GQA group) at ``dtype=float16`` in int4
is drawn by ``conch_tpu.models.llama.init_llama_params(0, ...,
quant_mode="int4")``: uint4b8 group-128 magic-packed projections with bf16
scales, f16 embedding, norms and biases, a bf16 dense ``lm_head``. It is
carried over with ``params_from_jax``; both engines serve the same prompts
greedily over f16 KV caches and must give identical tokens. The JAX engine
runs its Pallas kernels in interpret mode (f16 kept there), where each new
step shape costs a compile, so it runs once, and its two prompts fit one
prefill step: every prefill and every decode step reuses one shape.

The port's engine converts the bf16 head to f16 once at load
(``cast_dense_head``), where JAX casts it at every call: the converted
weight equals the per-call cast bit for bit, and so do the logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from conch_tpu.models.llama import init_llama_params as jax_init_llama_params
from conch_tpu.serving import EngineConfig as JaxEngineConfig
from conch_tpu.serving import LLMEngine as JaxLLMEngine
from conch_tpu.serving import SamplingParams as JaxSamplingParams
from conch_tpu_torch.models.linear import QuantizedLinear, cast_dense_head
from conch_tpu_torch.models.llama import LlamaConfig, params_from_jax
from conch_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

DIMS = {
    "vocab_size": 256, "hidden_size": 256, "intermediate_size": 512, "num_layers": 2,
    "num_heads": 7, "num_kv_heads": 1, "head_dim": 128, "attention_bias": True,
}
ENGINE = {"page_size": 16, "num_pages": 32, "max_batch_size": 2, "max_prefill_tokens": 64, "max_pages_per_seq": 4}
PROMPTS = (23, 30)  # one prefill step of 53 rows
MAX_TOKENS = 6


@pytest.fixture(scope="module")
def jax_params():
    cfg = JaxLlamaConfig(**DIMS, dtype=jnp.float16)
    params = jax_init_llama_params(0, cfg, quant_mode="int4")
    return cfg, params, jax.tree.map(np.asarray, params)


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, DIMS["vocab_size"], n).tolist() for n in PROMPTS]


def _port(numpy_params):
    cfg = LlamaConfig(**DIMS, dtype=torch.float16)
    return cfg, params_from_jax(numpy_params, cfg, device="cpu")


def test_jax_init_is_the_checkpoint_layout(jax_params):
    """What the port serves: bf16 int4 scales, f16 embedding and biases, a
    bf16 dense head (so the head conversion has work to do)."""
    _, _, numpy_params = jax_params
    cfg, params = _port(numpy_params)
    assert params["layers"]["wq"].arrays["scales"].dtype == torch.bfloat16
    assert params["embedding"].dtype == params["layers"]["bq"].dtype == torch.float16
    assert params["lm_head"].kind == "dense" and params["lm_head"].arrays["w"].dtype == torch.bfloat16


def test_f16_int4_engine_greedy_tokens_match_jax(jax_params):
    jax_cfg, params, numpy_params = jax_params
    want = JaxLLMEngine(params, jax_cfg, JaxEngineConfig(**ENGINE)).generate(
        _prompts(), JaxSamplingParams(max_tokens=MAX_TOKENS))
    cfg, ported = _port(numpy_params)
    engine = LLMEngine(ported, cfg, EngineConfig(**ENGINE), device="cpu")
    assert engine.k_caches.dtype == torch.float16
    assert engine.params["lm_head"].arrays["w"].dtype == torch.float16
    assert engine.generate(_prompts(), SamplingParams(max_tokens=MAX_TOKENS)) == want


def test_head_conversion_round_trip(jax_params):
    """The head converted once equals the per-call cast bit for bit, gives
    the same logits bit for bit, and returns to the bf16 weight where f16
    is normal; heads whose conversion would change their size, and
    quantized heads, are left as they are."""
    _, _, numpy_params = jax_params
    _, params = _port(numpy_params)
    head = params["lm_head"]
    converted = cast_dense_head(params, torch.float16)["lm_head"]
    w = head.arrays["w"]
    assert converted.arrays["w"].dtype == torch.float16
    assert torch.equal(converted.arrays["w"].view(torch.int16), w.to(torch.float16).view(torch.int16))
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(5, DIMS["hidden_size"])).astype(np.float32))
    x = x.to(torch.float16)
    assert torch.equal(converted.apply(x).view(torch.int16), head.apply(x).view(torch.int16))
    # Back to bf16: exact wherever f16 is normal (a bf16 value has 8
    # significant bits); below 2^-14 both paths round alike, as above.
    normal = w.float().abs() >= 2.0**-14
    assert torch.equal(converted.arrays["w"].to(torch.bfloat16)[normal], w[normal])
    assert cast_dense_head(params, torch.bfloat16) is params
    assert cast_dense_head(params, torch.float32) is params
    quantized = {**params, "lm_head": QuantizedLinear("int4", {"packed": w, "scales": w}, {})}
    assert cast_dense_head(quantized, torch.float16) is quantized
