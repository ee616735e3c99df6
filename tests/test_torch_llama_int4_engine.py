# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""The int4 slice through both engines: the port's LLMEngine against the
JAX package's, on the same int4 params.

JAX params (``conch_tpu.models.llama.init_llama_params(0, ...,
quant_mode="int4")``: 2 layers, hidden 256, 4 query heads / 1 KV head,
head_dim 128, f32 activations, uint4b8 group-128 magic-packed
projections) are carried over with ``params_from_jax``. Both engines
serve the same prompts greedily with ``max_prefill_tokens=256`` (above
the 128 rows the port took before K4 and K6) and must give identical
tokens.

The JAX engine runs its Pallas kernels in interpret mode, where each new
step shape costs tens of seconds of compilation, so it runs once per
module, and its prompts are sized so that both prefill steps have one
shape: 20 + 236 tokens, then a mixed-in decode row + the last 164 tokens
(256 rows, longest chunk above 128, in both).
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
from conch_tpu_torch.models.llama import LlamaConfig, params_from_jax
from conch_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

DIMS = {
    "vocab_size": 256, "hidden_size": 256, "intermediate_size": 512, "num_layers": 2,
    "num_heads": 4, "num_kv_heads": 1, "head_dim": 128,
}
# max_pages_per_seq: what the requests need (the default is 64); the JAX
# engine's interpret-mode compile grows with the block table's width.
ENGINE = {
    "page_size": 16, "num_pages": 64, "max_batch_size": 4, "max_prefill_tokens": 256, "max_pages_per_seq": 32,
}


@pytest.fixture(scope="module")
def jax_params():
    cfg = JaxLlamaConfig(**DIMS, dtype=jnp.float32)
    params = jax_init_llama_params(0, cfg, quant_mode="int4")
    return cfg, params, jax.tree.map(np.asarray, params)


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, 20).tolist(), rng.integers(0, 256, 400).tolist()]


@pytest.fixture(scope="module")
def jax_engine_tokens(jax_params):
    jax_cfg, params, _ = jax_params
    engine = JaxLLMEngine(params, jax_cfg, JaxEngineConfig(**ENGINE))
    return engine.generate(_prompts(), JaxSamplingParams(max_tokens=8))


def test_int4_engine_greedy_tokens_match_jax(jax_params, jax_engine_tokens):
    _, _, numpy_params = jax_params
    cfg = LlamaConfig(**DIMS, dtype=torch.float32)
    ported = params_from_jax(numpy_params, cfg, device="cpu")
    engine = LLMEngine(ported, cfg, EngineConfig(**ENGINE), device="cpu")
    assert engine.ecfg.max_prefill_tokens == 256
    assert engine.generate(_prompts(), SamplingParams(max_tokens=8)) == jax_engine_tokens
