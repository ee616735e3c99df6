# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""DeepSeek-V2 in int8 at group 32 through both engines: the port's
LLMEngine (K1b at 8 word rows a slice on the card, its plain version here)
against the JAX package's, on the same params.

The model of tests/deepseek_test.py:148 (2 dense layers, hidden 64, 4
heads, latent 32 + rope 16; f32 activations) with its projections and
lm_head in int8 at group 32 (``init_deepseek_params(2, ...,
quant_mode="int8", group_size=32)`` of the JAX package: planar packing, 8
word rows a group; [wq|w_kv_a] and gate|up fused in both engines), carried
across with ``deepseek_params_from_jax``. Both engines serve the same two
prompts greedily and must give identical tokens: the 45-token prompt is
chunk-prefilled over two 32-row steps with the 19-token request joining
the second, then the decode runs to 6 tokens each. The JAX engine runs
once per module (each new step shape costs tens of seconds of
interpret-mode compiling).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.models.deepseek import DeepseekV2Config as JaxDeepseekV2Config
from conch_tpu.models.deepseek import deepseek_decode_step as jax_decode_step
from conch_tpu.models.deepseek import deepseek_prefill as jax_prefill
from conch_tpu.models.deepseek import init_deepseek_params as jax_init_params
from conch_tpu.serving import EngineConfig as JaxEngineConfig
from conch_tpu.serving import LLMEngine as JaxLLMEngine
from conch_tpu.serving import SamplingParams as JaxSamplingParams
from conch_tpu_torch.kernels.quantization.gemm import mixed_gemm_planar_launcher
from conch_tpu_torch.models.deepseek import (
    DeepseekV2Config,
    deepseek_decode_step,
    deepseek_params_from_jax,
    deepseek_prefill,
)
from conch_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

DIMS = {
    "vocab_size": 128, "hidden_size": 64, "num_layers": 2, "num_heads": 4, "kv_lora_rank": 32,
    "qk_rope_head_dim": 16, "qk_nope_head_dim": 32, "v_head_dim": 32, "intermediate_size": 64,
}
ENGINE = {
    "page_size": 16, "num_pages": 64, "max_batch_size": 2, "max_pages_per_seq": 4, "max_prefill_tokens": 32,
    "enable_prefix_caching": False,
}


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, DIMS["vocab_size"], n).tolist() for n in (45, 19)]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX engine's tokens and its int8 params (numpy)."""
    cfg = JaxDeepseekV2Config(**DIMS, dtype=jnp.float32)
    numpy_params = jax.tree.map(np.asarray, jax_init_params(2, cfg, quant_mode="int8", group_size=32))
    engine = JaxLLMEngine(
        jax.tree.map(jnp.asarray, numpy_params), cfg, JaxEngineConfig(**ENGINE),
        prefill_fn=jax_prefill, decode_fn=jax_decode_step,
    )
    return numpy_params, engine.generate(_prompts(), JaxSamplingParams(max_tokens=6))


def test_deepseek_int8_engine_greedy_tokens_match_jax(jax_run):
    numpy_params, jax_tokens = jax_run
    cfg = DeepseekV2Config(**DIMS, dtype=torch.float32)
    engine = LLMEngine(
        deepseek_params_from_jax(numpy_params, cfg, device="cpu"), cfg, EngineConfig(**ENGINE),
        prefill_fn=deepseek_prefill, decode_fn=deepseek_decode_step, device="cpu",
    )
    layers = engine.params["layers_dense"]
    assert {"wq_kva", "w_gateup"} <= set(layers)  # fused, as in JAX
    assert layers["wq_kva"].meta == {"bits": 8, "bias": 128, "group_size": 32, "layout": "planar"}
    assert engine.params["lm_head"].kind == "int8_grouped"
    before = mixed_gemm_planar_launcher.launches
    out = engine.generate(_prompts(), SamplingParams(max_tokens=6))
    assert mixed_gemm_planar_launcher.launches == before  # the plain version on the CPU: no launch
    assert [len(o) for o in out] == [6, 6]
    assert out == jax_tokens
