# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Gemma-2 through both engines: the port's LLMEngine with
``prefill_fn=gemma_prefill, decode_fn=gemma_decode_step`` against the JAX
package's, on the same params.

Tiny Gemma-2 (2 layers, hidden 128, 4 query heads / 2 KV heads of 128,
softcaps 50 and 30, a 24-token window on layer 0, f32 activations, norm
weights drawn at random) is carried across with ``gemma_params_from_jax``.
Both engines serve the same prompts greedily and must give identical
tokens. The 100-token prompt is chunk-prefilled past the window, with the
20-token request decoding inside its second step (mixed batching), then
the multi-step greedy decode runs to 10 tokens each.

The JAX engine runs its Pallas kernels in interpret mode, where each new
step shape costs tens of seconds of compilation, so it runs once per
module, and both prefill steps have one shape (64 rows, longest chunk
above 32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.models.gemma import GemmaConfig as JaxGemmaConfig
from conch_tpu.models.gemma import gemma_decode_step as jax_gemma_decode_step
from conch_tpu.models.gemma import gemma_prefill as jax_gemma_prefill
from conch_tpu.models.gemma import init_gemma_params as jax_init_gemma_params
from conch_tpu.serving import EngineConfig as JaxEngineConfig
from conch_tpu.serving import LLMEngine as JaxLLMEngine
from conch_tpu.serving import SamplingParams as JaxSamplingParams
from conch_tpu_torch.models.gemma import (
    GemmaConfig,
    gemma_decode_step,
    gemma_params_from_jax,
    gemma_prefill,
    gemma_verify_forward,
)
from conch_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

DIMS = {
    "vocab_size": 128, "hidden_size": 128, "intermediate_size": 256, "num_layers": 2, "num_heads": 4,
    "num_kv_heads": 2, "head_dim": 128, "max_position": 512, "attn_logit_softcap": 50.0,
    "final_logit_softcap": 30.0, "gemma2": True, "sliding_window": 24, "query_pre_attn_scalar": 64.0,
}
ENGINE = {"page_size": 16, "num_pages": 64, "max_batch_size": 4, "max_pages_per_seq": 8, "max_prefill_tokens": 64}


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 128, 20).tolist(), rng.integers(0, 128, 100).tolist()]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX engine's tokens and its params (numpy, random norm weights)."""
    cfg = JaxGemmaConfig(**DIMS, dtype=jnp.float32)
    numpy_params = jax.tree.map(np.asarray, jax_init_gemma_params(0, cfg))
    rng = np.random.default_rng(1)
    layers = dict(numpy_params["layers"])
    for name in ("input_norm", "post_attn_norm", "pre_ff_norm", "post_ff_norm"):
        layers[name] = (0.3 * rng.normal(size=layers[name].shape)).astype(layers[name].dtype)
    numpy_params = {**numpy_params, "layers": layers}
    engine = JaxLLMEngine(
        jax.tree.map(jnp.asarray, numpy_params), cfg, JaxEngineConfig(**ENGINE),
        prefill_fn=jax_gemma_prefill, decode_fn=jax_gemma_decode_step,
    )
    return numpy_params, engine.generate(_prompts(), JaxSamplingParams(max_tokens=10))


def _port_engine(numpy_params) -> LLMEngine:
    cfg = GemmaConfig(**DIMS, dtype=torch.float32)
    params = gemma_params_from_jax(numpy_params, cfg, device="cpu")
    return LLMEngine(
        params, cfg, EngineConfig(**ENGINE), prefill_fn=gemma_prefill, decode_fn=gemma_decode_step, device="cpu"
    )


def test_gemma_engine_greedy_tokens_match_jax(jax_run):
    numpy_params, jax_tokens = jax_run
    engine = _port_engine(numpy_params)
    assert "wqkv" in engine.params["layers"] and "w_gateup" in engine.params["layers"]  # fused, as in JAX
    out = engine.generate(_prompts(), SamplingParams(max_tokens=10))
    assert [len(o) for o in out] == [10, 10]
    assert out == jax_tokens


def test_gemma_engine_refuses_speculative_decoding(jax_run):
    """Speculative decoding, once refused, is served: the speculative
    engine (``gemma_verify_forward``) gives the plain engines' greedy tokens."""
    numpy_params, jax_tokens = jax_run
    cfg = GemmaConfig(**DIMS, dtype=torch.float32)
    params = gemma_params_from_jax(numpy_params, cfg, device="cpu")
    engine = LLMEngine(
        params, cfg, EngineConfig(**ENGINE, num_speculative_tokens=3), prefill_fn=gemma_prefill,
        decode_fn=gemma_decode_step, verify_fn=gemma_verify_forward, device="cpu",
    )
    assert engine.generate(_prompts(), SamplingParams(max_tokens=10)) == jax_tokens
    assert engine.spec_tokens_drafted > 0
