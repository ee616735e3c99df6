# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""DeepSeek-V2 through both engines: the port's LLMEngine with
``prefill_fn=deepseek_prefill, decode_fn=deepseek_decode_step`` against
the JAX package's, on the same params.

The tiny MoE model of tests/deepseek_test.py:30 (3 layers: 1 dense, 2
MoE of 4 experts, top 2, 1 shared; f32), carried across with
``deepseek_params_from_jax``, with the capacity factor cut to 0.5 so that
both engines drop tokens in every MoE layer of every step (capacity 8 of
the 32-row prefill steps' 64 selections, 1 of a 3-row decode step's 6).
Which tokens drop depends on the padded row count and the row order, so
the port must schedule exactly as the JAX engine does. Both engines serve
the same three prompts greedily and must give identical tokens: the
45-token prompt is chunk-prefilled over two steps, the first request then
decodes inside the third prefill step (mixed batching), which fills the
3-row batch and has one padding row (the JAX launcher's clamped gather
gives it a copy of the last sequence's first attention row, which the
router then sees), and the 4-step greedy decode runs to 10 tokens each.

The JAX engine runs its Pallas kernels in interpret mode, where each new
step shape costs tens of seconds of compilation, so it runs once per
module, and every prefill step has one shape (32 rows, longest chunk
above 16).
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
from conch_tpu_torch.models.deepseek import (
    DeepseekV2Config,
    deepseek_decode_step,
    deepseek_params_from_jax,
    deepseek_prefill,
    deepseek_verify_forward,
)
from conch_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

DIMS = {
    "vocab_size": 256, "hidden_size": 64, "num_layers": 3, "num_heads": 4, "kv_lora_rank": 32,
    "qk_rope_head_dim": 16, "qk_nope_head_dim": 32, "v_head_dim": 32, "n_routed_experts": 4,
    "n_shared_experts": 1, "num_experts_per_tok": 2, "moe_intermediate_size": 32, "intermediate_size": 64,
    "first_k_dense_replace": 1, "moe_capacity_factor": 0.5,
}
ENGINE = {
    "page_size": 16, "num_pages": 64, "max_batch_size": 3, "max_pages_per_seq": 8, "max_prefill_tokens": 32,
    "enable_prefix_caching": False, "multi_step_decode": 4,
}


def _prompts():
    # Prefill steps: [r0 32], [r0 13, r1 19], [r0 decode 1, r1 11, r2 19] = 31 of 32 rows.
    # With these prompts the padding row's routing changes which tokens
    # later steps drop: zeroing the padding rows' attention output changes
    # the served tokens.
    rng = np.random.default_rng(28)
    return [rng.integers(0, 256, n).tolist() for n in (45, 30, 19)]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX engine's tokens and its params (numpy)."""
    cfg = JaxDeepseekV2Config(**DIMS, dtype=jnp.float32)
    numpy_params = jax.tree.map(np.asarray, jax_init_params(0, cfg))
    engine = JaxLLMEngine(
        jax.tree.map(jnp.asarray, numpy_params), cfg, JaxEngineConfig(**ENGINE),
        prefill_fn=jax_prefill, decode_fn=jax_decode_step,
    )
    return numpy_params, engine.generate(_prompts(), JaxSamplingParams(max_tokens=10))


def _port_engine(numpy_params, **over) -> LLMEngine:
    cfg = DeepseekV2Config(**DIMS, dtype=torch.float32)
    params = deepseek_params_from_jax(numpy_params, cfg, device="cpu")
    return LLMEngine(
        params, cfg, EngineConfig(**ENGINE), prefill_fn=deepseek_prefill, decode_fn=deepseek_decode_step,
        device="cpu", **over,
    )


def test_deepseek_engine_greedy_tokens_match_jax(jax_run):
    numpy_params, jax_tokens = jax_run
    engine = _port_engine(numpy_params)
    for stack, fused in (("layers_dense", "w_gateup"), ("layers_moe", "shared_gateup")):
        assert {"wq_kva", fused} <= set(engine.params[stack])  # fused, as in JAX
    assert engine.k_caches.shape == (3, 64, 16, 128) and engine.v_caches.numel() == 0
    steps = []
    prefill = engine._prefill_fn

    def counted(*args, **kwargs):
        steps.append((int(kwargs["cu_seqlens_q"][-1]), kwargs["token_ids"].shape[0], kwargs["max_seqlen_q"]))
        return prefill(*args, **kwargs)

    engine._prefill_fn = counted
    out = engine.generate(_prompts(), SamplingParams(max_tokens=10))
    assert steps == [(32, 32, 32), (32, 32, 32), (31, 32, 32)]  # one step shape, a full batch padded
    assert [len(o) for o in out] == [10, 10, 10]
    assert out == jax_tokens


def test_deepseek_engine_refuses_speculative_decoding(jax_run):
    """Speculative decoding, once refused, is served: the speculative engine
    (``deepseek_verify_forward``) gives the plain engine's greedy tokens, at a
    capacity factor where no selection drops (which selections drop depends
    on a step's row count, which speculation changes)."""
    import dataclasses

    numpy_params, _ = jax_run
    plain = _port_engine(numpy_params)
    plain.config = dataclasses.replace(plain.config, moe_capacity_factor=2.0)
    spec = _port_engine(numpy_params, verify_fn=deepseek_verify_forward)
    spec.config, spec.ecfg = plain.config, dataclasses.replace(spec.ecfg, num_speculative_tokens=3)
    want = plain.generate(_prompts(), SamplingParams(max_tokens=10))
    assert spec.generate(_prompts(), SamplingParams(max_tokens=10)) == want
    assert spec.spec_tokens_drafted > 0
