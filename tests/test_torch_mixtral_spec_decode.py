# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Mixtral's speculative engine (``verify_fn=mixtral_verify_forward``)
against greedy decoding without speculation, the JAX package's and the
port's.

JAX's own Mixtral cannot serve speculation: its verify step gives NaN
logits whenever the step has padding rows (ROADMAP Queue 3, PR 22), and
verify steps pad to ``_bucket(total)`` rows. So the port's speculative
tokens are held against JAX's plain engine, on steps without padding rows:
tests/moe_test.py's tiny Mixtral (2 layers, hidden 64, 4 experts, top 2;
f32 here) carried across, three prompts of 20, 12 and 14 tokens built from
repeated motifs (so that drafts fire) in 16-token prefill steps, the
multi-step greedy decode after them. The capacity factor is 2.0, where no
selection drops: which selections drop depends on a step's row count,
which speculation changes. The JAX engine compiles each new step shape in
interpret mode, so it runs once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from conch_tpu.models.moe import MoEConfig as JaxMoEConfig
from conch_tpu.models.moe import init_moe_params as jax_init_params
from conch_tpu.models.moe import mixtral_decode_step as jax_decode_step
from conch_tpu.models.moe import mixtral_prefill as jax_prefill
from conch_tpu.serving import EngineConfig as JaxEngineConfig
from conch_tpu.serving import LLMEngine as JaxLLMEngine
from conch_tpu.serving import SamplingParams as JaxSamplingParams
from conch_tpu_torch.models.llama import LlamaConfig
from conch_tpu_torch.models.moe import (
    MoEConfig,
    mixtral_decode_step,
    mixtral_prefill,
    mixtral_verify_forward,
    moe_params_from_jax,
)
from conch_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

DIMS = {"vocab_size": 64, "hidden_size": 64, "intermediate_size": 128, "num_layers": 2, "num_heads": 2,
        "num_kv_heads": 1, "head_dim": 32, "max_position": 128}
MOE = {"num_experts": 4, "top_k": 2, "capacity_factor": 2.0}
ENGINE = {"page_size": 8, "num_pages": 64, "max_batch_size": 4, "max_pages_per_seq": 8, "max_prefill_tokens": 16,
          "multi_step_decode": 4}
MAX_TOKENS = 12


def _prompts():
    # Prefill steps: [r0 16], [r0 4, r1 12], [r0 decode 1, r1 decode 1, r2 14]: 16 tokens each.
    rng = np.random.default_rng(23)
    motifs = [rng.integers(0, DIMS["vocab_size"], n).tolist() for n in (4, 3, 7)]
    return [(m * 7)[:n] for m, n in zip(motifs, (20, 12, 14))]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX plain engine's tokens and its params (numpy)."""
    cfg = JaxMoEConfig(llama=JaxLlamaConfig(**DIMS, dtype=jnp.float32), **MOE)
    numpy_params = jax.tree.map(np.asarray, jax_init_params(0, cfg))
    engine = JaxLLMEngine(
        jax.tree.map(jnp.asarray, numpy_params), cfg, JaxEngineConfig(**ENGINE),
        prefill_fn=jax_prefill, decode_fn=jax_decode_step,
    )
    return numpy_params, engine.generate(_prompts(), JaxSamplingParams(max_tokens=MAX_TOKENS))


def _port_engine(numpy_params, **over) -> LLMEngine:
    cfg = MoEConfig(llama=LlamaConfig(**DIMS, dtype=torch.float32), **MOE)
    return LLMEngine(
        moe_params_from_jax(numpy_params, cfg, device="cpu"), cfg, EngineConfig(**ENGINE, **over),
        prefill_fn=mixtral_prefill, decode_fn=mixtral_decode_step, device="cpu",
        verify_fn=mixtral_verify_forward,
    )


def test_mixtral_spec_engine_gives_plain_greedy_tokens(jax_run):
    numpy_params, jax_tokens = jax_run
    plain = _port_engine(numpy_params).generate(_prompts(), SamplingParams(max_tokens=MAX_TOKENS))
    assert plain == jax_tokens
    spec = _port_engine(numpy_params, num_speculative_tokens=3)
    verify_rows = []
    verify = spec._verify_fn

    def counted(*args, **kwargs):
        out = verify(*args, **kwargs)
        verify_rows.append((int(kwargs["cu_seqlens_q"][-1]), kwargs["token_ids"].shape[0]))
        assert torch.isfinite(out[0]).all()  # padding rows included
        return out

    spec._verify_fn = counted
    assert spec.generate(_prompts(), SamplingParams(max_tokens=MAX_TOKENS)) == jax_tokens
    assert spec.spec_tokens_drafted > 0 and spec.spec_tokens_accepted > 0
    assert any(live < rows for live, rows in verify_rows)  # verify steps with padding rows


def test_mixtral_attention_lora_equals_merged_model(jax_run):
    """Mixtral's attention takes LoRA through Llama's shared layers: one
    adapter on wq / wk / wv / wo served to every token equals the adapter
    merged into the weights; an adapter on the experts' projections raises."""
    from conch_tpu_torch.models.lora import init_lora_adapter, merge_lora_into_params, stack_lora_adapters

    numpy_params, _ = jax_run
    cfg = MoEConfig(llama=LlamaConfig(**DIMS, dtype=torch.float32), **MOE)
    params = moe_params_from_jax(numpy_params, cfg, device="cpu")
    adapter = init_lora_adapter(5, cfg.llama, rank=4, dtype=torch.float32, device="cpu")
    prompts = _prompts()[:2]
    sampling = SamplingParams(max_tokens=MAX_TOKENS)
    fns = {"prefill_fn": mixtral_prefill, "decode_fn": mixtral_decode_step}
    merged = LLMEngine(merge_lora_into_params(params, adapter), cfg, EngineConfig(**ENGINE), device="cpu", **fns)
    served = LLMEngine(params, cfg, EngineConfig(**ENGINE), device="cpu", lora=stack_lora_adapters([adapter]), **fns)
    base = LLMEngine(params, cfg, EngineConfig(**ENGINE), device="cpu", **fns).generate(prompts, sampling)
    want = merged.generate(prompts, sampling)
    assert served.generate(prompts, sampling, lora_ids=[0, 0]) == want != base
    bad = stack_lora_adapters([init_lora_adapter(5, cfg.llama, targets=("w_down",), dtype=torch.float32,
                                                 device="cpu")])
    engine = LLMEngine(params, cfg, EngineConfig(**ENGINE), device="cpu", lora=bad, **fns)
    with pytest.raises(ValueError, match="experts"):
        engine.generate(prompts, sampling, lora_ids=[0, None])
