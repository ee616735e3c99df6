# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""The slice end to end: the port's LLMEngine against the JAX package's.

One set of JAX params (``conch_tpu.models.llama.init_llama_params``,
3 layers, hidden 256, 4 query heads / 1 KV head, head_dim 128, f32) is
carried over with ``params_from_jax``; both engines serve the same
prompts greedily and must give identical tokens. The prompts exercise
chunked prefill (a 200-token prompt over 128-token steps), mixed batching
(the 20-token request decodes inside the long prompt's second prefill
step), the multi-step greedy decode with overshoot, and a prefix-cache
hit (a later request reuses 3 cached pages of the long prompt).

The JAX engine runs its Pallas kernels in interpret mode, where each new
step shape costs tens of seconds of compilation, so it runs once per
module, and the prompts are sized so that every prefill step, in both
``generate`` calls, has the same shape (128 rows, longest chunk > 64).
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
from conch_tpu_torch.models.llama import LlamaConfig, init_llama_params, params_from_jax
from conch_tpu_torch.models.lora import init_lora_adapter, stack_lora_adapters
from conch_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams
from conch_tpu_torch.serving.guided import TokenFSM
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

DIMS = {
    "vocab_size": 256, "hidden_size": 256, "intermediate_size": 512, "num_layers": 3,
    "num_heads": 4, "num_kv_heads": 1, "head_dim": 128,
}
# max_pages_per_seq: what the requests need (the default is 64); the JAX
# engine's interpret-mode compile grows with the block table's width.
ENGINE = {
    "page_size": 16, "num_pages": 64, "max_batch_size": 4, "max_prefill_tokens": 128, "max_pages_per_seq": 16,
}


def _prompts():
    rng = np.random.default_rng(0)
    long_prompt = rng.integers(0, 256, 200).tolist()
    first = [rng.integers(0, 256, 20).tolist(), long_prompt]
    # Second call: 48 tokens (3 pages) of the long prompt come from the
    # prefix cache, leaving 70 + 20 tokens: the first call's step shape.
    second = [rng.integers(0, 256, 20).tolist(), long_prompt[:48] + rng.integers(0, 256, 70).tolist()]
    return first, second


@pytest.fixture(scope="module")
def jax_run():
    """The JAX engine's outputs, params (as numpy) and prefix-cache hits."""
    cfg = JaxLlamaConfig(**DIMS, dtype=jnp.float32)
    params = jax_init_llama_params(0, cfg)
    engine = JaxLLMEngine(params, cfg, JaxEngineConfig(**ENGINE))
    first, second = _prompts()
    out1 = engine.generate(first, JaxSamplingParams(max_tokens=10))
    out2 = engine.generate(second, JaxSamplingParams(max_tokens=6))
    numpy_params = jax.tree.map(np.asarray, params)
    return numpy_params, out1, out2, engine.prefix_cache_hits


def _port_engine(numpy_params, **engine_overrides) -> LLMEngine:
    cfg = LlamaConfig(**DIMS, dtype=torch.float32)
    params = params_from_jax(numpy_params, cfg, device="cpu")
    return LLMEngine(params, cfg, EngineConfig(**{**ENGINE, **engine_overrides}), device="cpu")


def test_greedy_tokens_match_jax_engine(jax_run):
    numpy_params, jax_out1, jax_out2, jax_hits = jax_run
    engine = _port_engine(numpy_params)
    first, second = _prompts()
    out1 = engine.generate(first, SamplingParams(max_tokens=10))
    out2 = engine.generate(second, SamplingParams(max_tokens=6))
    assert out1 == jax_out1
    assert out2 == jax_out2
    assert engine.prefix_cache_hits == jax_hits == 48


def test_preemption_recompute_keeps_greedy_tokens(jax_run):
    """A pool too small for both requests to grow forces preemption and
    recompute; greedy outputs must equal an unpressured run's (whose first
    10 tokens are the JAX engine's)."""
    numpy_params, jax_out1, _, _ = jax_run
    first, _ = _prompts()
    sampling = SamplingParams(max_tokens=40)
    expected = _port_engine(numpy_params).generate(first, sampling)
    assert [o[:10] for o in expected] == jax_out1
    engine = _port_engine(numpy_params, num_pages=15, enable_prefix_caching=False)
    preempted = []
    preempt = engine._preempt_one
    engine._preempt_one = lambda: preempted.append(1) or preempt()
    out = engine.generate(first, sampling)
    assert preempted
    assert out == expected
    assert engine.allocator.num_free == 15


def test_stop_tokens_and_eos_finish_requests(jax_run):
    numpy_params, jax_out1, _, _ = jax_run
    first, _ = _prompts()
    stop = jax_out1[1][3]
    engine = _port_engine(numpy_params)
    out = engine.generate(first[1:], SamplingParams(max_tokens=10, stop_token_ids=(stop,)))
    assert out[0] == jax_out1[1][: jax_out1[1].index(stop) + 1]
    engine = _port_engine(numpy_params, eos_token_id=stop, multi_step_decode=1)
    out = engine.generate(first[1:], SamplingParams(max_tokens=10, min_tokens=5))
    assert stop not in out[0][:5]
    assert out[0][-1] == stop or len(out[0]) == 10


def test_sampling_is_seeded_and_unported_options_raise():
    cfg = LlamaConfig(**DIMS, dtype=torch.float32)
    params = init_llama_params(1, cfg, device="cpu")
    prompts = [list(range(30)), list(range(5, 40))]
    sampling = SamplingParams(max_tokens=6, temperature=0.9, top_k=20, top_p=0.9)
    runs = [LLMEngine(params, cfg, EngineConfig(**ENGINE), device="cpu").generate(prompts, sampling) for _ in range(2)]
    assert runs[0] == runs[1]
    assert all(0 <= t < DIMS["vocab_size"] for out in runs[0] for t in out)
    # Parallel sampling, logprobs, the logit rules, speculative decoding and
    # LoRA, once refused, are served (tests/test_torch_{parallel_sampling,
    # logit_rules,spec_decode,lora}.py hold them against the JAX engine).
    for kwargs in ({"n": 2}, {"logprobs": True}, {"repetition_penalty": 1.2}, {"logit_bias": ((1, 1.0),)}):
        out = LLMEngine(params, cfg, EngineConfig(**ENGINE), device="cpu").generate(
            prompts, SamplingParams(max_tokens=3, **kwargs))
        assert len(out) == 2 and all(len(o) == (2 if "n" in kwargs else 3) for o in out)
    spec = LLMEngine(params, cfg, EngineConfig(**ENGINE, num_speculative_tokens=2), device="cpu")
    assert spec.generate(prompts, SamplingParams(max_tokens=6)) == LLMEngine(
        params, cfg, EngineConfig(**ENGINE), device="cpu").generate(prompts, SamplingParams(max_tokens=6))
    lora = stack_lora_adapters([init_lora_adapter(0, cfg, dtype=torch.float32, device="cpu")])
    assert LLMEngine(params, cfg, EngineConfig(**ENGINE), device="cpu", lora=lora).generate(
        prompts, SamplingParams(max_tokens=2), lora_ids=[0, None])
    # Rolling KV is ported: the engine refuses it for a model without a window.
    with pytest.raises(ValueError, match="sliding_window"):
        LLMEngine(params, cfg, EngineConfig(**ENGINE, rolling_kv=True, enable_prefix_caching=False), device="cpu")
    # Guided decoding is served (tests/test_torch_guided.py holds it against
    # the JAX engine): a one-token FSM over the model's vocabulary, then EOS.
    fsm = TokenFSM.from_regex("a", [chr(i) if 97 <= i <= 122 else "" for i in range(DIMS["vocab_size"])])
    guided = LLMEngine(params, cfg, EngineConfig(**ENGINE, eos_token_id=0), device="cpu").generate(
        prompts, SamplingParams(max_tokens=6, guided=fsm))
    assert guided == [[97, 0], [97, 0]]
    # Tensor-parallel meshes (item 8) still raise.
    with pytest.raises(NotImplementedError, match="mesh"):
        LLMEngine(params, cfg, EngineConfig(**ENGINE), device="cpu", mesh=object())
