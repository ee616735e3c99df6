# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Prompt-lookup speculative decoding through the port's engine, against
the JAX package's engine and against the port's own plain greedy engine.

The Llama model is tests/engine_test.py's ``tiny_model`` (2 layers, hidden
128, 4 query heads / 2 KV heads of 32, bf16 weights, f32 activations),
carried across with ``params_from_jax``. One JAX engine with
``num_speculative_tokens=4`` serves the cases of tests/engine_test.py:290
(repetitive prompts, so that drafts fire) and :307 (short motif prompts):
the port's speculative tokens must equal JAX's and the port's plain
engine's, and its ``spec_tokens_drafted`` / ``spec_tokens_accepted``
must equal JAX's exactly (drafting is deterministic). The preemption case
of :307 (a 7-page pool of 4-token pages) is held against the port's roomy
plain engine, as the JAX test holds it.

Gemma-2, DeepSeek-V2 and Mixtral speculative engines (their verify steps)
must give their plain engines' greedy tokens; DeepSeek and Mixtral at a
capacity factor where no selection drops, since a dropped selection
depends on the step's row count, which speculation changes. Rolling KV
(a Mistral-style window on every layer) caps each draft at the draft
limit, not the page cap. Mixtral's engine is also held against JAX's
plain engine in tests/test_torch_mixtral_spec_decode.py.
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
from conch_tpu_torch.models.deepseek import (
    DeepseekV2Config,
    deepseek_decode_step,
    deepseek_prefill,
    deepseek_verify_forward,
    init_deepseek_params,
)
from conch_tpu_torch.models.gemma import GemmaConfig, gemma_decode_step, gemma_prefill, gemma_verify_forward
from conch_tpu_torch.models.gemma import init_gemma_params
from conch_tpu_torch.models.llama import LlamaConfig, init_llama_params, params_from_jax
from conch_tpu_torch.models.moe import (
    MoEConfig,
    init_moe_params,
    mixtral_decode_step,
    mixtral_prefill,
    mixtral_verify_forward,
)
from conch_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

DIMS = {"vocab_size": 128, "hidden_size": 128, "intermediate_size": 256, "num_layers": 2, "num_heads": 4,
        "num_kv_heads": 2, "head_dim": 32, "max_position": 512}
ENGINE = {"page_size": 16, "num_pages": 64, "max_batch_size": 4, "max_pages_per_seq": 8, "max_prefill_tokens": 64}
SPEC = {"num_speculative_tokens": 4}


def _prompts():
    """tests/engine_test.py:290's prompts (a 6-token motif repeated) and
    :307's (short motifs)."""
    rng = np.random.default_rng(21)
    motif = rng.integers(0, 127, size=6).tolist()
    first = [motif * 4, motif * 3 + [7], rng.integers(0, 127, size=10).tolist()]
    return first, [[3, 1, 4, 1] * 2, [3, 1, 4, 1] * 2 + [9]]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX spec engine's tokens and counters on both prompt sets, and
    its params (numpy)."""
    cfg = JaxLlamaConfig(**DIMS, dtype=jnp.float32)
    params = jax_init_llama_params(0, cfg, "bf16")
    engine = JaxLLMEngine(params, cfg, JaxEngineConfig(**ENGINE, **SPEC))
    first, second = _prompts()
    out1 = engine.generate(first, JaxSamplingParams(max_tokens=12))
    counts = (engine.spec_tokens_drafted, engine.spec_tokens_accepted)
    out2 = engine.generate(second, JaxSamplingParams(max_tokens=10))
    return jax.tree.map(np.asarray, params), out1, counts, out2


def _port_engine(numpy_params, **over) -> LLMEngine:
    cfg = LlamaConfig(**DIMS, dtype=torch.float32)
    return LLMEngine(params_from_jax(numpy_params, cfg, device="cpu"), cfg, EngineConfig(**{**ENGINE, **over}),
                     device="cpu")


def test_spec_tokens_and_counters_match_jax_and_plain(jax_run):
    numpy_params, jax_out1, jax_counts, jax_out2 = jax_run
    first, second = _prompts()
    spec = _port_engine(numpy_params, **SPEC)
    out1 = spec.generate(first, SamplingParams(max_tokens=12))
    assert out1 == jax_out1
    assert (spec.spec_tokens_drafted, spec.spec_tokens_accepted) == jax_counts
    assert jax_counts[0] > 0 and jax_counts[1] > 0
    assert spec.stats()["spec_tokens_drafted"] == jax_counts[0]
    assert spec.generate(second, SamplingParams(max_tokens=10)) == jax_out2
    plain = _port_engine(numpy_params)
    assert plain.generate(first, SamplingParams(max_tokens=12)) == jax_out1
    assert plain.spec_tokens_drafted == 0


def test_spec_with_preemption_matches_roomy_plain(jax_run):
    """tests/engine_test.py:307: speculation under page starvation."""
    numpy_params, _, _, jax_out2 = jax_run
    _, second = _prompts()
    tight = _port_engine(numpy_params, page_size=4, num_pages=7, max_batch_size=2, num_speculative_tokens=3)
    preempted = []
    preempt = tight._preempt_one
    tight._preempt_one = lambda: preempted.append(1) or preempt()
    outs = tight.generate(second, SamplingParams(max_tokens=10))
    roomy = _port_engine(numpy_params, page_size=4, max_batch_size=2)
    assert preempted and outs == roomy.generate(second, SamplingParams(max_tokens=10)) == jax_out2
    assert tight.allocator.num_free + len(tight._cached_lru) == 7


def test_custom_decode_fn_needs_a_verify_fn():
    cfg = LlamaConfig(**DIMS, dtype=torch.float32)
    params = init_llama_params(0, cfg, device="cpu")
    with pytest.raises(ValueError, match="verify_fn"):
        LLMEngine(params, cfg, EngineConfig(**ENGINE, **SPEC), decode_fn=gemma_decode_step, device="cpu")


def _motif_prompts(vocab: int, seed: int) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    motif = rng.integers(0, vocab, 7).tolist()
    return [motif * 5, motif * 3 + [1, 2], rng.integers(0, vocab, 13).tolist()]


def _spec_equals_plain(params, cfg, fns: dict, max_tokens: int = 12, **engine) -> None:
    prompts = _motif_prompts(cfg.vocab_size if hasattr(cfg, "vocab_size") else cfg.llama.vocab_size, 3)
    sampling = SamplingParams(max_tokens=max_tokens)
    ecfg = {**ENGINE, **engine}
    plain = LLMEngine(params, cfg, EngineConfig(**ecfg), device="cpu",
                      **{k: v for k, v in fns.items() if k != "verify_fn"}).generate(prompts, sampling)
    spec = LLMEngine(params, cfg, EngineConfig(**ecfg, **SPEC), device="cpu", **fns)
    assert spec.generate(prompts, sampling) == plain
    assert spec.spec_tokens_drafted > 0 and spec.spec_tokens_accepted > 0


def test_gemma_spec_engine_gives_plain_tokens():
    cfg = GemmaConfig(vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=4,
                      num_kv_heads=2, head_dim=64, max_position=512, attn_logit_softcap=50.0,
                      final_logit_softcap=30.0, gemma2=True, sliding_window=24, query_pre_attn_scalar=64.0,
                      dtype=torch.float32)
    fns = {"prefill_fn": gemma_prefill, "decode_fn": gemma_decode_step, "verify_fn": gemma_verify_forward}
    _spec_equals_plain(init_gemma_params(0, cfg, device="cpu"), cfg, fns)


def test_deepseek_spec_engine_gives_plain_tokens():
    cfg = DeepseekV2Config(vocab_size=128, hidden_size=64, num_layers=3, num_heads=4, kv_lora_rank=32,
                           qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32, n_routed_experts=4,
                           n_shared_experts=1, num_experts_per_tok=2, moe_intermediate_size=32, intermediate_size=64,
                           first_k_dense_replace=1, moe_capacity_factor=2.0, dtype=torch.float32)
    fns = {"prefill_fn": deepseek_prefill, "decode_fn": deepseek_decode_step, "verify_fn": deepseek_verify_forward}
    _spec_equals_plain(init_deepseek_params(0, cfg, device="cpu"), cfg, fns)


def test_mixtral_spec_engine_gives_plain_tokens():
    cfg = MoEConfig(llama=LlamaConfig(**DIMS, dtype=torch.float32), num_experts=4, top_k=2, capacity_factor=2.0)
    fns = {"prefill_fn": mixtral_prefill, "decode_fn": mixtral_decode_step, "verify_fn": mixtral_verify_forward}
    _spec_equals_plain(init_moe_params(0, cfg, device="cpu"), cfg, fns)


def test_rolling_kv_spec_engine_gives_plain_tokens():
    """A 32-token window on every layer: rolling KV rings of
    ceil((32 + 64) / 16) + 1 = 7 pages; prompts and outputs pass the ring."""
    cfg = LlamaConfig(**DIMS, sliding_window=32, dtype=torch.float32)
    params = init_llama_params(0, cfg, device="cpu")
    rolling = {"rolling_kv": True, "enable_prefix_caching": False}
    _spec_equals_plain(params, cfg, {}, max_tokens=80, **rolling)
    prompt = list(range(1, 9)) * 15 + [1, 2, 3, 4, 5]  # 125 tokens; "4, 5" last matched at 115
    drafts = []
    for over in (rolling, {}):
        spec = LLMEngine(params, cfg, EngineConfig(**ENGINE, **SPEC, **over), device="cpu")
        spec.add_request(prompt, SamplingParams(max_tokens=200))
        drafts.append(spec._draft(spec.waiting[0]))
    assert spec._page_cap == 8
    # The ring (7 pages, 112 tokens) wraps: only the draft limit caps it;
    # without a ring, 128 - 125 - 1 = 2 slots are left under the page cap.
    assert drafts == [[6, 7, 8, 1], [6, 7]]
