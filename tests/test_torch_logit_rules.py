# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""The logit rules, logprobs, ``stats`` and ``abort_request`` of the port's
engine against the JAX package's.

- ``_apply_logit_rules`` on the same logits equals JAX's bit for bit: the
  repetition penalty of tests/engine_test.py:391 (positive logits divided,
  the others multiplied, over the prompt and output tokens), the logit
  bias (a token listed twice adds twice) and ``min_tokens`` (eos and the
  stop tokens at -inf), in JAX's order.
- One JAX engine on tests/engine_test.py's ``tiny_model`` (carried across
  with ``params_from_jax``) serves, in one batch, the repetition-penalty
  request of :413 beside an unpenalized one, a greedy request with
  logprobs (:431) and one with a logit bias; the port's tokens must equal
  JAX's, its logprobs JAX's within 1e-4 (f32), and ``stats()`` JAX's,
  key for key and value for value.
- ``abort_request`` as :451: the victim's pages return at once, a second
  abort returns False, the other request's tokens are unchanged; aborting
  a waiting request, and pages the prefix cache holds survive an abort.
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
from conch_tpu.serving.engine import Request as JaxRequest
from conch_tpu_torch.models.llama import LlamaConfig, init_llama_params, params_from_jax
from conch_tpu_torch.serving import EngineConfig, LLMEngine, Request, SamplingParams
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

DIMS = {"vocab_size": 128, "hidden_size": 128, "intermediate_size": 256, "num_layers": 2, "num_heads": 4,
        "num_kv_heads": 2, "head_dim": 32, "max_position": 512}
ENGINE = {"page_size": 16, "num_pages": 64, "max_batch_size": 4, "max_pages_per_seq": 8, "max_prefill_tokens": 64}
PROMPTS = [[1, 5, 9, 23, 40], [7, 8, 9], [1, 5, 9, 23, 40], [2, 4, 6, 8, 10, 12]]
# (sampling fields, the same for both packages): the :413 pair, :431's logprobs, a logit bias.
REQUESTS = [
    {"max_tokens": 6, "repetition_penalty": 1.5},
    {"max_tokens": 6},
    {"max_tokens": 5, "logprobs": True},
    {"max_tokens": 6, "logit_bias": ((3, 2.5), (3, 1.0), (17, -0.5)), "logprobs": True},
]


def _serve(engine, sampling_cls) -> tuple[list, list, dict]:
    ids = [engine.add_request(p, sampling_cls(**kw)) for p, kw in zip(PROMPTS, REQUESTS)]
    done = {}
    while engine.waiting or engine.running:
        for r in engine.step():
            done[r.request_id] = r
    return [done[i].output_tokens for i in ids], [done[i].output_logprobs for i in ids], engine.stats()


@pytest.fixture(scope="module")
def jax_run():
    cfg = JaxLlamaConfig(**DIMS, dtype=jnp.float32)
    params = jax_init_llama_params(0, cfg, "bf16")
    return jax.tree.map(np.asarray, params), *_serve(JaxLLMEngine(params, cfg, JaxEngineConfig(**ENGINE)),
                                                     JaxSamplingParams)


def _port_engine(numpy_params, **over) -> LLMEngine:
    cfg = LlamaConfig(**DIMS, dtype=torch.float32)
    return LLMEngine(params_from_jax(numpy_params, cfg, device="cpu"), cfg, EngineConfig(**{**ENGINE, **over}),
                     device="cpu")


def test_apply_logit_rules_matches_jax():
    small = {"vocab_size": 16, "hidden_size": 32, "intermediate_size": 64, "num_layers": 1, "num_heads": 2,
             "num_kv_heads": 1, "head_dim": 16, "max_position": 64}
    jax_cfg = JaxLlamaConfig(**small, dtype=jnp.float32)
    jax_engine = JaxLLMEngine(jax_init_llama_params(0, jax_cfg, "bf16"), jax_cfg,
                              JaxEngineConfig(page_size=16, num_pages=8, eos_token_id=11))
    cfg = LlamaConfig(**small, dtype=torch.float32)
    engine = LLMEngine(init_llama_params(0, cfg, device="cpu"), cfg,
                       EngineConfig(page_size=16, num_pages=8, eos_token_id=11), device="cpu")
    rules = [  # (prompt, outputs, sampling fields)
        ([2, 3], [5], {"repetition_penalty": 2.0}),  # tests/engine_test.py:391
        ([4, 11], [9, 9], {"repetition_penalty": 0.7, "logit_bias": ((9, 1.5), (9, 0.25), (0, -3.0))}),
        ([6], [], {"min_tokens": 2, "stop_token_ids": (1, 5), "repetition_penalty": 1.3, "logit_bias": ((5, 9.0),)}),
        ([7], [2], {}),  # no rule
    ]
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(5, 16)).astype(np.float32)
    logits[0] = np.linspace(-1.0, 1.0, 16, dtype=np.float32)
    rows = [0, 2, 3, 4]  # row 1: no request
    jax_reqs, reqs = [], []
    for i, (prompt, outputs, kw) in enumerate(rules):
        jr = JaxRequest(i, prompt=prompt, sampling=JaxSamplingParams(**kw))
        jr.output_tokens = list(outputs)
        r = Request(i, prompt=prompt, sampling=SamplingParams(**kw))
        r.output_tokens = list(outputs)
        jax_reqs.append(jr)
        reqs.append(r)
    ref = np.asarray(jax_engine._apply_logit_rules(jnp.asarray(logits), jax_reqs, rows=rows))
    ours = engine._apply_logit_rules(torch.from_numpy(logits), reqs, rows=rows).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert np.isneginf(ours[3, [1, 5, 11]]).all() and (ours[[1, 4]] == logits[[1, 4]]).all()
    base = np.linspace(-1.0, 1.0, 16, dtype=np.float32)
    for tok in (2, 3, 5):  # tests/engine_test.py:391's expectation
        assert ours[0, tok] == (base[tok] / np.float32(2.0) if base[tok] > 0 else base[tok] * np.float32(2.0))


def test_rule_tokens_and_logprobs_match_jax(jax_run):
    numpy_params, jax_tokens, jax_logprobs, _ = jax_run
    tokens, logprobs, _ = _serve(_port_engine(numpy_params), SamplingParams)
    assert tokens == jax_tokens
    plain = _port_engine(numpy_params).generate([PROMPTS[1], PROMPTS[0]], SamplingParams(max_tokens=6))
    assert tokens[1] == plain[0] and tokens[0] != plain[1]  # the penalty bites, its neighbour is unchanged
    assert [len(lp) for lp in logprobs] == [0, 0, 5, 6]
    for ours, ref in zip(logprobs, jax_logprobs):
        np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)
    assert all(-30.0 < lp <= 0.0 for lp in logprobs[2])
    assert tokens[2] == plain[1][:5]  # logprobs only observe
    assert 3 in tokens[3]  # the summed bias of 3.5 on token 3


def test_stats_match_jax(jax_run):
    numpy_params, _, _, jax_stats = jax_run
    engine = _port_engine(numpy_params)
    _, _, stats = _serve(engine, SamplingParams)
    assert stats == jax_stats
    assert list(stats) == ["running", "waiting", "free_pages", "total_pages", "cached_prefix_pages",
                           "prefix_cache_hit_tokens", "spec_tokens_drafted", "spec_tokens_accepted"]


def test_abort_request(jax_run):
    """tests/engine_test.py:451, then a waiting request and a cached prefix."""
    numpy_params = jax_run[0]
    solo = _port_engine(numpy_params, enable_prefix_caching=False).generate([[9, 8, 7]], SamplingParams(max_tokens=6))
    engine = _port_engine(numpy_params, enable_prefix_caching=False)
    free0 = engine.allocator.num_free
    victim = engine.add_request([1, 2, 3, 4, 5], SamplingParams(max_tokens=6))
    keeper = engine.add_request([9, 8, 7], SamplingParams(max_tokens=6))
    engine.step()  # prefill both
    held = engine.allocator.num_free
    assert engine.abort_request(victim)
    assert engine.allocator.num_free == held + 1  # its one page, at once
    assert not engine.abort_request(victim)
    done = {}
    while engine.waiting or engine.running:
        for r in engine.step():
            done[r.request_id] = r.output_tokens
    assert victim not in done and [done[keeper]] == solo
    assert engine.allocator.num_free == free0

    engine = _port_engine(numpy_params, max_batch_size=1)
    first = engine.add_request(list(range(40)), SamplingParams(max_tokens=4))
    waiting = engine.add_request([3, 3, 3], SamplingParams(max_tokens=4))
    engine.step()
    assert engine.stats()["waiting"] == 1 and engine.abort_request(waiting) and not engine.waiting
    assert engine.abort_request(first) and not engine.running
    # The two full prompt pages stay in the prefix cache; every other page is free.
    assert engine.stats()["cached_prefix_pages"] == 2 and engine.allocator.num_free == ENGINE["num_pages"] - 2
    assert engine.generate([list(range(40))], SamplingParams(max_tokens=2)) and engine.prefix_cache_hits == 32
