# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Parallel sampling (``SamplingParams(n > 1)``) in the port's engine: the
cases of tests/parallel_sampling_test.py, against the JAX package's engine
where they are greedy.

The model is ``LlamaConfig.tiny`` (2 layers, hidden 256, 4 query heads / 2
KV heads of 64, bf16 weights, f32 activations), carried across with
``params_from_jax``. One JAX engine serves the greedy group of
tests/parallel_sampling_test.py:48 (prompts of 37 and 20 tokens, n 3);
the port's grouped output must equal it under the plain, multi-step and
speculative decode paths, every member equal to the n = 1 output, and
every page free afterwards. Then, on the port alone:

- stochastic siblings (temperature 1) diverge, replay exactly from the
  same seed, and each member's logprobs match the port's own prefill of
  that member's history within 2e-3 (the forked KV holds the right
  content on every path; :70);
- a full batch sends siblings back to recompute (:97), the prefix cache
  shares the forked pages (:112), rolling KV recomputes the group (:129),
  and aborting the parent aborts the group (:143);
- right after the spawn each full prompt page has refcount n, and each
  sibling's tail page equals the parent's in every layer, byte for byte,
  over bf16, int8 and e4m3 KV pools and DeepSeek's packed latent cache.
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
from conch_tpu_torch.models.deepseek import DeepseekV2Config, deepseek_decode_step, deepseek_prefill
from conch_tpu_torch.models.deepseek import init_deepseek_params
from conch_tpu_torch.models.llama import LlamaConfig, init_kv_caches, init_llama_params, llama_prefill
from conch_tpu_torch.models.llama import params_from_jax
from conch_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

ENGINE = {"page_size": 16, "num_pages": 96, "max_batch_size": 8, "max_pages_per_seq": 8, "max_prefill_tokens": 64,
          "enable_prefix_caching": False}


def _prompts(vocab: int) -> list[list[int]]:
    rng = np.random.default_rng(42)
    return [rng.integers(0, vocab, size=n).tolist() for n in (37, 20)]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX engine's greedy group outputs and its params (numpy)."""
    cfg = JaxLlamaConfig.tiny(dtype=jnp.float32)
    params = jax_init_llama_params(0, cfg)
    engine = JaxLLMEngine(params, cfg, JaxEngineConfig(**ENGINE))
    grouped = engine.generate(_prompts(cfg.vocab_size), JaxSamplingParams(max_tokens=12, n=3))
    return jax.tree.map(np.asarray, params), grouped


@pytest.fixture(scope="module")
def model(jax_run):
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    return cfg, params_from_jax(jax_run[0], cfg, device="cpu")


def _engine(model, **over) -> LLMEngine:
    cfg, params = model
    return LLMEngine(params, cfg, EngineConfig(**{**ENGINE, **over}), device="cpu")


@pytest.mark.parametrize("over", [{}, {"multi_step_decode": 3}, {"num_speculative_tokens": 3}],
                         ids=["plain", "multi_step", "spec"])
def test_greedy_n_matches_single_and_jax(jax_run, model, over):
    prompts = _prompts(model[0].vocab_size)
    single = _engine(model).generate(prompts, SamplingParams(max_tokens=12))
    engine = _engine(model, **over)
    grouped = engine.generate(prompts, SamplingParams(max_tokens=12, n=3))
    assert grouped == jax_run[1]
    for outs, ref in zip(grouped, single):
        assert outs == [ref] * 3
    assert engine.allocator.num_free == ENGINE["num_pages"]  # every forked reference released


def _run_group(model, seed: int, prompt: list[int]):
    engine = _engine(model, seed=seed)
    rid = engine.add_request(prompt, SamplingParams(max_tokens=8, n=4, temperature=1.0, logprobs=True))
    finished = []
    while engine.waiting or engine.running:
        finished.extend(engine.step())
    by_id = {r.request_id: r for r in finished}
    return [by_id[i] for i in (rid, *engine._group[rid])], engine


def test_stochastic_siblings_diverge_and_replay_exactly(model):
    cfg, params = model
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, size=30).tolist()
    group, engine = _run_group(model, 3, prompt)
    again, _ = _run_group(model, 3, prompt)
    outs = [r.output_tokens for r in group]
    assert outs == [r.output_tokens for r in again]
    assert [r.output_logprobs for r in group] == [r.output_logprobs for r in again]
    assert len({tuple(o) for o in outs}) > 1, "temperature-1 siblings all identical"
    assert engine.allocator.num_free == ENGINE["num_pages"]
    for r in group:  # each path's logprobs replay on a fresh prefill of its own history
        assert len(r.output_logprobs) == len(r.output_tokens) == 8
        hist = list(prompt)
        for tok, lp in zip(r.output_tokens, r.output_logprobs):
            t = len(hist)
            kc, vc = init_kv_caches(cfg, 4, 16, device="cpu")
            bt = torch.tensor([[0, 1, 2, 3]], dtype=torch.int32)
            logits, _, _ = llama_prefill(
                params, cfg, torch.tensor(hist, dtype=torch.int32), torch.arange(t, dtype=torch.int32),
                torch.tensor([0, t], dtype=torch.int32), 64, torch.tensor([t], dtype=torch.int32), bt,
                torch.arange(t, dtype=torch.int32), kc, vc,
            )
            np.testing.assert_allclose(lp, torch.log_softmax(logits[0], -1)[tok].item(), atol=2e-3, rtol=2e-3)
            hist.append(tok)


def test_batch_full_falls_back_to_recompute(model):
    prompt = np.random.default_rng(8).integers(0, model[0].vocab_size, size=25).tolist()
    single = _engine(model).generate([prompt], SamplingParams(max_tokens=10))[0]
    engine = _engine(model, max_batch_size=2)
    (outs,) = engine.generate([prompt], SamplingParams(max_tokens=10, n=4))
    assert outs == [single] * 4
    assert engine.allocator.num_free == ENGINE["num_pages"]


def test_parallel_sampling_with_prefix_caching(model):
    prompt = np.random.default_rng(9).integers(0, model[0].vocab_size, size=40).tolist()
    single = _engine(model).generate([prompt], SamplingParams(max_tokens=6))[0]
    engine = _engine(model, enable_prefix_caching=True)
    grouped = engine.generate([prompt, prompt], SamplingParams(max_tokens=6, n=2))
    assert grouped == [[single] * 2] * 2
    assert engine.generate([prompt], SamplingParams(max_tokens=6, n=3)) == [[single] * 3]
    assert engine.prefix_cache_hits == 32  # the second call's parent shares the cached pages, then forks them
    assert engine.allocator.num_free + len(engine._cached_lru) == ENGINE["num_pages"]


def test_rolling_kv_group_recomputes():
    cfg = LlamaConfig.tiny(sliding_window=48, dtype=torch.float32)
    params = init_llama_params(0, cfg, device="cpu")
    prompt = np.random.default_rng(10).integers(0, cfg.vocab_size, size=60).tolist()
    single = LLMEngine(params, cfg, EngineConfig(**ENGINE), device="cpu").generate(
        [prompt], SamplingParams(max_tokens=10))[0]
    engine = LLMEngine(params, cfg, EngineConfig(**{**ENGINE, "rolling_kv": True, "max_prefill_tokens": 32}),
                       device="cpu")
    copies = []
    engine._copy_page = lambda src, dst: copies.append((src, dst))
    (outs,) = engine.generate([prompt], SamplingParams(max_tokens=10, n=2))
    assert outs == [single, single] and not copies  # the sibling recomputed, nothing forked


def test_abort_parent_aborts_group(model):
    prompt = np.random.default_rng(11).integers(0, model[0].vocab_size, size=20).tolist()
    engine = _engine(model)
    rid = engine.add_request(prompt, SamplingParams(max_tokens=50, n=3))
    for _ in range(4):
        engine.step()
    assert len(engine.running) == 3  # the parent and 2 siblings decoding
    assert engine.abort_request(rid)
    assert not engine.running and not engine.waiting
    assert engine.allocator.num_free == ENGINE["num_pages"]


def _spawned(engine, prompt: list[int], n: int = 4):
    """The group right after the step that prefilled the parent and spawned it."""
    rid = engine.add_request(prompt, SamplingParams(max_tokens=4, n=n, temperature=0.8, top_p=0.95))
    engine.step()
    by_id = {r.request_id: r for r in engine.running}
    return by_id[rid], [by_id[i] for i in engine._group[rid]]


@pytest.mark.parametrize("cache", ["bf16", "int8", "fp8", "mla"])
def test_fork_shares_full_pages_and_copies_the_tail(model, cache):
    prompt = list(range(3, 43))  # 2 full pages and 8 tokens on the third
    if cache == "mla":
        cfg = DeepseekV2Config(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, kv_lora_rank=32,
                               qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32, n_routed_experts=4,
                               n_shared_experts=1, num_experts_per_tok=2, moe_intermediate_size=32,
                               intermediate_size=64, first_k_dense_replace=1, dtype=torch.bfloat16)
        engine = LLMEngine(init_deepseek_params(0, cfg, device="cpu"), cfg, EngineConfig(**ENGINE), device="cpu",
                           prefill_fn=deepseek_prefill, decode_fn=deepseek_decode_step)
    else:
        cfg = LlamaConfig.tiny(dtype=torch.bfloat16)
        dtype = {"bf16": None, "int8": torch.int8, "fp8": torch.float8_e4m3fn}[cache]
        engine = LLMEngine(init_llama_params(0, cfg, device="cpu"), cfg, EngineConfig(**ENGINE), device="cpu",
                           cache_dtype=dtype)
    parent, siblings = _spawned(engine, prompt)
    assert len(siblings) == 3
    for page in parent.pages[:2]:
        assert engine.allocator._refcount[page] == 4
    tail = parent.pages[2]
    for sib in siblings:
        assert sib.pages[:2] == parent.pages[:2] and sib.pages[2] != tail and sib.lora_id == parent.lora_id
        for cache_t in (engine.k_caches, engine.v_caches):
            if cache_t.numel():
                a, b = cache_t[:, sib.pages[2]], cache_t[:, tail]
                assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)) and a.float().abs().sum() > 0
    assert all(len(r.output_tokens) == 1 for r in (parent, *siblings))


def test_n_below_one_raises(model):
    with pytest.raises(ValueError, match="sampling.n"):
        _engine(model).add_request([1, 2, 3], SamplingParams(n=0))
