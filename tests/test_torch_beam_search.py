# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Beam search in the port (``serving/beam_search.py``) against the JAX
package's.

- On tests/beam_search_test.py's tiny model (``LlamaConfig.tiny``, vocab
  64, carried across with ``params_from_jax``), one JAX engine runs JAX's
  ``beam_search`` on every case below, and the port's must return the same
  hypotheses: tokens exact, scores within 1e-3 (JAX's own test's
  tolerance). The cases: penalty 1.0 and 0.0 (tests/beam_search_test.py:92),
  an EOS that retires a hypothesis into the top set (:107), prompts of
  page - 1, page and page + 1 tokens (at page, no tail page is copied), a
  chunked 40-token prompt whose beams cross a page, and 4 beams.
- No page leaks; the four refusals (a busy engine, rolling KV, a width past
  ``max_batch_size``, a length past the page cap).
- The device sort's order equals ``np.argsort(-row, kind="stable")``'s,
  ties included.
- Gemma-2 (softcap, a window), DeepSeek (the packed latent cache's tail
  copy), Llama over an int8 KV pool, and the native allocator: each against
  an oracle that prefills every candidate prefix afresh through the port's
  prefill step and applies the same rule (tokens exact, scores within
  1e-3).
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
from conch_tpu.serving import beam_search as jax_beam_search
from conch_tpu_torch import native
from conch_tpu_torch.models.deepseek import DeepseekV2Config, deepseek_decode_step, deepseek_prefill
from conch_tpu_torch.models.deepseek import init_deepseek_params
from conch_tpu_torch.models.gemma import GemmaConfig, gemma_decode_step, gemma_prefill, init_gemma_params
from conch_tpu_torch.models.llama import LlamaConfig, init_llama_params, params_from_jax
from conch_tpu_torch.serving import BeamHypothesis, EngineConfig, LLMEngine, SamplingParams, beam_search
from conch_tpu_torch.serving.beam_search import _prefill_prompt, _ranked
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

ENGINE = {"page_size": 16, "num_pages": 96, "max_batch_size": 4, "max_pages_per_seq": 8, "max_prefill_tokens": 32,
          "enable_prefix_caching": False}
# (prompt length, width, max_tokens, length_penalty): tests/beam_search_test.py's
# two penalties, then the page boundaries (15 + 5 tokens crosses a page; 16:
# no tail page to copy; 17), a chunked prompt whose beams cross page 3.
CASES = [(22, 3, 5, 1.0), (22, 3, 5, 0.0), (15, 3, 6, 1.0), (16, 3, 6, 1.0), (17, 4, 6, 0.5), (40, 4, 12, 1.0)]
EOS_CASE = (15, 3, 6, 1.0)


def _prompt(n: int, vocab: int = 64, seed: int = 5) -> list[int]:
    return np.random.default_rng(seed + n).integers(0, vocab, size=n).tolist()


def _hyps(hyps) -> list[tuple[list[int], float]]:
    return [(list(map(int, h.tokens)), float(h.score)) for h in hyps]


@pytest.fixture(scope="module")
def jax_run():
    """JAX's hypotheses for CASES and for the EOS case, the EOS chosen as
    tests/beam_search_test.py:107 does (the first token of the eos-free
    run, by depth and rank, that retires a hypothesis into the top set)."""
    cfg = JaxLlamaConfig.tiny(vocab_size=64, dtype=jnp.float32)
    params = jax_init_llama_params(0, cfg)
    engine = JaxLLMEngine(params, cfg, JaxEngineConfig(**ENGINE))
    free0 = engine.allocator.num_free
    runs = {case: _hyps(jax_beam_search(engine, _prompt(case[0]), case[1], case[2], length_penalty=case[3]))
            for case in CASES}
    assert engine.allocator.num_free == free0
    n, width, max_tokens, penalty = EOS_CASE
    free_run = runs[EOS_CASE]
    candidates = []
    for depth in range(1, max_tokens):
        for toks, _ in free_run:
            if depth < len(toks) and toks[depth] not in candidates:
                candidates.append(toks[depth])
    for eos in candidates:
        hyps = _hyps(jax_beam_search(engine, _prompt(n), width, max_tokens, penalty, eos_token_id=eos))
        if any(t[-1] == eos for t, _ in hyps):
            break
    else:
        pytest.fail("no candidate EOS retires a top-width hypothesis")
    return jax.tree.map(np.asarray, params), runs, (eos, hyps)


@pytest.fixture(scope="module")
def model(jax_run):
    cfg = LlamaConfig.tiny(vocab_size=64, dtype=torch.float32)
    return cfg, params_from_jax(jax_run[0], cfg, device="cpu")


def _engine(model, **over) -> LLMEngine:
    cfg, params = model
    return LLMEngine(params, cfg, EngineConfig(**{**ENGINE, **over}), device="cpu")


def _assert_same(ours, ref):
    assert len(ours) == len(ref)
    for (toks, score), (ref_toks, ref_score) in zip(_hyps(ours), ref):
        assert toks == ref_toks
        np.testing.assert_allclose(score, ref_score, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("case", CASES, ids=[f"len{c[0]}-w{c[1]}-t{c[2]}-p{c[3]}" for c in CASES])
def test_beam_search_matches_jax(jax_run, model, case):
    n, width, max_tokens, penalty = case
    engine = _engine(model)
    hyps = beam_search(engine, _prompt(n), beam_width=width, max_tokens=max_tokens, length_penalty=penalty)
    assert all(isinstance(h, BeamHypothesis) for h in hyps)
    _assert_same(hyps, jax_run[1][case])
    assert engine.allocator.num_free == ENGINE["num_pages"], "beam pages leaked"


def test_beam_search_with_eos_matches_jax(jax_run, model):
    eos, ref = jax_run[2]
    n, width, max_tokens, penalty = EOS_CASE
    engine = _engine(model)
    hyps = beam_search(engine, _prompt(n), width, max_tokens, penalty, eos_token_id=eos)
    _assert_same(hyps, ref)
    assert any(h.tokens[-1] == eos for h in hyps)
    # The engine's own eos_token_id is the default.
    _assert_same(beam_search(_engine(model, eos_token_id=eos), _prompt(n), width, max_tokens, penalty), ref)
    assert engine.allocator.num_free == ENGINE["num_pages"]


def test_device_sort_order_matches_numpy_ties_included():
    rng = np.random.default_rng(0)
    logits = rng.integers(-3, 3, size=(5, 64)).astype(np.float32)  # many exact ties
    logits[1] = 0.0
    logits[2, ::3] = -np.inf
    logits[3] = rng.normal(size=64).astype(np.float32)
    for k in (1, 7, 64):
        order, values = _ranked(torch.from_numpy(logits), k)
        lp = np.asarray(torch.log_softmax(torch.from_numpy(logits), -1).double())
        for i in range(5):
            want = np.argsort(-lp[i], kind="stable")[:k]
            np.testing.assert_array_equal(order[i], want)
            np.testing.assert_array_equal(values[i], lp[i, want])


def test_refusals(model):
    engine = _engine(model)
    engine.add_request([1, 2, 3], SamplingParams(max_tokens=4))
    with pytest.raises(ValueError, match="idle"):
        beam_search(engine, [4, 5], beam_width=2, max_tokens=3)
    with pytest.raises(ValueError, match="max_batch_size"):
        beam_search(_engine(model), [4, 5], beam_width=5, max_tokens=3)
    with pytest.raises(ValueError, match="page cap"):
        beam_search(_engine(model), _prompt(100), beam_width=2, max_tokens=28)  # 100 + 28 + 1 > 8 x 16
    cfg = LlamaConfig.tiny(vocab_size=64, sliding_window=32, dtype=torch.float32)
    rolling = LLMEngine(init_llama_params(0, cfg, device="cpu"), cfg,
                        EngineConfig(**{**ENGINE, "rolling_kv": True}), device="cpu")
    with pytest.raises(ValueError, match="rolling_kv"):
        beam_search(rolling, [4, 5], beam_width=2, max_tokens=3)


def _oracle(engine, prompt, width, max_tokens, penalty, eos=None):
    """tests/beam_search_test.py's oracle: every candidate prefix prefilled
    afresh (the port's prefill step, on pages of its own) and the same rule
    by numpy's stable argsort."""
    def lp(tokens):
        pages = [engine.allocator.allocate() for _ in range(-(-(len(tokens) + 1) // engine.ecfg.page_size))]
        logits = _prefill_prompt(engine, tokens, pages)[0]
        for page in pages:
            engine.allocator.free(page)
        return np.asarray(torch.log_softmax(logits.float(), -1).double())

    def score(cum, length):
        return cum / max(length, 1) ** penalty

    finished, beams = [], []
    lp0 = lp(prompt)
    for tok in np.argsort(-lp0, kind="stable")[: width + 1]:
        tok, cum = int(tok), float(lp0[tok])
        if tok == eos:
            finished.append(([tok], score(cum, 1)))
        elif len(beams) < width:
            beams.append(([tok], cum))
    for _ in range(max_tokens - 1):
        if not beams:
            break
        cand = []
        for i, (toks, cum) in enumerate(beams):
            row = lp(prompt + toks)
            cand.extend((cum + float(row[int(t)]), i, int(t)) for t in np.argsort(-row, kind="stable")[: 2 * width])
        cand.sort(key=lambda c: -c[0])
        new = []
        for cum, i, tok in cand:
            if tok == eos:
                finished.append((beams[i][0] + [tok], score(cum, len(beams[i][0]) + 1)))
            elif len(new) < width:
                new.append((beams[i][0] + [tok], cum))
        beams = new
    finished.extend((toks, score(cum, len(toks))) for toks, cum in beams)
    return sorted(finished, key=lambda h: -h[1])[:width]


GEMMA = GemmaConfig(vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=4,
                    num_kv_heads=2, head_dim=64, max_position=512, attn_logit_softcap=50.0, final_logit_softcap=30.0,
                    gemma2=True, sliding_window=24, query_pre_attn_scalar=64.0, dtype=torch.float32)
DEEPSEEK = DeepseekV2Config(vocab_size=128, hidden_size=64, num_layers=3, num_heads=4, kv_lora_rank=32,
                            qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32, n_routed_experts=4,
                            n_shared_experts=1, num_experts_per_tok=2, moe_intermediate_size=32,
                            intermediate_size=64, first_k_dense_replace=1, moe_capacity_factor=2.0,
                            dtype=torch.float32)
FAMILIES = {
    "gemma2": lambda: (init_gemma_params(0, GEMMA, device="cpu"), GEMMA,
                       {"prefill_fn": gemma_prefill, "decode_fn": gemma_decode_step}),
    "deepseek": lambda: (init_deepseek_params(0, DEEPSEEK, device="cpu"), DEEPSEEK,
                         {"prefill_fn": deepseek_prefill, "decode_fn": deepseek_decode_step}),
    "llama_kv_int8": lambda: (init_llama_params(0, LlamaConfig.tiny(vocab_size=64, dtype=torch.float32),
                                                device="cpu"),
                              LlamaConfig.tiny(vocab_size=64, dtype=torch.float32), {"cache_dtype": torch.int8}),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_families_against_the_prefill_oracle(family):
    """Prompts of 31 tokens (15 in the tail page) and 32 (none), 3 beams
    over 6 tokens, crossing into a new page."""
    params, cfg, kw = FAMILIES[family]()
    engine = LLMEngine(params, cfg, EngineConfig(**ENGINE), device="cpu", **kw)
    oracle = LLMEngine(params, cfg, EngineConfig(**ENGINE), device="cpu", **kw)
    for n in (31, 32):
        prompt = _prompt(n, cfg.vocab_size)
        hyps = beam_search(engine, prompt, beam_width=3, max_tokens=6)
        _assert_same(hyps, _oracle(oracle, prompt, 3, 6, 1.0))
        assert engine.allocator.num_free == ENGINE["num_pages"]


def test_native_allocator_gives_the_same_hypotheses(jax_run, model, monkeypatch):
    monkeypatch.setenv("CONCH_ENABLE_CPP_EXT", "1")
    engine = _engine(model)
    assert isinstance(engine.allocator, native.NativeBlockAllocator)
    for case in CASES[2:4]:
        n, width, max_tokens, penalty = case
        _assert_same(beam_search(engine, _prompt(n), width, max_tokens, penalty), jax_run[1][case])
        assert engine.allocator.num_free == ENGINE["num_pages"]
