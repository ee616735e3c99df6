# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Multi-LoRA (``models/lora.py`` and the Llama layer's hook) against the
JAX package's, on tests/lora_test.py's setup: the tiny Llama (2 layers,
hidden 128, 4 query heads / 2 KV heads of 32) with every projection f32
dense, adapter 0 of rank 4 on wq, wk, wv, wo and adapter 1 of rank 8 on
wq, wv, w_gate, w_down (so the fused gate|up output is split and K6 runs
its parts form).

- ``init_lora_adapter`` gives JAX's adapter bit for bit from a seed (f32
  and bf16), ``stack_lora_adapters`` JAX's stack, ``lora_from_jax``
  carries it across bit for bit;
- ``lora_selector``, ``lora_delta`` (ids with -1), ``lora_delta_single``
  and ``merge_lora_into_params`` equal JAX's;
- a prefill's logits with per-token adapter ids equal JAX's and the
  merged model's at tests/lora_test.py:122's 2e-4, and ids of -1 give the
  base model's logits;
- one JAX engine (speculative, 3 draft tokens) serves the isolation jobs
  of :155 and the speculative jobs of :170; the port's speculative,
  multi-step and plain engines give its tokens, each request as when
  served alone;
- the prefix cache is keyed by adapter (:198), ``lora_id`` is range
  checked (:301), a parallel-sampling group's siblings serve their
  parent's adapter, and Gemma and DeepSeek refuse adapters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conch_tpu.models.lora as jax_lora
from conch_tpu.models.linear import QuantizedLinear as JaxQuantizedLinear
from conch_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from conch_tpu.models.llama import init_llama_params as jax_init_llama_params
from conch_tpu.models.llama import llama_prefill as jax_llama_prefill
from conch_tpu.serving import EngineConfig as JaxEngineConfig
from conch_tpu.serving import LLMEngine as JaxLLMEngine
from conch_tpu.serving import SamplingParams as JaxSamplingParams
from conch_tpu_torch.models.deepseek import DeepseekV2Config, deepseek_decode_step, init_deepseek_params
from conch_tpu_torch.models.gemma import GemmaConfig, gemma_prefill, init_gemma_params
from conch_tpu_torch.models.llama import LlamaConfig, init_kv_caches, llama_prefill, params_from_jax
from conch_tpu_torch.models.lora import (
    init_lora_adapter,
    lora_delta,
    lora_delta_single,
    lora_from_jax,
    lora_selector,
    merge_lora_into_params,
    stack_lora_adapters,
)
from conch_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

DIMS = {"vocab_size": 128, "hidden_size": 128, "intermediate_size": 256, "num_layers": 2, "num_heads": 4,
        "num_kv_heads": 2, "head_dim": 32, "max_position": 512}
ADAPTERS = [  # (seed, rank, alpha, targets): tests/lora_test.py:52
    (1, 4, 8.0, ("wq", "wk", "wv", "wo")),
    (2, 8, 16.0, ("wq", "wv", "w_gate", "w_down")),
]
ENGINE = {"page_size": 16, "num_pages": 64, "max_batch_size": 4, "max_pages_per_seq": 8, "max_prefill_tokens": 64,
          "enable_prefix_caching": False}
TOL = 2e-4  # tests/lora_test.py:122


def _jobs():
    rng = np.random.default_rng(7)  # tests/lora_test.py:155
    isolation = list(zip([rng.integers(0, 128, size=n).tolist() for n in (21, 17, 25)], [0, 1, None]))
    base = np.random.default_rng(11).integers(0, 128, size=6).tolist()  # :170
    return isolation, [((base * 4)[:22], 0), ((base * 4)[:22], 1)]


def _serve(engine, jobs, sampling_cls) -> list[list[int]]:
    ids = [engine.add_request(list(p), sampling_cls(max_tokens=8), lora_id=lid) for p, lid in jobs]
    done = {}
    while engine.waiting or engine.running:
        for r in engine.step():
            done[r.request_id] = list(r.output_tokens)
    return [done[i] for i in ids]


@pytest.fixture(scope="module")
def jax_run():
    """JAX's f32 dense params and stacked adapters (numpy), and its
    speculative engine's tokens on both job lists."""
    cfg = JaxLlamaConfig(**DIMS, dtype=jnp.float32)
    params = jax_init_llama_params(0, cfg, "bf16")
    layers = {n: JaxQuantizedLinear.dense(ql.arrays["w"].astype(jnp.float32)) if hasattr(ql, "arrays") else ql
              for n, ql in params["layers"].items()}
    params = {**params, "layers": layers,
              "lm_head": JaxQuantizedLinear.dense(params["lm_head"].arrays["w"].astype(jnp.float32))}
    adapters = [jax_lora.init_lora_adapter(s, cfg, rank=r, alpha=a, targets=t, dtype=jnp.float32)
                for s, r, a, t in ADAPTERS]
    stacked = jax_lora.stack_lora_adapters(adapters)
    engine = JaxLLMEngine(params, cfg, JaxEngineConfig(**ENGINE, num_speculative_tokens=3), lora=stacked)
    isolation, spec = _jobs()
    outs = (_serve(engine, isolation, JaxSamplingParams), _serve(engine, spec, JaxSamplingParams))
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stacked), adapters, outs


@pytest.fixture(scope="module")
def port(jax_run):
    """(config, params, the port's own adapters, their stack)."""
    cfg = LlamaConfig(**DIMS, dtype=torch.float32)
    adapters = [init_lora_adapter(s, cfg, rank=r, alpha=a, targets=t, dtype=torch.float32, device="cpu")
                for s, r, a, t in ADAPTERS]
    return cfg, params_from_jax(jax_run[0], cfg, device="cpu"), adapters, stack_lora_adapters(adapters)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_stack_and_carry_bit_for_bit(jax_run, dtype):
    jax_cfg = JaxLlamaConfig(**DIMS, dtype=getattr(jnp, dtype))
    cfg = LlamaConfig(**DIMS, dtype=getattr(torch, dtype))
    ref = [jax_lora.init_lora_adapter(s, jax_cfg, rank=r, alpha=a, targets=t) for s, r, a, t in ADAPTERS]
    ours = [init_lora_adapter(s, cfg, rank=r, alpha=a, targets=t, device="cpu") for s, r, a, t in ADAPTERS]

    def bits(x):
        x = np.asarray(x.view(torch.int16) if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16 else x)
        return x.view(np.int16) if x.dtype.name == "bfloat16" else x

    for a, b in zip(ours, ref):
        assert a["scale"] == b["scale"] and set(a["layers"]) == set(b["layers"])
        for name, ab in b["layers"].items():
            for part in ("a", "b"):
                assert a["layers"][name][part].dtype == cfg.dtype
                np.testing.assert_array_equal(bits(a["layers"][name][part]), bits(ab[part]))
    mine, theirs = stack_lora_adapters(ours), jax_lora.stack_lora_adapters(ref)
    carried = lora_from_jax(jax.tree.map(np.asarray, theirs), device="cpu")
    assert set(mine["layers"]) == set(theirs["layers"]) == {"wq", "wk", "wv", "wo", "w_gate", "w_down"}
    for name, ab in theirs["layers"].items():
        for part in ("a", "b"):
            np.testing.assert_array_equal(bits(mine["layers"][name][part]), bits(ab[part]))
            assert torch.equal(carried["layers"][name][part], mine["layers"][name][part])
    assert torch.equal(mine["scales"], carried["scales"]) and mine["scales"].tolist() == [2.0, 2.0]
    assert init_lora_adapter(3, cfg, zero_b=True, device="cpu")["layers"]["wq"]["b"].abs().sum() == 0
    with pytest.raises(ValueError, match="unknown LoRA target"):
        init_lora_adapter(0, cfg, targets=("w_router",), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selector_and_deltas_match_jax(jax_run, dtype):
    stacked = jax_run[1]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, DIMS["hidden_size"])).astype(np.float32)
    ids = np.array([0, 1, -1, 1, 0], np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    a, b = stacked["layers"]["wq"]["a"][0], stacked["layers"]["wq"]["b"][0]
    sel_ref = jax_lora.lora_selector(jnp.asarray(ids), jnp.asarray(stacked["scales"]))
    sel = lora_selector(torch.from_numpy(ids), torch.tensor(stacked["scales"]))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(sel_ref))
    assert not sel[2].any()
    ref = jax_lora.lora_delta(jnp.asarray(x, jdt), jnp.asarray(a), jnp.asarray(b), sel_ref)
    got = lora_delta(torch.from_numpy(x).to(tdt), torch.tensor(a), torch.tensor(b), sel)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert got.dtype == torch.float32 and not got[2].any()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol, rtol=tol)
    ref1 = jax_lora.lora_delta_single(jnp.asarray(x, jdt), jnp.asarray(a[1]), jnp.asarray(b[1]), 2.0)
    got1 = lora_delta_single(torch.from_numpy(x).to(tdt), torch.tensor(a[1]), torch.tensor(b[1]), 2.0)
    np.testing.assert_allclose(got1.numpy(), np.asarray(ref1), atol=tol, rtol=tol)


def _prefill(cfg, params, prompt, **lora):
    t = len(prompt)
    kc, vc = init_kv_caches(cfg, 16, 16, device="cpu")
    bt = torch.zeros((1, 8), dtype=torch.int32)
    bt[0, : -(-t // 16)] = torch.arange(-(-t // 16))
    logits, _, _ = llama_prefill(
        params, cfg, torch.tensor(prompt, dtype=torch.int32), torch.arange(t, dtype=torch.int32),
        torch.tensor([0, t], dtype=torch.int32), max(t, 16), torch.tensor([t], dtype=torch.int32), bt,
        torch.arange(t, dtype=torch.int32), kc, vc, **lora,
    )
    return logits[0].numpy()


def test_prefill_logits_match_jax_and_the_merged_model(jax_run, port):
    numpy_params, numpy_stacked, jax_adapters = jax_run[:3]
    cfg, params, adapters, stacked = port
    jax_cfg = JaxLlamaConfig(**DIMS, dtype=jnp.float32)
    jax_params = jax.tree.map(jnp.asarray, numpy_params)
    prompt = np.random.default_rng(3).integers(0, 128, size=24).tolist()
    t = len(prompt)
    for aid in (0, 1):
        ids = torch.full((t,), aid, dtype=torch.int32)
        ours = _prefill(cfg, params, prompt, lora=stacked, lora_ids=ids)
        merged = _prefill(cfg, merge_lora_into_params(params, adapters[aid]), prompt)
        np.testing.assert_allclose(ours, merged, atol=TOL, rtol=TOL)
        k = jnp.zeros((2, 16, 2, 16, 32), jnp.float32)
        ref, _, _ = jax_llama_prefill(
            jax_params, jax_cfg, jnp.asarray(prompt, jnp.int32), jnp.arange(t, dtype=jnp.int32),
            jnp.asarray([0, t], jnp.int32), t, jnp.asarray([t], jnp.int32),
            jnp.zeros((1, 8), jnp.int32).at[0, :2].set(jnp.arange(2)), jnp.arange(t, dtype=jnp.int32), k,
            jnp.zeros_like(k), lora=jax.tree.map(jnp.asarray, numpy_stacked), lora_ids=jnp.full((t,), aid, jnp.int32),
        )
        np.testing.assert_allclose(ours, np.asarray(ref[0]), atol=TOL, rtol=TOL)
        jax_merged = jax_lora.merge_lora_into_params(jax_params, jax_adapters[aid])
        for name, ql in jax_merged["layers"].items():
            if name in adapters[aid]["layers"]:
                np.testing.assert_allclose(merge_lora_into_params(params, adapters[aid])["layers"][name].arrays["w"],
                                           np.asarray(ql.arrays["w"]), atol=1e-6, rtol=1e-6)
    base = _prefill(cfg, params, prompt)
    none = _prefill(cfg, params, prompt, lora=stacked, lora_ids=torch.full((t,), -1, dtype=torch.int32))
    np.testing.assert_array_equal(none, base)
    mixed = torch.tensor([0, 1, -1] * 8, dtype=torch.int32)  # the last row's id (-1) picks no adapter
    assert np.abs(_prefill(cfg, params, prompt, lora=stacked, lora_ids=mixed) - base).max() > 1e-3


@pytest.mark.parametrize("over", [{"num_speculative_tokens": 3}, {"multi_step_decode": 4}, {"multi_step_decode": 1}],
                         ids=["spec", "multi_step", "plain"])
def test_engine_tokens_match_jax(jax_run, port, over):
    """tests/lora_test.py:155 (isolation: each request's tokens as when
    served alone) and :170 (LoRA under speculative decoding)."""
    jax_isolation, jax_spec = jax_run[3]
    cfg, params, _, stacked = port
    isolation, spec = _jobs()

    def engine():
        return LLMEngine(params, cfg, EngineConfig(**ENGINE, **over), device="cpu", lora=stacked)

    assert _serve(engine(), isolation, SamplingParams) == jax_isolation
    assert [_serve(engine(), [job], SamplingParams)[0] for job in isolation] == jax_isolation
    spec_engine = engine()
    assert _serve(spec_engine, spec, SamplingParams) == jax_spec
    assert jax_spec[0] != jax_spec[1]  # the adapters change the tokens
    if "num_speculative_tokens" in over:
        assert spec_engine.spec_tokens_accepted > 0


def test_prefix_cache_is_adapter_scoped(port):
    cfg, params, _, stacked = port
    prompt = np.random.default_rng(13).integers(0, 128, size=33).tolist()  # 2 full pages
    engine = LLMEngine(params, cfg, EngineConfig(**{**ENGINE, "enable_prefix_caching": True}), device="cpu",
                       lora=stacked)
    first = _serve(engine, [(prompt, 0)], SamplingParams)
    solo1 = _serve(LLMEngine(params, cfg, EngineConfig(**ENGINE), device="cpu", lora=stacked), [(prompt, 1)],
                   SamplingParams)
    assert _serve(engine, [(prompt, 1)], SamplingParams) == solo1 != first
    assert engine.prefix_cache_hits == 0  # another adapter's KV is not reused
    assert _serve(engine, [(prompt, 1)], SamplingParams) == solo1
    assert engine.prefix_cache_hits == 32


def test_lora_id_validation_and_families_without_lora(port):
    cfg, params, _, stacked = port
    engine = LLMEngine(params, cfg, EngineConfig(**ENGINE), device="cpu", lora=stacked)
    with pytest.raises(ValueError, match="out of range"):
        engine.add_request([1, 2, 3], SamplingParams(), lora_id=2)
    with pytest.raises(ValueError, match="out of range"):
        LLMEngine(params, cfg, EngineConfig(**ENGINE), device="cpu").add_request([1, 2, 3], lora_id=0)
    with pytest.raises(ValueError, match="lora_ids is None"):
        _prefill(cfg, params, [1, 2, 3], lora=stacked)
    gemma_cfg = GemmaConfig(vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=4,
                            num_kv_heads=2, head_dim=32, dtype=torch.float32)
    gemma_engine = LLMEngine(init_gemma_params(0, gemma_cfg, device="cpu"), gemma_cfg, EngineConfig(**ENGINE),
                             device="cpu", lora=stacked, prefill_fn=gemma_prefill)
    with pytest.raises(NotImplementedError, match="Gemma takes no LoRA"):
        gemma_engine.generate([[1, 2, 3]], SamplingParams(max_tokens=2), lora_ids=[0])
    ds_cfg = DeepseekV2Config(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, kv_lora_rank=32,
                              qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32, n_routed_experts=4,
                              n_shared_experts=1, num_experts_per_tok=2, moe_intermediate_size=32,
                              intermediate_size=64, first_k_dense_replace=1, dtype=torch.float32)
    one = torch.zeros(1, dtype=torch.int32)
    ds_params = init_deepseek_params(0, ds_cfg, device="cpu")
    cache = torch.zeros((2, 4, 16, ds_cfg.kv_packed_dim))
    with pytest.raises(NotImplementedError, match="DeepSeek takes no LoRA"):
        deepseek_decode_step(ds_params, ds_cfg, one, one, one + 1, torch.zeros((1, 2), dtype=torch.int32), one,
                             cache, torch.zeros(0), lora=stacked, lora_ids=one)


def test_siblings_inherit_the_adapter(port):
    """Parallel sampling under an adapter: every sibling serves its parent's
    ``lora_id``, so a greedy group of 3 gives the adapter's solo tokens."""
    cfg, params, _, stacked = port
    prompt = np.random.default_rng(17).integers(0, 128, size=21).tolist()
    engine = LLMEngine(params, cfg, EngineConfig(**ENGINE), device="cpu", lora=stacked)
    solo = _serve(engine, [(prompt, 1)], SamplingParams)[0]
    assert solo != _serve(engine, [(prompt, None)], SamplingParams)[0]
    assert engine.generate([prompt], SamplingParams(max_tokens=8, n=3), lora_ids=[1]) == [[solo] * 3]
