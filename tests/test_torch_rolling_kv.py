# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Rolling KV in the port: K3 and K7 over a ring of pages, and the engine's
``rolling_kv`` mode, against the JAX package.

Under rolling KV each sequence's block-table row is a ring of
``ring_pages`` pages holding position p at slot p % (ring_pages *
page_size); a true page i lives at table entry i % ring_pages. The cases
and tolerances are those of ``tests/rolling_kv_test.py``: page 16, window
40, three sequences of up to 220 tokens (rings of 4 and 6 pages, wrapped
many times), decode at 2e-5 and chunked prefill at 2e-3, against JAX's
launchers over the same ring and over the full linear cache. The port's
rolling engine (tiny Llama, window 48, f32) must give the greedy tokens of
its unbounded engine and of the JAX rolling engine, in plain and
multi-step decode; the JAX engine runs once, its block table sized to the
prompts (interpret-mode compiles grow with it).
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.kernels.attention.paged_attention import paged_attention_launcher as jax_paged_launcher
from conch_tpu.kernels.attention.varlen_attention import varlen_attention_launcher as jax_varlen_launcher
from conch_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from conch_tpu.models.llama import init_llama_params as jax_init_llama_params
from conch_tpu.serving import EngineConfig as JaxEngineConfig
from conch_tpu.serving import LLMEngine as JaxLLMEngine
from conch_tpu.serving import SamplingParams as JaxSamplingParams
from conch_tpu_torch.kernels.attention.paged_attention import paged_attention_launcher, paged_split_plan
from conch_tpu_torch.kernels.attention.varlen_attention import varlen_attention_launcher, varlen_tile_plan
from conch_tpu_torch.models.gemma import GemmaConfig, init_gemma_params
from conch_tpu_torch.models.llama import LlamaConfig, init_llama_params, llama_decode_step, params_from_jax
from conch_tpu_torch.ops.attention import paged_attention, varlen_attention
from conch_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams
from rolling_kv_test import _dense_kv, _linear_cache, _queries, _ring_cache  # the JAX tests' cache packers
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

PAGE, WINDOW, KH, GROUP = 16, 40, 2, 2
ENGINE = {
    "page_size": 16, "num_pages": 128, "max_batch_size": 4, "max_pages_per_seq": 16, "max_prefill_tokens": 32,
    "enable_prefix_caching": False,
}
ENGINE_PROMPTS = (70, 100, 17)
MAX_TOKENS = 40


def _stacked(cache: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(cache)[None]


@pytest.mark.parametrize("head", [128, 64])
def test_decode_ring_matches_jax(head):
    """K3's plain version over a ring equals JAX's launcher over the same
    ring and over the full linear cache, at 2e-5."""
    rng = np.random.default_rng(1234)
    ring_pages = -(-WINDOW // PAGE) + 1  # decode slack: one token
    seq_lens = [200, 73, 41]
    k_dense, v_dense = _dense_kv(rng, 3, max(seq_lens), KH, head)
    q, _ = _queries(rng, [1, 1, 1], KH * GROUP, head)
    scale = 1 / math.sqrt(head)
    kc, vc, bt = _linear_cache(k_dense, v_dense, seq_lens, PAGE, rng)
    rkc, rvc, rbt = _ring_cache(k_dense, v_dense, seq_lens, PAGE, ring_pages, rng, bt.shape[1])
    sl = np.asarray(seq_lens, np.int32)
    jax_linear = np.asarray(jax_paged_launcher(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(bt), jnp.asarray(sl), scale=scale,
        window_size=WINDOW,
    ))
    jax_ring = np.asarray(jax_paged_launcher(
        jnp.asarray(q), jnp.asarray(rkc), jnp.asarray(rvc), jnp.asarray(rbt), jnp.asarray(sl), scale=scale,
        window_size=WINDOW, ring_pages=ring_pages,
    ))
    ours = paged_attention_launcher(
        torch.from_numpy(q), _stacked(rkc), _stacked(rvc), torch.from_numpy(rbt), torch.from_numpy(sl), scale, 0,
        window_size=WINDOW, ring_pages=ring_pages,
    ).numpy()
    np.testing.assert_allclose(ours, jax_ring, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(ours, jax_linear, atol=2e-5, rtol=2e-5)
    # The op takes the same ring.
    op = paged_attention(torch.from_numpy(q), torch.from_numpy(rkc), torch.from_numpy(rvc), torch.from_numpy(rbt),
                         torch.from_numpy(sl), scale=scale, window_size=WINDOW, ring_pages=ring_pages)
    np.testing.assert_array_equal(op.numpy(), ours)


@pytest.mark.parametrize("head", [128, 64])
def test_prefill_ring_matches_jax(head):
    """K7's plain version over a ring (covering the window and the query
    chunk) equals JAX's launcher over the same ring, and the port's plain
    version over the linear cache, at 2e-3."""
    rng = np.random.default_rng(1234)
    q_lens = [24, 8, 1]
    ring_pages = -(-(WINDOW + max(q_lens)) // PAGE) + 1
    seq_lens = [220, 95, 60]
    k_dense, v_dense = _dense_kv(rng, 3, max(seq_lens), KH, head)
    q, cu = _queries(rng, q_lens, KH * GROUP, head)
    scale = 1 / math.sqrt(head)
    kc, vc, bt = _linear_cache(k_dense, v_dense, seq_lens, PAGE, rng)
    rkc, rvc, rbt = _ring_cache(k_dense, v_dense, seq_lens, PAGE, ring_pages, rng, bt.shape[1])
    sl = np.asarray(seq_lens, np.int32)
    jax_ring = np.asarray(jax_varlen_launcher(
        jnp.asarray(q), jnp.asarray(rkc), jnp.asarray(rvc), jnp.asarray(cu), max(q_lens), jnp.asarray(sl),
        jnp.asarray(rbt), scale=scale, causal=True, window_size=WINDOW, ring_pages=ring_pages, chunk_tokens=64,
        q_chunk_rows=16,
    ))
    args = (torch.from_numpy(q), torch.from_numpy(cu), torch.from_numpy(sl))
    ours = varlen_attention_launcher(
        args[0], _stacked(rkc), _stacked(rvc), args[1], args[2], torch.from_numpy(rbt), scale, True, 0,
        window_size=WINDOW, ring_pages=ring_pages,
    ).numpy()
    linear = varlen_attention_launcher(
        args[0], _stacked(kc), _stacked(vc), args[1], args[2], torch.from_numpy(bt), scale, True, 0,
        window_size=WINDOW,
    ).numpy()
    np.testing.assert_allclose(ours, jax_ring, atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(ours, linear, atol=2e-3, rtol=2e-3)
    op = varlen_attention(args[0], torch.from_numpy(rkc), torch.from_numpy(rvc), args[1], max(q_lens), args[2],
                          max(seq_lens), torch.from_numpy(rbt), causal=True, scale=scale, window_size=WINDOW,
                          ring_pages=ring_pages)
    np.testing.assert_array_equal(op.numpy(), ours)


@pytest.fixture(scope="module")
def jax_rolling_run():
    """The JAX rolling engine's greedy tokens (multi-step decode of 4) and
    its params as numpy."""
    import jax

    cfg = JaxLlamaConfig.tiny(sliding_window=48, dtype=jnp.float32)
    params = jax_init_llama_params(0, cfg)
    engine = JaxLLMEngine(params, cfg, JaxEngineConfig(**ENGINE, rolling_kv=True, multi_step_decode=4))
    out = engine.generate(_engine_prompts(), JaxSamplingParams(max_tokens=MAX_TOKENS))
    return jax.tree.map(np.asarray, params), out


def _engine_prompts() -> list[list[int]]:
    rng = np.random.default_rng(1234)
    return [rng.integers(0, 256, size=n).tolist() for n in ENGINE_PROMPTS]


def _port_engine(numpy_params, rolling: bool, **over) -> LLMEngine:
    cfg = LlamaConfig.tiny(sliding_window=48, dtype=torch.float32)
    params = params_from_jax(numpy_params, cfg, device="cpu")
    return LLMEngine(params, cfg, EngineConfig(**{**ENGINE, **over}, rolling_kv=rolling), device="cpu")


@pytest.mark.parametrize("multi_step", [1, 4], ids=["plain", "multi_step"])
def test_rolling_engine_matches_unbounded_and_jax(jax_rolling_run, multi_step):
    """Greedy tokens of the rolling engine equal the unbounded engine's
    and the JAX rolling engine's; the ring holds at most its 6 pages."""
    numpy_params, jax_out = jax_rolling_run
    sampling = SamplingParams(max_tokens=MAX_TOKENS)
    base = _port_engine(numpy_params, False, multi_step_decode=multi_step).generate(_engine_prompts(), sampling)
    engine = _port_engine(numpy_params, True, multi_step_decode=multi_step)
    held = []
    step = engine.step
    engine.step = lambda: held.append(max((len(r.pages) for r in engine.running), default=0)) or step()
    rolled = engine.generate(_engine_prompts(), sampling)
    assert engine.config.kv_ring_pages == engine._page_cap == 6  # ceil((48 + 32) / 16) + 1
    assert max(held) == 6
    assert rolled == base
    assert rolled == jax_out


def test_rolling_serves_beyond_pool(jax_rolling_run):
    """A 150-token prompt and 50 new tokens (13 linear pages) serve from an
    8-page pool under rolling KV (a ring of 6) with the tokens of an
    unbounded engine on a large pool, and every page comes back."""
    numpy_params, _ = jax_rolling_run
    prompt = np.random.default_rng(7).integers(0, 256, size=150).tolist()
    sampling = SamplingParams(max_tokens=50)
    base = _port_engine(numpy_params, False).generate([prompt], sampling)
    small = _port_engine(numpy_params, True, num_pages=8, max_pages_per_seq=8)
    assert small._page_cap == 6
    assert small.generate([prompt], sampling) == base
    assert small.allocator.num_free == 8


def test_rolling_engine_refusals():
    """The JAX engine's ValueErrors: a model without a window, Gemma-2 (its
    global layers need the whole history), prefix caching, too few pages."""
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    params = init_llama_params(0, cfg, device="cpu")
    with pytest.raises(ValueError, match="sliding_window"):
        LLMEngine(params, cfg, EngineConfig(**ENGINE, rolling_kv=True), device="cpu")
    windowed = dataclasses.replace(cfg, sliding_window=48)
    with pytest.raises(ValueError, match="prefix caching"):
        LLMEngine(params, windowed, EngineConfig(**{**ENGINE, "enable_prefix_caching": True}, rolling_kv=True),
                  device="cpu")
    with pytest.raises(ValueError, match="max_pages_per_seq"):
        LLMEngine(params, windowed, EngineConfig(**{**ENGINE, "max_pages_per_seq": 5}, rolling_kv=True),
                  device="cpu")
    gemma_cfg = GemmaConfig(
        vocab_size=64, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=2, num_kv_heads=1, head_dim=32,
        gemma2=True, sliding_window=24, dtype=torch.float32,
    )
    with pytest.raises(ValueError, match="does not support rolling KV"):
        LLMEngine(init_gemma_params(0, gemma_cfg, device="cpu"), gemma_cfg,
                  EngineConfig(**ENGINE, rolling_kv=True), device="cpu")


def test_ring_requires_window():
    """A ring without a window raises with the JAX launchers' words, at the
    ops, the launchers and the model step; so do a ring wider than the
    table and one whose tokens do not cover the window."""
    q = torch.zeros((1, 2, 64))
    kc = torch.zeros((4, 2, 16, 64))
    bt = torch.zeros((1, 4), dtype=torch.int32)
    sl = torch.ones(1, dtype=torch.int32)
    cu = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="requires window_size > 0"):
        paged_attention(q, kc, kc, bt, sl, scale=1.0, ring_pages=4)
    with pytest.raises(ValueError, match="requires window_size > 0"):
        varlen_attention(q, kc, kc, cu, 1, sl, 1, bt, causal=True, ring_pages=4)
    with pytest.raises(ValueError, match="requires window_size > 0"):
        varlen_attention_launcher(q, kc[None], kc[None], cu, sl, bt, 1.0, True, 0, ring_pages=4)
    with pytest.raises(ValueError, match="outside the block table"):
        paged_attention_launcher(q, kc[None], kc[None], bt, sl, 1.0, 0, window_size=8, ring_pages=5)
    for launch in (
        lambda: paged_attention_launcher(q, kc[None], kc[None], bt, sl, 1.0, 0, window_size=40, ring_pages=2),
        lambda: varlen_attention_launcher(q, kc[None], kc[None], cu, sl, bt, 1.0, True, 0, window_size=40,
                                          ring_pages=2),
    ):
        with pytest.raises(ValueError, match="does not cover the window"):
            launch()
    cfg = LlamaConfig.tiny(kv_ring_pages=4, dtype=torch.float32)
    with pytest.raises(ValueError, match="sliding_window"):
        llama_decode_step({"embedding": torch.zeros(1)}, cfg, *([None] * 7))


# Plans at one window: a ring table of the rolling engine's width and a
# linear table wide enough for the longest sequence.
PLAN_CASES = [  # (batch, ring_pages, linear_pages, window, page_size)
    (8, 289, 448, 4096, 16), (32, 289, 448, 4096, 16), (1, 6, 16, 48, 16), (4, 4, 16, 40, 16), (3, 6, 16, 40, 16),
    (16, 69, 128, 4096, 64), (8, 33, 64, 500, 16),
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_paged_split_plan_ring_equals_linear(case):
    batch, ring_pages, linear_pages, window, ps = case
    sl = torch.zeros(batch, dtype=torch.int32)
    ring = paged_split_plan(sl, torch.zeros((batch, ring_pages), dtype=torch.int32), ps, 8, window, 132)
    linear = paged_split_plan(sl, torch.zeros((batch, linear_pages), dtype=torch.int32), ps, 8, window, 132)
    assert ring == linear
    assert ring.splits * ring.split_len >= window


@pytest.mark.parametrize("group", [1, 4, 7, 8])
@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_varlen_tile_plan_ring_equals_linear(case, group):
    batch, ring_pages, linear_pages, window, ps = case
    total_q = 512
    ring = varlen_tile_plan(total_q, batch, ring_pages, ps, 4 * group, 4, 128, True, window, 132, ring_pages)
    linear = varlen_tile_plan(total_q, batch, linear_pages, ps, 4 * group, 4, 128, True, window, 132)
    assert ring == linear
    assert ring.splits * ring.split_len >= window + ring.block_rows - 1
