# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Mixtral through both engines: the port's ``LLMEngine(...,
prefill_fn=mixtral_prefill, decode_fn=mixtral_decode_step)`` against the
JAX package's, on the same params, greedy.

The model is tests/moe_test.py's ``_tiny_cfg`` (2 layers, hidden 64, 4
experts, top 2, bf16) carried across with ``moe_params_from_jax``, with the
capacity factor cut to 0.5 so that every MoE layer of every step drops
selections: capacity 4 of a 16-row prefill step's 32, 1 of the 4-row
decode step's 8. Which selections drop depends on the padded row count and
the row order, so the port must schedule as the JAX engine does. Three
prompts (20, 12 and 14 tokens) in 16-token prefill steps: the first is
chunk-prefilled over two steps, the two first requests then decode inside
the third prefill step (mixed batching), and the 4-step greedy decode runs
with one idle row, which routes its embedding and takes capacity, to 10
tokens each.

Every prefill step holds exactly 16 tokens, so no step has padding rows:
the JAX varlen launcher gives such rows NaN, which its Mixtral MoE spreads
to every row (tests/test_torch_mixtral.py holds the port's padded prefill
against JAX's layer step with those rows zeroed).

The JAX engine compiles each new step shape in interpret mode, so it runs
once per module.
"""

import dataclasses

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
from conch_tpu_torch.models.moe import MoEConfig, mixtral_decode_step, mixtral_prefill, moe_params_from_jax
from conch_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

# tests/moe_test.py:_tiny_cfg, capacity factor 0.5.
DIMS = {"vocab_size": 64, "hidden_size": 64, "intermediate_size": 128, "num_layers": 2, "num_heads": 2,
        "num_kv_heads": 1, "head_dim": 32, "max_position": 128}
MOE = {"num_experts": 4, "top_k": 2, "capacity_factor": 0.5}
ENGINE = {"page_size": 8, "num_pages": 64, "max_batch_size": 4, "max_pages_per_seq": 8, "max_prefill_tokens": 16,
          "multi_step_decode": 4}
MAX_TOKENS = 10


def _prompts():
    # Prefill steps: [r0 16], [r0 4, r1 12], [r0 decode 1, r1 decode 1, r2 14]: 16 tokens each.
    rng = np.random.default_rng(22)
    return [rng.integers(0, DIMS["vocab_size"], n).tolist() for n in (20, 12, 14)]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX engine's tokens and its params (numpy)."""
    cfg = JaxMoEConfig(llama=JaxLlamaConfig(**DIMS), **MOE)
    numpy_params = jax.tree.map(np.asarray, jax_init_params(0, cfg))
    engine = JaxLLMEngine(
        jax.tree.map(jnp.asarray, numpy_params), cfg, JaxEngineConfig(**ENGINE),
        prefill_fn=jax_prefill, decode_fn=jax_decode_step,
    )
    return numpy_params, engine.generate(_prompts(), JaxSamplingParams(max_tokens=MAX_TOKENS))


def _port_engine(numpy_params, engine=ENGINE, **over) -> LLMEngine:
    cfg = MoEConfig(llama=LlamaConfig(**DIMS), **MOE)
    return LLMEngine(
        moe_params_from_jax(numpy_params, cfg, device="cpu"), cfg, EngineConfig(**engine),
        prefill_fn=mixtral_prefill, decode_fn=mixtral_decode_step, device="cpu", **over,
    )


def test_mixtral_engine_greedy_tokens_match_jax(jax_run):
    numpy_params, jax_tokens = jax_run
    engine = _port_engine(numpy_params)
    layers = engine.params["layers"]
    assert "wqkv" in layers and not {"wq", "wk", "wv"} & set(layers)  # attention fused, as in JAX
    assert all(isinstance(layers[n], torch.Tensor) for n in ("w_gate", "w_up", "w_down"))  # experts raw
    assert engine.k_caches.shape == (2, 64, 1, 8, 32) and engine.k_caches.dtype == torch.bfloat16
    steps = []
    prefill, decode = engine._prefill_fn, engine._decode_fn

    def counted(fn, kind):
        def step(*args, **kwargs):
            token_ids = kwargs["token_ids"] if "token_ids" in kwargs else args[2]
            seq_lens = kwargs["seq_lens"] if "seq_lens" in kwargs else args[4]
            live = int(kwargs["cu_seqlens_q"][-1]) if kind == "prefill" else int((seq_lens > 0).sum())
            steps.append((kind, live, token_ids.shape[0]))
            return fn(*args, **kwargs)

        return step

    engine._prefill_fn, engine._decode_fn = counted(prefill, "prefill"), counted(decode, "decode")
    out = engine.generate(_prompts(), SamplingParams(max_tokens=MAX_TOKENS))
    assert steps[:3] == [("prefill", 16, 16)] * 3  # no padding rows
    assert ("decode", 3, 4) in steps  # a decode step with an idle row
    assert [len(o) for o in out] == [MAX_TOKENS] * 3
    assert out == jax_tokens


def test_mixtral_engine_capacity_changes_tokens(jax_run):
    """The capacity bites in the served steps: without drops (factor 4)
    the port's greedy tokens differ."""
    numpy_params, jax_tokens = jax_run
    engine = _port_engine(numpy_params)
    engine.config = dataclasses.replace(engine.config, capacity_factor=4.0)
    assert engine.generate(_prompts(), SamplingParams(max_tokens=MAX_TOKENS)) != jax_tokens


def test_mixtral_engine_refuses_rolling_kv(jax_run):
    numpy_params, _ = jax_run
    with pytest.raises(ValueError, match="sliding_window"):
        _port_engine(numpy_params, {**ENGINE, "rolling_kv": True, "enable_prefix_caching": False})
