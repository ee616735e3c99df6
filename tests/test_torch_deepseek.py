# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""DeepSeek-V2 step by step: the port's pieces and steps against the JAX package's.

- the YaRN rope cache of ``DeepseekV2Config.v2_lite()``, bit for bit over
  its first 4096 positions;
- ``deepseek_route`` with all three gates (greedy, group_limited_greedy,
  noaux_tc with a choice bias), expert for expert, on f32 inputs where no
  near tie occurs, and on exact ties (the lower index first);
- ``make_dispatch`` with overflow drops and second-choice queueing (the
  cases of tests/moe_test.py:63,75) and on random routings with drops,
  exactly;
- ``fuse_deepseek_params``, bit for bit;
- ``deepseek_prefill`` / ``deepseek_decode_step`` logits and the latent
  cache through ``deepseek_params_from_jax`` on the tiny MoE model of
  tests/deepseek_test.py:30 (3 layers: 1 dense, 2 MoE; f32; norm weights
  drawn at random so a dropped weight shows), fused as served, unfused,
  and with V2's low-rank query, at the tolerance of
  tests/deepseek_tp_test.py:90 (1e-4, absolute and relative). The steps
  are built as the engine builds them: a prefill of two fresh prompts
  with padding rows and zero-length padding sequences, a chunked step with
  a mixed-in decode row, and decode steps with an idle row; the capacity
  factor is cut to 0.5 so that every step drops tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.models.deepseek import DeepseekV2Config as JaxDeepseekV2Config
from conch_tpu.models.deepseek import deepseek_decode_step as jax_decode_step
from conch_tpu.models.deepseek import deepseek_prefill as jax_prefill
from conch_tpu.models.deepseek import deepseek_rope_cache as jax_rope_cache
from conch_tpu.models.deepseek import deepseek_route as jax_route
from conch_tpu.models.deepseek import fuse_deepseek_params as jax_fuse
from conch_tpu.models.deepseek import init_deepseek_kv_cache as jax_init_cache
from conch_tpu.models.deepseek import init_deepseek_params as jax_init_params
from conch_tpu.models.moe import make_dispatch as jax_make_dispatch
from conch_tpu_torch.models.deepseek import (
    DeepseekV2Config,
    deepseek_decode_step,
    deepseek_params_from_jax,
    deepseek_prefill,
    deepseek_rope_cache,
    deepseek_route,
    deepseek_verify_forward,
    fuse_deepseek_params,
    init_deepseek_kv_cache,
    init_deepseek_params,
)
from conch_tpu_torch.models.moe import make_dispatch
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

DIMS = {
    "vocab_size": 256, "hidden_size": 64, "num_layers": 3, "num_heads": 4, "kv_lora_rank": 32,
    "qk_rope_head_dim": 16, "qk_nope_head_dim": 32, "v_head_dim": 32, "n_routed_experts": 4,
    "n_shared_experts": 1, "num_experts_per_tok": 2, "moe_intermediate_size": 32, "intermediate_size": 64,
    "first_k_dense_replace": 1, "moe_capacity_factor": 0.5,
}
TOL = 1e-4
PS, NUM_PAGES, ROWS, BATCH, MAX_PAGES = 16, 16, 64, 4, 6
PAGES = [[3, 7, 1, 9, 10], [0, 5]]  # page 0 is a real page


def _tensor_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _array_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_rope_cache_bit_for_bit_v2_lite():
    ours = deepseek_rope_cache(DeepseekV2Config.v2_lite(), device="cpu")
    ref = np.asarray(jax_rope_cache(JaxDeepseekV2Config.v2_lite()))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == ref.shape == (163840, 64)
    np.testing.assert_array_equal(ours[:4096].numpy(), ref[:4096])


GATES = {
    "greedy": {},
    "group_limited_greedy": {"topk_method": "group_limited_greedy", "n_group": 4, "topk_group": 2,
                             "routed_scaling_factor": 16.0},
    "noaux_tc": {"topk_method": "noaux_tc", "score_function": "sigmoid", "n_group": 4, "topk_group": 2,
                 "norm_topk_prob": True, "routed_scaling_factor": 2.5},
}


@pytest.mark.parametrize("gate", list(GATES))
def test_route_matches_jax(gate):
    rng = np.random.default_rng(5)
    over = {"n_routed_experts": 16, "num_experts_per_tok": 4, **GATES[gate]}
    hidden = rng.standard_normal((40, 64)).astype(np.float32)
    router = (rng.standard_normal((64, 16)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(16) * 0.1).astype(np.float32) if gate == "noaux_tc" else None
    ref_w, ref_idx = jax_route(
        jnp.asarray(hidden), jnp.asarray(router), JaxDeepseekV2Config(**over),
        bias=None if bias is None else jnp.asarray(bias),
    )
    w, idx = deepseek_route(
        torch.from_numpy(hidden), torch.from_numpy(router), DeepseekV2Config(**over),
        bias=None if bias is None else torch.from_numpy(bias),
    )
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), atol=1e-6, rtol=1e-6)


def test_route_ties_break_to_the_lower_index():
    """Equal scores: jax.lax.top_k's order, lowest expert index first."""
    cfg = DeepseekV2Config(n_routed_experts=8, num_experts_per_tok=3)
    hidden = torch.ones((2, 4))
    router = torch.zeros((4, 8))
    router[:, 5] = 1.0  # expert 5 wins, the other seven tie
    _, idx = deepseek_route(hidden, router, cfg)
    _, ref = jax_route(jnp.asarray(hidden.numpy()), jnp.asarray(router.numpy()), JaxDeepseekV2Config(
        n_routed_experts=8, num_experts_per_tok=3))
    assert idx.tolist() == np.asarray(ref).tolist() == [[5, 0, 1], [5, 0, 1]]


def _dispatch_cases():
    yield "overflow", np.ones((5, 1), np.float32), np.zeros((5, 1), np.int32), 3, 2
    yield "second_choice", np.full((2, 2), 0.5, np.float32), np.asarray([[1, 0], [0, 1]], np.int32), 2, 2
    rng = np.random.default_rng(9)
    for t, e, k, cap in ((32, 4, 2, 8), (16, 64, 6, 3), (48, 8, 3, 5)):
        experts = np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(np.int32)
        yield f"random_{t}_{e}_{k}_{cap}", rng.random((t, k)).astype(np.float32), experts, e, cap


@pytest.mark.parametrize("case", list(_dispatch_cases()), ids=lambda c: c[0])
def test_make_dispatch_matches_jax(case):
    _, weights, experts, e, cap = case
    ref_d, ref_c = jax_make_dispatch(jnp.asarray(weights), jnp.asarray(experts), e, cap)
    d, c = make_dispatch(torch.from_numpy(weights), torch.from_numpy(experts), e, cap)
    assert d.dtype == c.dtype == torch.float32
    np.testing.assert_array_equal(d.numpy(), np.asarray(ref_d))
    np.testing.assert_array_equal(c.numpy(), np.asarray(ref_c))
    if case[0] == "overflow":
        assert d.sum() == cap and d[0, 0, 0] == 1 and d[1, 0, 1] == 1  # earlier tokens win
    if case[0] == "second_choice":
        assert d[0, 1, 0] == 1 and d[1, 1, 1] == 1  # token 1's second choice queues behind
    if case[0].startswith("random"):
        assert d.sum() < weights.size  # tokens were dropped


def _numpy_params(seed: int = 0, **over) -> tuple[dict, JaxDeepseekV2Config]:
    """JAX params as numpy, with every norm weight drawn at random."""
    jax_cfg = JaxDeepseekV2Config(**DIMS, **over, dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jax_init_params(seed, jax_cfg))
    rng = np.random.default_rng(seed + 1)
    for stack in ("layers_dense", "layers_moe"):
        layers = dict(tree[stack])
        for name, w in layers.items():
            if name.endswith("_norm"):
                layers[name] = rng.normal(1.0, 0.3, size=w.shape).astype(w.dtype)
        tree[stack] = layers
    tree["final_norm"] = rng.normal(1.0, 0.3, size=tree["final_norm"].shape).astype(tree["final_norm"].dtype)
    return tree, jax_cfg


def test_fuse_deepseek_params_matches_jax():
    tree, _ = _numpy_params()
    cfg = DeepseekV2Config(**DIMS, dtype=torch.float32)
    ours = fuse_deepseek_params(deepseek_params_from_jax(tree, cfg, device="cpu"))
    ref = jax.tree.map(np.asarray, jax_fuse(jax.tree.map(jnp.asarray, tree)))
    for stack, fused in (("layers_dense", ("wq_kva", "w_gateup")), ("layers_moe", ("wq_kva", "shared_gateup"))):
        assert set(ours[stack]) == set(ref[stack])
        for name in fused:
            np.testing.assert_array_equal(
                _tensor_bits(ours[stack][name].arrays["w"]), _array_bits(ref[stack][name].arrays["w"])
            )


def _steps():
    """Host-side inputs of each step, as the engine builds them."""
    rng = np.random.default_rng(4)
    bt = np.zeros((BATCH, MAX_PAGES), np.int32)
    for b, pages in enumerate(PAGES):
        bt[b, : len(pages)] = pages

    def slot(b, pos):
        return PAGES[b][pos // PS] * PS + pos % PS

    def prefill(chunks):  # chunks: [(seq, start, length)]
        tokens = np.zeros(ROWS, np.int32)
        positions = np.zeros(ROWS, np.int32)
        slots = np.full(ROWS, -1, np.int32)
        cu = np.zeros(BATCH + 1, np.int32)
        seq_lens = np.zeros(BATCH, np.int32)
        row = 0
        for i, (b, start, n) in enumerate(chunks):
            tokens[row : row + n] = rng.integers(0, DIMS["vocab_size"], n)
            positions[row : row + n] = np.arange(start, start + n)
            slots[row : row + n] = [slot(b, p) for p in range(start, start + n)]
            row += n
            cu[i + 1] = row
            seq_lens[i] = start + n
        cu[len(chunks) + 1 :] = row  # zero-length padding sequences
        table = np.zeros_like(bt)
        table[: len(chunks)] = bt[[b for b, _, _ in chunks]]
        return ("prefill", tokens, positions, cu, seq_lens, table, slots)

    def decode(pos):  # rows 0, 1 active at these positions; rows 2, 3 idle
        tokens = np.zeros(BATCH, np.int32)
        tokens[:2] = rng.integers(0, DIMS["vocab_size"], 2)
        positions = np.array([pos[0], pos[1], 0, 0], np.int32)
        seq_lens = np.array([pos[0] + 1, pos[1] + 1, 0, 0], np.int32)
        slots = np.array([slot(0, pos[0]), slot(1, pos[1]), -1, -1], np.int32)
        return ("decode", tokens, positions, seq_lens, bt, slots)

    return [
        prefill([(0, 0, 40), (1, 0, 21)]),
        prefill([(1, 21, 1), (0, 40, 30)]),
        decode((70, 22)),
        decode((71, 23)),
    ]


def _run_jax(tree, cfg, steps, fuse=True):
    params = jax.tree.map(jnp.asarray, tree)
    if fuse:
        params = jax_fuse(params)
    prefill = jax.jit(lambda p, *a: jax_prefill(p, cfg, *a[:3], ROWS, *a[3:]))
    decode = jax.jit(lambda p, *a: jax_decode_step(p, cfg, *a))
    kc = jax_init_cache(cfg, NUM_PAGES, PS)
    vc = jnp.zeros((0,), jnp.float32)
    logits = []
    for kind, *arrays in steps:
        fn = prefill if kind == "prefill" else decode
        out, kc, vc = fn(params, *map(jnp.asarray, arrays), kc, vc)
        logits.append(np.asarray(out))
    return logits, np.asarray(kc)


def _run_port(params, cfg, steps, fuse=True):
    if fuse:
        params = fuse_deepseek_params(params)
    kc = init_deepseek_kv_cache(cfg, NUM_PAGES, PS, device="cpu")
    vc = torch.zeros((0,), dtype=torch.float32)
    logits = []
    for kind, *arrays in steps:
        tensors = [torch.from_numpy(a) for a in arrays]
        if kind == "prefill":
            out, kc_out, vc_out = deepseek_prefill(params, cfg, *tensors[:3], ROWS, *tensors[3:], kc, vc)
        else:
            out, kc_out, vc_out = deepseek_decode_step(params, cfg, *tensors, kc, vc)
        assert kc_out is kc and vc_out is vc  # updated in place; v_caches untouched
        logits.append(out.numpy())
    return logits, kc.numpy()


# The served layout (fused), the unfused projections of both MLPs and
# the query, and V2's low-rank query path (wq_a -> q_a_norm -> wq_b).
VARIANTS = {"fused": ({}, True), "unfused": ({}, False), "q_lora": ({"q_lora_rank": 48}, True)}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_deepseek_step_logits_match_jax(variant):
    over, fuse = VARIANTS[variant]
    tree, jax_cfg = _numpy_params(**over)
    cfg = DeepseekV2Config(**DIMS, **over, dtype=torch.float32)
    params = deepseek_params_from_jax(tree, cfg, device="cpu")
    steps = _steps()
    jax_logits, jax_kc = _run_jax(tree, jax_cfg, steps, fuse)
    logits, kc = _run_port(params, cfg, steps, fuse)
    for i, (ours, ref) in enumerate(zip(logits, jax_logits)):
        assert ours.dtype == np.float32 and ours.shape == ref.shape == (BATCH, DIMS["vocab_size"])
        np.testing.assert_allclose(ours, ref, atol=TOL, rtol=TOL, err_msg=f"step {i}")
    np.testing.assert_allclose(kc, jax_kc, atol=TOL, rtol=TOL)
    if variant == "fused":  # the capacity cut is live: with room for every token the logits move
        roomy = dataclasses.replace(cfg, moe_capacity_factor=100.0)
        assert not np.allclose(_run_port(params, roomy, steps)[0][0], logits[0], atol=TOL, rtol=TOL)


def test_params_carry_across_and_init_schema_matches_jax():
    """``deepseek_params_from_jax`` is bit for bit; the port's own random
    init has the JAX schema (keys, shapes, dtypes, projection kinds)."""
    cfg = DeepseekV2Config(**DIMS)
    jax_cfg = JaxDeepseekV2Config(**DIMS)
    tree = jax.tree.map(np.asarray, jax_init_params(2, jax_cfg))
    params = deepseek_params_from_jax(tree, cfg, device="cpu")
    np.testing.assert_array_equal(_tensor_bits(params["layers_moe"]["e_up"]), _array_bits(tree["layers_moe"]["e_up"]))
    np.testing.assert_array_equal(params["rope_cache"].numpy(), tree["rope_cache"])
    ours = init_deepseek_params(0, cfg, device="cpu")
    for stack in ("layers_dense", "layers_moe"):
        assert set(ours[stack]) == set(tree[stack])
        for name, ref in tree[stack].items():
            got = ours[stack][name]
            if hasattr(ref, "arrays"):
                assert got.kind == ref.kind and got.arrays["w"].shape == ref.arrays["w"].shape
                assert got.arrays["w"].dtype == torch.bfloat16
            else:
                assert tuple(got.shape) == ref.shape and got.dtype == params[stack][name].dtype, name
    assert tuple(ours["embedding"].shape) == tree["embedding"].shape
    np.testing.assert_array_equal(ours["rope_cache"].numpy(), tree["rope_cache"])
    dense_only = DeepseekV2Config(**{**DIMS, "n_routed_experts": 0})
    assert init_deepseek_params(0, dense_only, device="cpu")["layers_moe"] is None


def test_unported_modes_raise():
    cfg = DeepseekV2Config(**DIMS, dtype=torch.float32)
    # The quantized modes, once refused, are served (tests/test_torch_deepseek_quant.py);
    # a mode the port does not know still raises and names it.
    with pytest.raises(ValueError, match="Unknown quantization mode: int3"):
        init_deepseek_params(0, cfg, quant_mode="int3", device="cpu")
    # deepseek_verify_forward, once a stub, is ported (tests/test_torch_verify_forward.py);
    # LoRA serves the Llama family only: the JAX DeepSeek steps take no adapters.
    with pytest.raises(NotImplementedError, match="DeepSeek takes no LoRA"):
        deepseek_verify_forward(None, cfg, *[None] * 9, lora={})
    params = init_deepseek_params(0, cfg, device="cpu")
    int8_cache = init_deepseek_kv_cache(cfg, 4, PS, dtype=torch.int8, device="cpu")
    one = torch.zeros(1, dtype=torch.int32)
    step = (params, cfg, one, one, one + 1, torch.zeros((1, 2), dtype=torch.int32), one, int8_cache, torch.zeros(0))
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        deepseek_decode_step(*step, tp_axis="tp")
    # int8 latent caches, once refused, are served: the row is stored at
    # slot 0 in int8 and the logits are finite.
    logits, cache, _ = deepseek_decode_step(*step)
    assert logits.shape == (1, cfg.vocab_size) and torch.isfinite(logits).all()
    assert cache is int8_cache and cache.dtype == torch.int8 and cache[:, 0, 0].abs().sum() > 0
