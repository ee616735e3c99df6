# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Mixtral step by step: the port's ``mixtral_prefill`` /
``mixtral_decode_step`` logits and KV caches against the JAX package's,
on JAX params carried across with ``moe_params_from_jax`` (bit for bit)
and fused on both sides.

The model is tests/moe_test.py's ``_tiny_cfg`` (2 layers, hidden 64,
4 experts, top 2) with the capacity factor cut to 0.5, so that every MoE
layer drops selections: capacity 8 of a 32-row prefill step's 64, 1 of a
4-row decode step's 8. Each case runs a 32-row prefill of two prompts (20
and 12 tokens; zero-length padding sequences) and two decode steps with
two idle rows, for bf16 weights in f32, int4 attention projections in
bf16 and bf16 weights in f32 over an int8 KV cache.

A prefill step with padding rows (20 and 9 tokens in 32 rows) is held
against the same JAX layer step with the padding rows' attention output
zero, as K7 and its plain version write it: JAX's varlen launcher gathers
those rows out of range, which gives NaN (``jnp.take``'s fill), the NaN
reaches every row through the dispatch einsum, and JAX's own
``mixtral_prefill`` returns NaN logits there (asserted below; ROADMAP
Queue 3). The padding rows route their token's embedding and take
capacity, so their token ids change the live rows' logits.

Tolerances: logits 2e-3 absolute and relative in f32 (the attention ops'
tolerance, tests/paged_attention_test.py:21), 3e-2 x max |logit| in bf16;
caches as tests/test_torch_kv_quant_models.py holds them (int8 codes
within one step on at most 0.1% of entries).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conch_tpu.models.llama as jax_llama
import conch_tpu.models.moe as jax_moe
import conch_tpu_torch.models.llama as llama
import conch_tpu_torch.models.moe as moe
from conch_tpu.ops.attention import varlen_attention as jax_varlen_attention
from conch_tpu.ops.normalization import rms_norm as jax_rms_norm
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

DIMS = {"vocab_size": 64, "hidden_size": 64, "intermediate_size": 128, "num_layers": 2, "num_heads": 2,
        "num_kv_heads": 1, "head_dim": 32, "max_position": 128}
MOE = {"num_experts": 4, "top_k": 2, "capacity_factor": 0.5}
PS, NUM_PAGES, ROWS, BATCH, MAX_PAGES = 8, 16, 32, 4, 4
PAGES = [[3, 7, 1], [0, 5]]  # page 0 is a real page
# (weights, activation dtype, KV cache dtype; None: the activation dtype)
CASES = {
    "bf16-f32": ("bf16", "float32", None),
    "int4-bf16": ("int4", "bfloat16", None),
    "bf16-f32-kv-int8": ("bf16", "float32", "int8"),
}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
_JITTED: dict = {}


def _configs(dtype: str):
    jax_cfg = jax_moe.MoEConfig(llama=jax_llama.LlamaConfig(**DIMS, dtype=JAX_DTYPES[dtype]), **MOE)
    return jax_cfg, moe.MoEConfig(llama=llama.LlamaConfig(**DIMS, dtype=TORCH_DTYPES[dtype]), **MOE)


def _params(quant_mode: str, dtype: str, seed: int = 0):
    """(JAX params, the port's params), both fused, from one JAX init."""
    jax_cfg, cfg = _configs(dtype)
    numpy_params = jax.tree.map(np.asarray, jax_moe.init_moe_params(seed, jax_cfg, quant_mode))
    jax_params = jax_llama.fuse_llama_params(jax.tree.map(jnp.asarray, numpy_params))
    return jax_params, llama.fuse_llama_params(moe.moe_params_from_jax(numpy_params, cfg, device="cpu"))


def _slot(b: int, pos: int) -> int:
    return PAGES[b][pos // PS] * PS + pos % PS


def _prefill(q_lens: tuple[int, int], seed: int = 5, pad_token: int = 0):
    """A prefill step of two fresh prompts, as the engine builds it."""
    rng = np.random.default_rng(seed)
    total = sum(q_lens)
    bt = np.zeros((BATCH, MAX_PAGES), np.int32)
    for b, pages in enumerate(PAGES):
        bt[b, : len(pages)] = pages
    tokens = np.full(ROWS, pad_token, np.int32)
    tokens[:total] = rng.integers(0, DIMS["vocab_size"], total)
    positions = np.zeros(ROWS, np.int32)
    positions[:total] = np.concatenate([np.arange(n) for n in q_lens])
    slots = np.full(ROWS, -1, np.int32)
    slots[:total] = [_slot(b, p) for b, n in enumerate(q_lens) for p in range(n)]
    cu = np.array([0, q_lens[0], total, total, total], np.int32)
    seq_lens = np.array([*q_lens, 0, 0], np.int32)
    return ("prefill", tokens, positions, cu, seq_lens, bt, slots)


def _steps():
    steps = [_prefill((20, 12))]
    rng = np.random.default_rng(6)
    bt = steps[0][5]
    for pos in ((20, 12), (21, 13)):  # rows 0, 1 active; rows 2, 3 idle
        tokens = np.zeros(BATCH, np.int32)
        tokens[:2] = rng.integers(0, DIMS["vocab_size"], 2)
        steps.append((
            "decode", tokens, np.array([pos[0], pos[1], 0, 0], np.int32),
            np.array([pos[0] + 1, pos[1] + 1, 0, 0], np.int32), bt,
            np.array([_slot(0, pos[0]), _slot(1, pos[1]), -1, -1], np.int32),
        ))
    return steps


def _jax_prefill_padding_zeroed(params, cfg, token_ids, positions, cu, seq_lens, bt, slots, kc, vc):
    """JAX's ``mixtral_prefill`` (conch_tpu/models/moe.py:329) with one
    change: the attention output of rows past ``cu[batch]`` is zero."""
    c = cfg.llama
    live = jnp.arange(token_ids.shape[0]) < cu[-1]

    def attn_fn(q, k_caches, v_caches, layer):
        out = jax_varlen_attention(q, k_caches, v_caches, cu, ROWS, seq_lens, ROWS, bt, causal=True, layer_idx=layer)
        return jnp.where(live[:, None, None], out, 0)

    heavy, light = jax_llama._split_heavy(params["layers"])
    step = jax_llama._layer_step_factory(
        c, attn_fn, params["cos_sin_cache"], positions, slots, num_heads=c.num_heads, num_kv_heads=c.num_kv_heads,
        mlp_fn=jax_moe._moe_mlp_fn(cfg, cfg.capacity(token_ids.shape[0]), None), cache_mode="scatter", heavy=heavy,
    )
    hidden = jnp.take(params["embedding"], token_ids, axis=0)
    (hidden, kc, vc), _ = jax.lax.scan(step, (hidden, kc, vc), (light, jnp.arange(c.num_layers)))
    hidden = jax_rms_norm(jnp.take(hidden, cu[1:] - 1, axis=0), params["final_norm"], c.rms_norm_eps)
    return params["lm_head"].apply(hidden).astype(jnp.float32), kc, vc


def _jitted(cfg, kind: str):
    """One jitted JAX step per (config, kind), shared by the tests."""
    key = (cfg, kind)
    if key not in _JITTED:
        if kind == "prefill":
            fn = jax.jit(lambda p, *a: jax_moe.mixtral_prefill(p, cfg, *a[:3], ROWS, *a[3:]))
        elif kind == "decode":
            fn = jax.jit(lambda p, *a: jax_moe.mixtral_decode_step(p, cfg, *a))
        else:
            fn = jax.jit(lambda p, *a: _jax_prefill_padding_zeroed(p, cfg, *a))
        _JITTED[key] = fn
    return _JITTED[key]


def _run_jax(params, cfg, steps, caches, kinds=None):
    kc, vc = caches
    logits = []
    for i, (kind, *arrays) in enumerate(steps):
        out, kc, vc = _jitted(cfg, kinds[i] if kinds else kind)(params, *map(jnp.asarray, arrays), kc, vc)
        logits.append(np.asarray(out))
    return logits, [np.asarray(kc), np.asarray(vc)]


def _run_port(params, cfg, steps, caches):
    kc, vc = caches
    logits = []
    for kind, *arrays in steps:
        t = [torch.from_numpy(a) for a in arrays]
        if kind == "prefill":
            out, _, _ = moe.mixtral_prefill(params, cfg, *t[:3], ROWS, *t[3:], kc, vc)
        else:
            out, _, _ = moe.mixtral_decode_step(params, cfg, *t, kc, vc)
        logits.append(out.numpy())
    return logits, [kc, vc]


def _caches(jax_cfg, cfg, cache):
    jd, td = (JAX_DTYPES[cache], TORCH_DTYPES[cache]) if cache else (None, None)
    return (jax_moe.init_moe_kv_caches(jax_cfg, NUM_PAGES, PS, cache_dtype=jd),
            moe.init_moe_kv_caches(cfg, NUM_PAGES, PS, cache_dtype=td, device="cpu"))


def _compare(port, ref, dtype: str) -> None:
    (logits, caches), (jax_logits, jax_caches) = port, ref
    for i, (ours, want) in enumerate(zip(logits, jax_logits)):
        assert ours.shape == want.shape and np.isfinite(ours).all() and np.isfinite(want).all()
        if dtype == "float32":
            np.testing.assert_allclose(ours, want, atol=2e-3, rtol=2e-3, err_msg=f"step {i}")
        else:
            err = np.abs(ours - want).max()
            assert err <= 3e-2 * np.abs(want).max(), (i, err, np.abs(want).max())
    for ours, want in zip(caches, jax_caches):
        if ours.dtype == torch.int8:
            diff = np.abs(ours.numpy().astype(np.int32) - np.asarray(want).astype(np.int32))
            assert np.abs(ours.numpy()).max() > 0
            for layer, d in enumerate(diff):
                assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (layer, d.max(), (d > 0).mean())
        else:
            tol = 2e-3 if dtype == "float32" else 3e-2
            np.testing.assert_allclose(ours.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


def test_params_from_jax_bit_for_bit():
    jax_cfg, cfg = _configs("bfloat16")
    numpy_params = jax.tree.map(np.asarray, jax_moe.init_moe_params(0, jax_cfg, "int4"))
    params = moe.moe_params_from_jax(numpy_params, cfg, device="cpu")
    layers = params["layers"]
    assert layers["router"].dtype == torch.float32 and layers["router"].shape == (2, 64, 4)
    assert layers["w_gate"].dtype == torch.bfloat16 and layers["w_gate"].shape == (2, 4, 64, 128)
    assert layers["w_down"].shape == (2, 4, 128, 64) and layers["wq"].kind == "int4"
    assert params["lm_head"].kind == "dense"
    for name in ("router", "w_gate", "w_up", "w_down", "input_norm"):
        want = numpy_params["layers"][name]
        got = layers[name].view(torch.uint16).numpy() if layers[name].dtype == torch.bfloat16 else layers[name].numpy()
        np.testing.assert_array_equal(got, want.view(np.uint16) if want.dtype.name == "bfloat16" else want)
    np.testing.assert_array_equal(layers["wq"].arrays["packed"].numpy(), numpy_params["layers"]["wq"].arrays["packed"])
    with pytest.raises(ValueError, match="router"):
        moe.moe_params_from_jax(numpy_params, dataclasses.replace(cfg, num_experts=8), device="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_steps_match_jax(case):
    quant_mode, dtype, cache = CASES[case]
    jax_cfg, cfg = _configs(dtype)
    jax_params, params = _params(quant_mode, dtype)
    # Attention fused as JAX fuses it (int4 here pads wk's N, so neither side fuses); experts raw.
    assert ("wqkv" in params["layers"]) == ("wqkv" in jax_params["layers"]) == (quant_mode == "bf16")
    assert isinstance(params["layers"]["w_gate"], torch.Tensor)
    jax_caches, caches = _caches(jax_cfg, cfg, cache)
    steps = _steps()
    _compare(_run_port(params, cfg, steps, caches), _run_jax(jax_params, jax_cfg, steps, jax_caches), dtype)


def test_padded_prefill_matches_jax_with_padding_rows_zeroed():
    jax_cfg, cfg = _configs("float32")
    jax_params, params = _params("bf16", "float32")
    assert cfg.capacity(ROWS) == 8  # of 64 selections
    logits = {}
    for pad_token in (0, 9):
        step = [_prefill((20, 9), pad_token=pad_token)]
        jax_caches, caches = _caches(jax_cfg, cfg, None)
        port = _run_port(params, cfg, step, caches)
        _compare(port, _run_jax(jax_params, jax_cfg, step, jax_caches, kinds=["padding_zeroed"]), "float32")
        logits[pad_token] = port[0][0]
    # The padding rows route and take capacity: their token ids reach the live rows.
    assert np.abs(logits[0] - logits[9]).max() > 1e-3
    # JAX's own mixtral_prefill gives NaN logits once a step has padding rows.
    jax_logits, _ = _run_jax(jax_params, jax_cfg, [_prefill((20, 9))], _caches(jax_cfg, cfg, None)[0])
    assert np.isnan(jax_logits[0]).all()


def test_decode_capacity_bites():
    """The 4-row decode step (two idle rows) has capacity 1 a expert for 8
    selections, so it drops some: the same steps at capacity factor 4 (no
    drops) give other logits."""
    _, cfg = _configs("float32")
    _, params = _params("bf16", "float32")
    assert cfg.capacity(4) == 1
    roomy = dataclasses.replace(cfg, capacity_factor=4.0)
    steps = _steps()[:2]
    out = {}
    for name, c in (("tight", cfg), ("roomy", roomy)):
        caches = moe.init_moe_kv_caches(c, NUM_PAGES, PS, device="cpu")
        out[name] = _run_port(params, c, steps, caches)[0][1][:2]
    assert np.abs(out["tight"] - out["roomy"]).max() > 1e-3  # capacity 1 drops selections


def test_llama_steps_unchanged_by_the_mlp_hook():
    """``_forward_layers`` without ``mlp_fn`` and with one that calls
    ``mlp_block`` compute the same logits and caches, bit for bit."""
    cfg = llama.LlamaConfig(**DIMS, dtype=torch.float32)
    params = llama.fuse_llama_params(llama.init_llama_params(0, cfg, device="cpu"))

    def gated(layers, layer, x):
        return llama.mlp_block(layers, layer, x, llama.silu_and_mul, llama.silu_and_mul_parts)

    runs = []
    for mlp_fn in (None, gated):
        kc, vc = llama.init_kv_caches(cfg, NUM_PAGES, PS, device="cpu")
        kind, *arrays = _prefill((20, 12))
        t = [torch.from_numpy(a) for a in arrays]
        if mlp_fn is None:
            logits, _, _ = llama.llama_prefill(params, cfg, *t[:3], ROWS, *t[3:], kc, vc)
        else:
            logits = llama.prefill_forward(params, cfg, *t[:3], ROWS, *t[3:], kc, vc, mlp_fn=mlp_fn)
        runs.append((logits, kc, vc))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_steps_refuse_tensor_parallelism():
    _, cfg = _configs("float32")
    _, params = _params("bf16", "float32")
    kc, vc = moe.init_moe_kv_caches(cfg, NUM_PAGES, PS, device="cpu")
    _, *arrays = _steps()[1]
    with pytest.raises(NotImplementedError):
        moe.mixtral_decode_step(params, cfg, *map(torch.from_numpy, arrays), kc, vc, tp_axis="model")


def test_init_moe_params_layout():
    _, cfg = _configs("bfloat16")
    for mode in ("bf16", "int4", "int8", "nf4", "w8a8"):
        params = moe.init_moe_params(0, cfg, quant_mode=mode, device="cpu")
        layers = params["layers"]
        assert layers["router"].dtype == torch.float32 and layers["router"].shape == (2, 64, 4)
        assert layers["w_up"].dtype == torch.bfloat16 and layers["w_up"].shape == (2, 4, 64, 128)
        assert layers["w_down"].shape == (2, 4, 128, 64)
        assert params["lm_head"].kind == "dense" and params["embedding"].dtype == torch.bfloat16
        expect = {"bf16": "dense", "int4": "int4", "int8": "int8_grouped", "nf4": "nf4", "w8a8": "w8a8"}[mode]
        assert all(layers[n].kind == expect for n in ("wq", "wk", "wv", "wo"))
        assert 0.015 < layers["w_gate"].float().std().item() < 0.025
    again = moe.init_moe_params(0, cfg, device="cpu")["layers"]["w_down"]
    assert torch.equal(again, moe.init_moe_params(0, cfg, device="cpu")["layers"]["w_down"])
