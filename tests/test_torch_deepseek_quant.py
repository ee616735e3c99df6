# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""DeepSeek-V2 with quantized projections: the port against the JAX package.

The tiny MoE model of tests/deepseek_test.py:162 (2 layers: 1 dense, 1 MoE
of 4 experts, top 2; f32 activations), with 2 shared experts so that every
projection's K is a multiple of nf4's block of 64 (with 1, shared_down's K
is 32, which the nf4 quantizer refuses in both packages). For each mode,
one set of JAX params (``conch_tpu.models.deepseek.init_deepseek_params(0,
..., quant_mode=mode, group_size=32)``: int4 and int8 at DeepSeek's group
32, nf4 at blocksize 64, w8a8; wq, w_kv_a, wo, the dense MLP, the shared
experts and lm_head in the mode) is carried over with
``deepseek_params_from_jax``, bit for bit. Then:

- ``fuse_deepseek_params`` fuses what the JAX package's fuses: int4 pads
  every N of this model at pack time, so nothing fuses; int8 and w8a8
  fuse [wq|w_kv_a], the dense gate|up and the shared gate|up; nf4 pins a
  ``shape`` and fuses nothing;
- one prefill step and one decode step give the JAX package's logits and
  latent cache within 2e-3 (int4, int8, nf4) and 2e-2 (w8a8), the
  tolerances of tests/test_torch_llama_quant.py and for its reason (w8a8's
  per-row activation codes flip at half-way points under a different
  summation order);
- the port's own on-device init quantizes each float32 draw exactly as the
  JAX package's ``quantize_linear`` does with the same arguments;
- ``requantize_deepseek_params`` of a bf16 tree equals the JAX package's bit
  for bit, lm_head's mode included (bf16 in int4, where the native init
  stores int4).

The int8 engine is held to JAX's in tests/test_torch_deepseek_int8_engine.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.models.deepseek import DeepseekV2Config as JaxDeepseekV2Config
from conch_tpu.models.deepseek import deepseek_decode_step as jax_decode_step
from conch_tpu.models.deepseek import deepseek_prefill as jax_prefill
from conch_tpu.models.deepseek import fuse_deepseek_params as jax_fuse
from conch_tpu.models.deepseek import init_deepseek_kv_cache as jax_init_cache
from conch_tpu.models.deepseek import init_deepseek_params as jax_init_params
from conch_tpu.models.deepseek import requantize_deepseek_params as jax_requantize
from conch_tpu.models.linear import quantize_linear as jax_quantize_linear
from conch_tpu_torch.models import deepseek as port_deepseek
from conch_tpu_torch.models.deepseek import (
    DeepseekV2Config,
    deepseek_decode_step,
    deepseek_params_from_jax,
    deepseek_prefill,
    fuse_deepseek_params,
    init_deepseek_kv_cache,
    init_deepseek_params,
    requantize_deepseek_params,
)
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

DIMS = {
    "vocab_size": 128, "hidden_size": 64, "num_layers": 2, "num_heads": 4, "kv_lora_rank": 32,
    "qk_rope_head_dim": 16, "qk_nope_head_dim": 32, "v_head_dim": 32, "n_routed_experts": 4,
    "n_shared_experts": 2, "num_experts_per_tok": 2, "moe_intermediate_size": 32, "intermediate_size": 64,
    "first_k_dense_replace": 1, "moe_capacity_factor": 100.0,
}
GROUP = 32
MODES = ("int4", "int8", "nf4", "w8a8")
KINDS = {"int4": "int4", "int8": "int8_grouped", "nf4": "nf4", "w8a8": "w8a8"}
TOL = {"int4": 2e-3, "int8": 2e-3, "nf4": 2e-3, "w8a8": 2e-2}
PS, NUM_PAGES, ROWS, BATCH, MAX_PAGES = 16, 16, 64, 4, 6
PAGES = [[3, 7, 1, 9, 10], [0, 5]]
# Projections of each stack, in the order the port's init draws them.
STACK_PROJECTIONS = {
    "layers_dense": ("w_kv_a", "wo", "wq", "w_gate", "w_up", "w_down"),
    "layers_moe": ("w_kv_a", "wo", "wq", "shared_gate", "shared_up", "shared_down"),
}
FUSED = {
    "layers_dense": {"wq_kva": ("wq", "w_kv_a"), "w_gateup": ("w_gate", "w_up")},
    "layers_moe": {"wq_kva": ("wq", "w_kv_a"), "shared_gateup": ("shared_gate", "shared_up")},
}


def _kwargs(mode: str) -> dict:
    return {"group_size": GROUP} if mode in ("int4", "int8") else {}


def _bits(a) -> np.ndarray:
    """An array's bits (bf16 as uint16), for exact comparison."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_same_projection(ours, ref) -> None:
    assert ours.kind == ref.kind and ours.meta == dict(ref.meta)
    assert sorted(ours.arrays) == sorted(ref.arrays)
    for name, arr in ref.arrays.items():
        np.testing.assert_array_equal(_bits(ours.arrays[name]), _bits(arr), err_msg=name)


@pytest.fixture(scope="module", params=MODES)
def jax_params(request):
    mode = request.param
    cfg = JaxDeepseekV2Config(**DIMS, dtype=jnp.float32)
    params = jax_init_params(0, cfg, quant_mode=mode, **_kwargs(mode))
    return mode, cfg, params, jax.tree.map(np.asarray, params)


def _steps():
    """A prefill of two fresh prompts (40 and 21 tokens, 3 padding rows, 2
    zero-length padding sequences), then a decode step with 2 idle rows."""
    rng = np.random.default_rng(4)
    bt = np.zeros((BATCH, MAX_PAGES), np.int32)
    for b, pages in enumerate(PAGES):
        bt[b, : len(pages)] = pages

    def slot(b, pos):
        return PAGES[b][pos // PS] * PS + pos % PS

    lens = [40, 21]
    tokens = np.zeros(ROWS, np.int32)
    positions = np.zeros(ROWS, np.int32)
    slots = np.full(ROWS, -1, np.int32)
    tokens[:61] = rng.integers(0, DIMS["vocab_size"], 61)
    positions[:61] = np.concatenate([np.arange(n) for n in lens])
    slots[:61] = [slot(b, p) for b, n in enumerate(lens) for p in range(n)]
    cu = np.array([0, 40, 61, 61, 61], np.int32)
    seq_lens = np.array([40, 21, 0, 0], np.int32)
    prefill = ("prefill", tokens, positions, cu, seq_lens, bt, slots)
    decode = (
        "decode", np.array([5, 9, 0, 0], np.int32), np.array([40, 21, 0, 0], np.int32),
        np.array([41, 22, 0, 0], np.int32), bt, np.array([slot(0, 40), slot(1, 21), -1, -1], np.int32),
    )
    return [prefill, decode]


def test_params_carry_bit_for_bit_and_fuse_as_jax(jax_params):
    mode, _, params, numpy_params = jax_params
    cfg = DeepseekV2Config(**DIMS, dtype=torch.float32)
    ported = deepseek_params_from_jax(numpy_params, cfg, device="cpu")
    for stack, names in STACK_PROJECTIONS.items():
        for name in names:
            assert ported[stack][name].kind == KINDS[mode]
            _assert_same_projection(ported[stack][name], params[stack][name])
        for name in ("w_uk", "w_uv", *(("e_gate", "e_up", "e_down") if stack == "layers_moe" else ())):
            assert isinstance(ported[stack][name], torch.Tensor)  # the einsum operands stay dense
    assert ported["lm_head"].kind == KINDS[mode]
    _assert_same_projection(ported["lm_head"], params["lm_head"])
    ours, ref = fuse_deepseek_params(ported), jax_fuse(params)
    for stack, fused in FUSED.items():
        assert sorted(ours[stack]) == sorted(ref[stack])
        for name in fused:
            assert (name in ours[stack]) == (mode in ("int8", "w8a8"))
            if name in ref[stack]:
                _assert_same_projection(ours[stack][name], ref[stack][name])


def test_step_logits_and_latent_cache_match_jax(jax_params):
    mode, jax_cfg, params, numpy_params = jax_params
    cfg = DeepseekV2Config(**DIMS, dtype=torch.float32)
    ported = fuse_deepseek_params(deepseek_params_from_jax(numpy_params, cfg, device="cpu"))
    jparams = jax_fuse(params)
    jprefill = jax.jit(lambda p, *a: jax_prefill(p, jax_cfg, *a[:3], ROWS, *a[3:]))
    jdecode = jax.jit(lambda p, *a: jax_decode_step(p, jax_cfg, *a))
    jkc, jvc = jax_init_cache(jax_cfg, NUM_PAGES, PS), jnp.zeros((0,), jnp.float32)
    kc, vc = init_deepseek_kv_cache(cfg, NUM_PAGES, PS, device="cpu"), torch.zeros((0,), dtype=torch.float32)
    for kind, *arrays in _steps():
        tensors = [torch.from_numpy(a) for a in arrays]
        if kind == "prefill":
            ref, jkc, jvc = jprefill(jparams, *map(jnp.asarray, arrays), jkc, jvc)
            out, _, _ = deepseek_prefill(ported, cfg, *tensors[:3], ROWS, *tensors[3:], kc, vc)
        else:
            ref, jkc, jvc = jdecode(jparams, *map(jnp.asarray, arrays), jkc, jvc)
            out, _, _ = deepseek_decode_step(ported, cfg, *tensors, kc, vc)
        assert out.dtype == torch.float32 and out.shape == (BATCH, DIMS["vocab_size"])
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL[mode], rtol=TOL[mode],
                                   err_msg=f"{mode} {kind}")
    np.testing.assert_allclose(kc.numpy(), np.asarray(jkc), atol=TOL[mode], rtol=TOL[mode])


@pytest.mark.parametrize("mode", MODES)
def test_init_on_device_quantizes_as_jax(mode, monkeypatch):
    """Every float32 draw the port's init quantizes, quantized by the JAX
    package's ``quantize_linear`` with the same arguments, gives the port's
    stored arrays bit for bit (each layer of each stack, and lm_head, which
    the native init stores in the mode, int4 included)."""
    seen = []
    original = port_deepseek.quantize_linear

    def recording(w, quant_mode, **kwargs):
        out = original(w, quant_mode, **kwargs)
        seen.append((w.clone(), quant_mode, kwargs, out))
        return out

    monkeypatch.setattr(port_deepseek, "quantize_linear", recording)
    params = init_deepseek_params(0, DeepseekV2Config(**DIMS), quant_mode=mode, device="cpu")
    assert len(seen) == sum(map(len, STACK_PROJECTIONS.values())) + 1  # one layer a stack, then lm_head
    for w, quant_mode, kwargs, out in seen:
        assert quant_mode == mode and kwargs == _kwargs(mode)
        _assert_same_projection(out, jax_quantize_linear(w.numpy(), quant_mode, **kwargs))
    per_layer = iter(out for _, _, _, out in seen)
    for stack, names in STACK_PROJECTIONS.items():
        for name in names:
            piece = next(per_layer)
            assert params[stack][name].kind == KINDS[mode] and params[stack][name].meta == piece.meta
            for key, arr in piece.arrays.items():
                assert torch.equal(params[stack][name].arrays[key][0], arr)
    assert params["lm_head"] is seen[-1][3] and params["lm_head"].kind == KINDS[mode]


@pytest.mark.parametrize("mode", MODES)
def test_requantize_matches_jax_and_native_layout(mode):
    cfg = JaxDeepseekV2Config(**DIMS, dtype=jnp.float32)
    dense = jax_init_params(1, cfg, quant_mode="bf16")
    ref = jax_requantize(dense, cfg, mode, group_size=GROUP)
    port_cfg = DeepseekV2Config(**DIMS)
    carried = deepseek_params_from_jax(jax.tree.map(np.asarray, dense), port_cfg, "cpu")
    ported = requantize_deepseek_params(carried, port_cfg, mode, group_size=GROUP)
    native = init_deepseek_params(0, port_cfg, quant_mode=mode, device="cpu")
    for stack, names in STACK_PROJECTIONS.items():
        for name in names:
            ours, nat = ported[stack][name], native[stack][name]
            _assert_same_projection(ours, ref[stack][name])
            assert ours.kind == nat.kind and ours.meta == nat.meta
            assert {k: (v.shape, v.dtype) for k, v in ours.arrays.items()} == {
                k: (v.shape, v.dtype) for k, v in nat.arrays.items()
            }
        assert ported[stack]["w_uk"] is carried[stack]["w_uk"]  # the einsum operands stay dense, untouched
    _assert_same_projection(ported["lm_head"], ref["lm_head"])
    # int4: the JAX package's requantization keeps lm_head bf16, its native init quantizes it.
    assert ported["lm_head"].kind == ("dense" if mode == "int4" else KINDS[mode])
    assert native["lm_head"].kind == KINDS[mode]
    with pytest.raises(ValueError, match="requantize needs dense params"):
        requantize_deepseek_params(native, port_cfg, mode)  # already quantized
