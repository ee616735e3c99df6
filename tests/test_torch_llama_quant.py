# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""The int8, nf4 and w8a8 Llama end to end: the port against the JAX package.

For each mode, one set of JAX params (``conch_tpu.models.llama.
init_llama_params(0, ..., quant_mode=mode)``: 2 layers, hidden 256, 4
query heads / 1 KV head, head_dim 128, f32 activations, every projection
and lm_head in the mode) is carried over with ``params_from_jax``, bit for
bit. Then:

- one prefill step and one decode step give the JAX package's logits and
  KV pool within 2e-3 (atol and rtol, as tests/test_torch_llama_int4.py)
  for int8 and nf4. w8a8 is held at 2e-2: its dynamic per-row activation
  quantization rounds to whole int8 steps, so an f32 difference of one
  ulp in a projection's input (summation order) can flip a code at a
  half-way point and move that projection's output by a_scale * w, and
  the flips spread to the logits (one ulp of noise on the norms moves
  them by 1.6% of max |logit| in w8a8 and by less than 0.01% in int8:
  ``python3 -m conch_tpu_torch.tools.w8a8_sensitivity``).
  ``QuantizedLinear.apply`` itself matches the JAX package's w8a8 product
  exactly (tests/test_torch_scaled_gemm.py);
- QKV and gate|up fuse for int8 and w8a8 and stay apart for nf4, as in JAX;
- the port's own on-device init quantizes its float32 draws exactly as the
  JAX package's quantizers do (every projection checked bit for bit);
- ``requantize_llama_params`` of a bf16 tree equals the JAX package's, bit
  for bit, with the layout of a native init.

The engines are held to each other in tests/test_torch_llama_{int8,nf4,
w8a8}_engine.py, one file a mode, so that none passes about two minutes on
one test worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.models.linear import quantize_linear as jax_quantize_linear
from conch_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from conch_tpu.models.llama import fuse_llama_params as jax_fuse
from conch_tpu.models.llama import init_kv_caches as jax_init_kv_caches
from conch_tpu.models.llama import init_llama_params as jax_init_llama_params
from conch_tpu.models.llama import llama_decode_step as jax_decode_step
from conch_tpu.models.llama import llama_prefill as jax_prefill
from conch_tpu.models.llama import requantize_llama_params as jax_requantize
from conch_tpu_torch.models import llama as port_llama
from conch_tpu_torch.models.llama import (
    LlamaConfig,
    fuse_llama_params,
    init_kv_caches,
    init_llama_params,
    llama_decode_step,
    llama_prefill,
    params_from_jax,
    requantize_llama_params,
)
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

DIMS = {
    "vocab_size": 256, "hidden_size": 256, "intermediate_size": 512, "num_layers": 2,
    "num_heads": 4, "num_kv_heads": 1, "head_dim": 128,
}
TOL = {"int8": 2e-3, "nf4": 2e-3, "w8a8": 2e-2}
PS, NUM_PAGES, ROWS, BATCH, MAX_PAGES = 16, 16, 64, 4, 6
PAGES = [[3, 7, 1, 9, 10], [0, 5]]
PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
MODES = ("int8", "nf4", "w8a8")
KINDS = {"int8": "int8_grouped", "nf4": "nf4", "w8a8": "w8a8"}


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
    cfg = JaxLlamaConfig(**DIMS, dtype=jnp.float32)
    params = jax_init_llama_params(0, cfg, quant_mode=mode)
    return mode, cfg, params, jax.tree.map(np.asarray, params)


def _steps():
    """A prefill of two fresh prompts (40 and 21 tokens, 3 padding rows,
    2 zero-length padding sequences), then a decode step with 2 idle rows."""
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
    tokens[:61] = rng.integers(0, 256, 61)
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
    cfg = LlamaConfig(**DIMS, dtype=torch.float32)
    ported = params_from_jax(numpy_params, cfg, device="cpu")
    for name in PROJECTIONS:
        assert ported["layers"][name].kind == KINDS[mode]
        _assert_same_projection(ported["layers"][name], params["layers"][name])
    _assert_same_projection(ported["lm_head"], params["lm_head"])
    ours, ref = fuse_llama_params(ported)["layers"], jax_fuse(params)["layers"]
    assert sorted(ours) == sorted(ref)
    assert ("wqkv" in ours) == (mode != "nf4")
    for name in ("wqkv", "w_gateup"):
        if name in ref:
            _assert_same_projection(ours[name], ref[name])


def test_step_logits_and_kv_pool_match_jax(jax_params):
    mode, jax_cfg, params, numpy_params = jax_params
    cfg = LlamaConfig(**DIMS, dtype=torch.float32)
    ported = fuse_llama_params(params_from_jax(numpy_params, cfg, device="cpu"))
    jparams = jax_fuse(params)
    jprefill = jax.jit(lambda p, *a: jax_prefill(p, jax_cfg, *a[:3], ROWS, *a[3:]))
    jdecode = jax.jit(lambda p, *a: jax_decode_step(p, jax_cfg, *a))
    jkc, jvc = jax_init_kv_caches(jax_cfg, NUM_PAGES, PS)
    kc, vc = init_kv_caches(cfg, NUM_PAGES, PS, device="cpu")
    for kind, *arrays in _steps():
        tensors = [torch.from_numpy(a) for a in arrays]
        if kind == "prefill":
            ref, jkc, jvc = jprefill(jparams, *map(jnp.asarray, arrays), jkc, jvc)
            out, _, _ = llama_prefill(ported, cfg, *tensors[:3], ROWS, *tensors[3:], kc, vc)
        else:
            ref, jkc, jvc = jdecode(jparams, *map(jnp.asarray, arrays), jkc, jvc)
            out, _, _ = llama_decode_step(ported, cfg, *tensors, kc, vc)
        assert out.dtype == torch.float32 and out.shape == (BATCH, DIMS["vocab_size"])
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL[mode], rtol=TOL[mode],
                                   err_msg=f"{mode} {kind}")
    np.testing.assert_allclose(kc.numpy(), np.asarray(jkc), atol=TOL[mode], rtol=TOL[mode])
    np.testing.assert_allclose(vc.numpy(), np.asarray(jvc), atol=TOL[mode], rtol=TOL[mode])


@pytest.mark.parametrize("mode", MODES)
def test_init_on_device_quantizes_as_jax(mode, monkeypatch):
    """Every float32 draw the port's init quantizes, quantized by the JAX
    package's ``quantize_linear`` with the same arguments, gives the port's
    stored arrays bit for bit (each layer of each stack, and lm_head)."""
    seen = []
    original = port_llama.quantize_linear

    def recording(w, quant_mode, **kwargs):
        out = original(w, quant_mode, **kwargs)
        seen.append((w.clone(), quant_mode, kwargs, out))
        return out

    monkeypatch.setattr(port_llama, "quantize_linear", recording)
    cfg = LlamaConfig(**DIMS, dtype=torch.bfloat16)
    params = init_llama_params(0, cfg, quant_mode=mode, device="cpu")
    assert len(seen) == len(PROJECTIONS) * DIMS["num_layers"] + 1
    layer_kwargs = {"int8": {"group_size": 128}, "nf4": {"blocksize": 64}, "w8a8": {}}[mode]
    head_kwargs = {"group_size": 128} if mode == "int8" else {}  # nf4's lm_head: the default blocksize
    for i, (w, quant_mode, kwargs, out) in enumerate(seen):
        assert quant_mode == mode and kwargs == (head_kwargs if i == len(seen) - 1 else layer_kwargs)
        _assert_same_projection(out, jax_quantize_linear(w.numpy(), quant_mode, **kwargs))
    per_layer = iter(out for _, _, _, out in seen)
    for name in PROJECTIONS:
        stack = params["layers"][name]
        for layer in range(DIMS["num_layers"]):
            piece = next(per_layer)
            for key, arr in piece.arrays.items():
                assert torch.equal(stack.arrays[key][layer], arr)
    assert params["lm_head"] is seen[-1][3]


@pytest.mark.parametrize("mode", (*MODES, "int4"))
def test_requantize_matches_jax_and_native_layout(mode):
    cfg = JaxLlamaConfig(**DIMS, dtype=jnp.float32)
    dense = jax_init_llama_params(1, cfg, quant_mode="bf16")
    ref = jax_requantize(dense, cfg, mode)
    ported = requantize_llama_params(params_from_jax(jax.tree.map(np.asarray, dense), LlamaConfig(**DIMS), "cpu"),
                                     LlamaConfig(**DIMS), mode)
    native = init_llama_params(0, LlamaConfig(**DIMS), quant_mode=mode, device="cpu")
    for name in (*PROJECTIONS, "lm_head"):
        ours = ported[name] if name == "lm_head" else ported["layers"][name]
        _assert_same_projection(ours, ref[name] if name == "lm_head" else ref["layers"][name])
        nat = native[name] if name == "lm_head" else native["layers"][name]
        assert ours.kind == nat.kind and ours.meta == nat.meta
        assert {k: (v.shape, v.dtype) for k, v in ours.arrays.items()} == {
            k: (v.shape, v.dtype) for k, v in nat.arrays.items()
        }
    with pytest.raises(ValueError):
        requantize_llama_params(native, LlamaConfig(**DIMS), mode)  # already quantized


@pytest.mark.parametrize("mode", (*MODES, "int4", "bf16"))
def test_take_layer_applies_as_the_stack(mode):
    """``take_layer`` gives each layer as views, whose ``apply`` equals
    ``apply_stacked`` at that layer exactly."""
    params = init_llama_params(0, LlamaConfig(**DIMS), quant_mode=mode, device="cpu")
    rng = np.random.default_rng(9)
    for name, k in (("wq", DIMS["hidden_size"]), ("w_down", DIMS["intermediate_size"])):
        stack = params["layers"][name]
        x = torch.from_numpy(rng.normal(size=(5, k)).astype(np.float32))
        for layer in range(DIMS["num_layers"]):
            one = stack.take_layer(layer)
            assert one.kind == stack.kind and one.meta == stack.meta
            assert all(v.data_ptr() == stack.arrays[a][layer].data_ptr() for a, v in one.arrays.items())
            torch.testing.assert_close(one.apply(x), stack.apply_stacked(x, layer), rtol=0, atol=0)
