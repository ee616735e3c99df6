# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Gemma-2 with quantized projections: the port against the JAX package.

Tiny Gemma-2 of tests/test_torch_gemma.py (2 layers, hidden 128, 4 query
heads / 2 KV heads of 128, sandwich norms, layer 0 local with a 24-token
window, attention softcap 50, final softcap 30; f32 activations; the norm
weights drawn at random, so a dropped weight shows). For each mode, one set
of JAX params (``conch_tpu.models.gemma.init_gemma_params(0, ...,
quant_mode=mode, group_size=group)``: int4 and int8 at groups 128 and 64,
nf4 at blocksize 64, w8a8; every projection in the mode, the logits the
tied bf16 embedding) is carried over with ``gemma_params_from_jax``, bit
for bit. Then:

- ``fuse_llama_params`` (both engines fuse Gemma with it) fuses wqkv and
  gate|up in int4, int8 and w8a8 (Gemma's N are multiples of 128, so int4
  pads nothing) and nothing in nf4, as the JAX package's;
- one prefill step and one decode step give the JAX package's logits and
  KV pool within 2e-3 (int4, int8, nf4) and 2e-2 (w8a8), the tolerances
  of tests/test_torch_llama_quant.py and for its reason, in each mode at
  group 128 (a JAX step pair costs about 20 s of interpret-mode compiling
  a mode, so group 64 is held by the checks above and below, whose
  products tests/test_torch_int4_gemm.py and test_torch_planar_gemm.py
  hold at group 64);
- the port's own on-device init quantizes each float32 draw exactly as the
  JAX package's ``quantize_linear`` does with the same arguments.

The int4 engine is held to JAX's in tests/test_torch_gemma_int4_engine.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.models.gemma import GemmaConfig as JaxGemmaConfig
from conch_tpu.models.gemma import gemma_decode_step as jax_decode_step
from conch_tpu.models.gemma import gemma_prefill as jax_prefill
from conch_tpu.models.gemma import init_gemma_kv_caches as jax_init_kv_caches
from conch_tpu.models.gemma import init_gemma_params as jax_init_gemma_params
from conch_tpu.models.linear import quantize_linear as jax_quantize_linear
from conch_tpu.models.llama import fuse_llama_params as jax_fuse
from conch_tpu_torch.models import gemma as port_gemma
from conch_tpu_torch.models.gemma import (
    GemmaConfig,
    gemma_decode_step,
    gemma_params_from_jax,
    gemma_prefill,
    init_gemma_kv_caches,
    init_gemma_params,
)
from conch_tpu_torch.models.llama import fuse_llama_params
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

DIMS = {
    "vocab_size": 128, "hidden_size": 128, "intermediate_size": 256, "num_layers": 2, "num_heads": 4,
    "num_kv_heads": 2, "head_dim": 128, "max_position": 512, "attn_logit_softcap": 50.0,
    "final_logit_softcap": 30.0, "gemma2": True, "sliding_window": 24, "query_pre_attn_scalar": 64.0,
}
# (mode, group): int4 and int8 at Gemma's default group 128 and at 64.
CASES = (("int4", 128), ("int8", 128), ("nf4", 128), ("w8a8", 128), ("int4", 64), ("int8", 64))
STEP_CASES = CASES[:4]
KINDS = {"int4": "int4", "int8": "int8_grouped", "nf4": "nf4", "w8a8": "w8a8"}
TOL = {"int4": 2e-3, "int8": 2e-3, "nf4": 2e-3, "w8a8": 2e-2}
PS, NUM_PAGES, ROWS, BATCH, MAX_PAGES = 16, 16, 64, 4, 6
PAGES = [[3, 7, 1, 9, 10], [0, 5]]
PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _kwargs(mode: str, group: int) -> dict:
    return {"group_size": group} if mode in ("int4", "int8") else {}


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


def _random_norms(tree: dict, seed: int) -> dict:
    """The params with every norm weight drawn at random (std 0.3)."""
    rng = np.random.default_rng(seed)
    layers = dict(tree["layers"])
    for name, w in layers.items():
        if name.endswith("_norm"):
            layers[name] = (0.3 * rng.normal(size=w.shape)).astype(w.dtype)
    final = (0.3 * rng.normal(size=tree["final_norm"].shape)).astype(tree["final_norm"].dtype)
    return {**tree, "layers": layers, "final_norm": final}


@functools.lru_cache(maxsize=None)
def _jax_params(mode: str, group: int):
    cfg = JaxGemmaConfig(**DIMS, dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jax_init_gemma_params(0, cfg, quant_mode=mode, **_kwargs(mode, group)))
    return mode, group, cfg, _random_norms(tree, 1)


def _steps():
    """A prefill of two fresh prompts (40 and 21 tokens, 3 padding rows, 2
    zero-length padding sequences; layer 0's window of 24 cuts the first),
    then a decode step with 2 idle rows."""
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


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-g{c[1]}")
def test_params_carry_bit_for_bit_and_fuse_as_jax(case):
    mode, group, _, tree = _jax_params(*case)
    cfg = GemmaConfig(**DIMS, dtype=torch.float32)
    ported = gemma_params_from_jax(tree, cfg, device="cpu")
    for name in PROJECTIONS:
        assert ported["layers"][name].kind == KINDS[mode]
        _assert_same_projection(ported["layers"][name], tree["layers"][name])
        assert ported["layers"][name].meta.get("group_size", group) == group
    assert "lm_head" not in ported and ported["embedding"].dtype == torch.float32  # the tied logits
    ours, ref = fuse_llama_params(ported)["layers"], jax_fuse(jax.tree.map(jnp.asarray, tree))["layers"]
    assert sorted(ours) == sorted(ref)
    assert ("wqkv" in ours) == ("w_gateup" in ours) == (mode != "nf4")
    for name in ("wqkv", "w_gateup"):
        if name in ref:
            _assert_same_projection(ours[name], ref[name])


@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: f"{c[0]}-g{c[1]}")
def test_step_logits_and_kv_pool_match_jax(case):
    mode, _, jax_cfg, tree = _jax_params(*case)
    cfg = GemmaConfig(**DIMS, dtype=torch.float32)
    ported = fuse_llama_params(gemma_params_from_jax(tree, cfg, device="cpu"))
    jparams = jax_fuse(jax.tree.map(jnp.asarray, tree))
    jprefill = jax.jit(lambda p, *a: jax_prefill(p, jax_cfg, *a[:3], ROWS, *a[3:]))
    jdecode = jax.jit(lambda p, *a: jax_decode_step(p, jax_cfg, *a))
    jkc, jvc = jax_init_kv_caches(jax_cfg, NUM_PAGES, PS)
    kc, vc = init_gemma_kv_caches(cfg, NUM_PAGES, PS, device="cpu")
    for kind, *arrays in _steps():
        tensors = [torch.from_numpy(a) for a in arrays]
        if kind == "prefill":
            ref, jkc, jvc = jprefill(jparams, *map(jnp.asarray, arrays), jkc, jvc)
            out, _, _ = gemma_prefill(ported, cfg, *tensors[:3], ROWS, *tensors[3:], kc, vc)
        else:
            ref, jkc, jvc = jdecode(jparams, *map(jnp.asarray, arrays), jkc, jvc)
            out, _, _ = gemma_decode_step(ported, cfg, *tensors, kc, vc)
        assert out.dtype == torch.float32 and out.shape == (BATCH, DIMS["vocab_size"])
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL[mode], rtol=TOL[mode],
                                   err_msg=f"{mode} {kind}")
    np.testing.assert_allclose(kc.numpy(), np.asarray(jkc, np.float32), atol=TOL[mode], rtol=TOL[mode])
    np.testing.assert_allclose(vc.numpy(), np.asarray(jvc, np.float32), atol=TOL[mode], rtol=TOL[mode])


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-g{c[1]}")
def test_init_on_device_quantizes_as_jax(case, monkeypatch):
    """Every float32 draw the port's init quantizes, quantized by the JAX
    package's ``quantize_linear`` with the same arguments, gives the port's
    stored arrays bit for bit, each layer of each projection; the embedding
    (the logits) stays bf16 in every mode."""
    mode, group = case
    seen = []
    original = port_gemma.quantize_linear

    def recording(w, quant_mode, **kwargs):
        out = original(w, quant_mode, **kwargs)
        seen.append((w.clone(), quant_mode, kwargs, out))
        return out

    monkeypatch.setattr(port_gemma, "quantize_linear", recording)
    cfg = GemmaConfig(**DIMS)
    params = init_gemma_params(0, cfg, quant_mode=mode, group_size=group, device="cpu")
    assert len(seen) == len(PROJECTIONS) * DIMS["num_layers"]
    for w, quant_mode, kwargs, out in seen:
        assert quant_mode == mode and kwargs == _kwargs(mode, group)
        _assert_same_projection(out, jax_quantize_linear(w.numpy(), quant_mode, **kwargs))
    per_layer = iter(out for _, _, _, out in seen)
    for name in PROJECTIONS:
        stack = params["layers"][name]
        for layer in range(DIMS["num_layers"]):
            piece = next(per_layer)
            assert stack.kind == KINDS[mode] and stack.meta == piece.meta
            for key, arr in piece.arrays.items():
                assert torch.equal(stack.arrays[key][layer], arr)
    assert params["embedding"].dtype == torch.bfloat16 and "lm_head" not in params
