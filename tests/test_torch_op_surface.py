# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""The rest of the port's single-device op surface against the JAX package's,
on the CPU: the GEMM metadata (``create_mixed_precision_metadata``,
``create_scaled_metadata``) field for field; every ``strict`` check of
``mixed_precision_gemm``, ``scaled_gemm``, ``varlen_attention`` and
``reshape_and_cache`` raising the error type JAX raises, with JAX's message;
``mixed_precision_gemm``'s ``output_dtype`` (f32 from bf16, each layout);
``copy_blocks`` on tests/cache_ops_test.py's cases; npz checkpoints both
ways, bit for bit; and the profiling helpers.

The same numpy inputs, made from a seed, go to both packages. The f32 GEMM
outputs are held within 1e-3 x max |ref| (both sum exact products in f32,
in their own orders; the magic layout's post-dot zero-point correction
cancels about 136 x sum(x) a group) and shown not to be bf16-rounded.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.kernels.quantization.bitsandbytes.blockwise import NF4_CODE
from conch_tpu.models.linear import QuantizedLinear as JaxQuantizedLinear
from conch_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from conch_tpu.models.llama import init_llama_params as jax_init_llama_params
from conch_tpu.ops.attention.varlen_attention import varlen_attention as jax_varlen_attention
from conch_tpu.ops.cache import copy_blocks as jax_copy_blocks
from conch_tpu.ops.cache import reshape_and_cache as jax_reshape_and_cache
from conch_tpu.ops.quantization import gemm as jax_gemm
from conch_tpu.types import scalar_types
from conch_tpu.utils.checkpoint import restore_checkpoint as jax_restore_checkpoint
from conch_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from conch_tpu.utils.quant_utils import pack_rows, pack_rows_planar, quantize_weights
from conch_tpu_torch.models.llama import LlamaConfig, init_llama_params, tree_from_jax
from conch_tpu_torch.ops.attention.varlen_attention import varlen_attention
from conch_tpu_torch.ops.cache import copy_blocks, reshape_and_cache
from conch_tpu_torch.ops.quantization import (
    create_mixed_precision_metadata,
    create_scaled_metadata,
    mixed_precision_gemm,
    scaled_gemm,
)
from conch_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from conch_tpu_torch.utils.profiling import StepTimeline, annotate, profile_fn, trace
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16, jnp.int32: torch.int32,
                jnp.int8: torch.int8, jnp.float8_e4m3fn: torch.float8_e4m3fn}


def _jnp(a: np.ndarray, dtype=None):
    return jnp.asarray(a) if dtype is None else jnp.asarray(a).astype(dtype)


def _torch(a: np.ndarray, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(TORCH_DTYPES[dtype])


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        width = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return a.contiguous().view(width).numpy().view(f"u{a.element_size()}")
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}")


def _same_error(jax_call, port_call) -> None:
    """Both calls raise, the same exception type, with the same message up to
    its first colon (dtype names differ between the packages after it)."""
    with pytest.raises(Exception) as jax_error:
        jax_call()
    with pytest.raises(jax_error.type) as port_error:
        port_call()
    head = str(jax_error.value).split(":")[0]
    assert str(port_error.value).split(":")[0] == head, (str(port_error.value), str(jax_error.value))


# -- GEMM metadata ------------------------------------------------------------

K, N, GROUP = 256, 128, 64


def _mixed_inputs(rng, zp: str):
    x = rng.normal(size=(8, K)).astype(np.float32)
    packed = rng.integers(-(2**31), 2**31 - 1, size=(K // 8, N), dtype=np.int64).astype(np.int32)
    scales = rng.uniform(1e-3, 1e-2, size=(K // GROUP, N)).astype(np.float32)
    zps = {"none": None, "scalar": np.asarray([3.0], np.float32),
           "grouped": rng.uniform(0, 15, size=(K // GROUP, N)).astype(np.float32)}[zp]
    return x, packed, scales, zps


def _field(v):
    if isinstance(v, torch.dtype):
        return str(v).removeprefix("torch.")
    if hasattr(v, "name") and hasattr(v, "value"):  # an enum member
        return (v.name, v.value)
    if isinstance(v, (type, np.dtype)) or type(v).__name__ in ("dtype", "_ScalarMeta"):
        return jnp.dtype(v).name
    return v


@pytest.mark.parametrize("zp", ["none", "scalar", "grouped"])
@pytest.mark.parametrize("overrides", [{}, {"output_dtype": "float32", "acc_dtype": "float32", "meta_dtype": "bfloat16"}])
def test_mixed_precision_metadata_matches_jax(zp, overrides, rng):
    x, packed, scales, zps = _mixed_inputs(rng, zp)
    jkw = {k: getattr(jnp, v) for k, v in overrides.items()}
    tkw = {k: getattr(torch, v) for k, v in overrides.items()}
    ref = jax_gemm.create_mixed_precision_metadata(
        _jnp(x, jnp.bfloat16), _jnp(packed), _jnp(scales, jnp.bfloat16), None if zps is None else _jnp(zps),
        4, 8, GROUP, strict=True, **jkw)
    got = create_mixed_precision_metadata(
        _torch(x, jnp.bfloat16), _torch(packed), _torch(scales, jnp.bfloat16), None if zps is None else _torch(zps),
        4, 8, GROUP, strict=True, **tkw)
    assert {k: _field(v) for k, v in vars(got).items()} == {k: _field(v) for k, v in vars(ref).items()}


@pytest.mark.parametrize(("a_dtype", "scale_a_rows"), [(jnp.int8, 8), (jnp.int8, 1), (jnp.float8_e4m3fn, 8)])
def test_scaled_metadata_matches_jax(a_dtype, scale_a_rows, rng):
    a = rng.integers(-8, 8, size=(8, 64)).astype(np.float32)
    b = rng.integers(-8, 8, size=(64, 32)).astype(np.float32)
    sa = rng.uniform(0.5, 2, size=(scale_a_rows,)).astype(np.float32)
    sb = rng.uniform(0.5, 2, size=(32,)).astype(np.float32)
    ref = jax_gemm.create_scaled_metadata(_jnp(a, a_dtype), _jnp(b, a_dtype), _jnp(sa), _jnp(sb), jnp.bfloat16,
                                          strict=True)
    got = create_scaled_metadata(_torch(a, a_dtype), _torch(b, a_dtype), _torch(sa), _torch(sb), torch.bfloat16,
                                 strict=True)
    assert {k: _field(v) for k, v in vars(got).items()} == {k: _field(v) for k, v in vars(ref).items()}


# -- strict checks --------------------------------------------------------------

MIXED_STRICT_CASES = {
    "x rank": lambda x, p, s, z: (x[None], p, s, z, {}),
    "packed rank": lambda x, p, s, z: (x, p.reshape(-1), s, z, {}),
    "scales rank": lambda x, p, s, z: (x, p, s.reshape(-1), z, {}),
    "packed dtype": lambda x, p, s, z: (x, p.astype(np.float32), s, z, {}),
    "scales shape": lambda x, p, s, z: (x, p, np.concatenate([s, s]), z, {}),
    "zero-point shape": lambda x, p, s, z: (x, p, s, np.ones((3, N), np.float32), {}),
    "zero-point rank": lambda x, p, s, z: (x, p, s, np.ones((K // GROUP, N, 1), np.float32), {}),
    "scaled activations": lambda x, p, s, z: (x, p, s, z, {"scaled_activations": True}),
}


@pytest.mark.parametrize("case", MIXED_STRICT_CASES)
def test_mixed_precision_gemm_strict_errors_match_jax(case, rng):
    x, p, s, z, kw = MIXED_STRICT_CASES[case](*_mixed_inputs(rng, "none"))
    _same_error(
        lambda: jax_gemm.mixed_precision_gemm(_jnp(x, jnp.bfloat16), _jnp(p), _jnp(s, jnp.bfloat16),
                                              None if z is None else _jnp(z), 4, 8, GROUP, strict=True, **kw),
        lambda: mixed_precision_gemm(_torch(x, jnp.bfloat16), _torch(p), _torch(s, jnp.bfloat16),
                                     None if z is None else _torch(z), 4, 8, GROUP, strict=True, **kw),
    )


def test_mixed_precision_gemm_rejects_what_it_does_not_compute(rng):
    """scaled_activations raises without strict too (JAX ignores it there);
    acc_dtype and meta_dtype are taken on every device and only recorded
    (``test_mixed_precision_gemm_acc_dtype_is_recorded_only``)."""
    x, p, s, _ = _mixed_inputs(rng, "none")
    with pytest.raises(NotImplementedError, match="Scaled activations"):
        mixed_precision_gemm(_torch(x, jnp.bfloat16), _torch(p), _torch(s, jnp.bfloat16), None, 4, 8, GROUP,
                             layout="magic", scaled_activations=True)
    out = mixed_precision_gemm(_torch(x, jnp.bfloat16), _torch(p), _torch(s, jnp.bfloat16), None, 4, 8, GROUP,
                               layout="magic", acc_dtype=torch.float32, meta_dtype=torch.float32)
    assert out.dtype == torch.bfloat16


ACC_DTYPE_FORMATS = {
    "int4": lambda w: JaxQuantizedLinear.int4_from_dense(w, GROUP),
    "int8": lambda w: JaxQuantizedLinear.int8_grouped_from_dense(w, GROUP),
    "nf4": lambda w: JaxQuantizedLinear.nf4_from_dense(w, GROUP),
}


def _gemm_operands(q) -> tuple[list, dict]:
    """(packed, scales, zero-point, bits, bias, group) and the keyword
    arguments of one JAX QuantizedLinear's mixed_precision_gemm call."""
    if q.kind == "nf4":
        return [q.arrays["packed"], q.arrays["absmax"], None, 4, 0, q.meta["blocksize"]], {
            "codebook": tuple(float(v) for v in NF4_CODE), "layout": "gptq"}
    return [q.arrays["packed"], q.arrays["scales"], None, q.meta["bits"], q.meta["bias"], q.meta["group_size"]], {
        "layout": q.meta["layout"]}


@pytest.mark.parametrize("fmt", ACC_DTYPE_FORMATS)
def test_mixed_precision_gemm_acc_dtype_is_recorded_only(fmt, rng):
    """acc_dtype=bfloat16 is recorded in the metadata, as JAX records it,
    and changes nothing: both packages sum in f32 (JAX's kernels never read
    it). The port's output equals its f32-acc call bit for bit and JAX's
    bf16-acc call at tests/test_torch_int4_gemm.py's K1 tolerance."""
    q = ACC_DTYPE_FORMATS[fmt](rng.normal(size=(K, N)).astype(np.float32) * 0.05)
    x = rng.normal(size=(8, K)).astype(np.float32)
    args, kw = _gemm_operands(q)
    ref = jax_gemm.mixed_precision_gemm(_jnp(x, jnp.bfloat16), *args, acc_dtype=jnp.bfloat16, **kw)
    targs = [None if a is None else torch.from_numpy(_bits(a).copy()).view(TORCH_DTYPES[a.dtype.type])
             for a in args[:3]]
    xt = _torch(x, jnp.bfloat16)
    out = mixed_precision_gemm(xt, *targs, *args[3:], acc_dtype=torch.bfloat16, **kw)
    assert torch.equal(out, mixed_precision_gemm(xt, *targs, *args[3:], acc_dtype=torch.float32, **kw))
    meta = create_mixed_precision_metadata(xt, *targs, *args[3:], acc_dtype=torch.bfloat16)
    assert meta.acc_dtype == torch.bfloat16
    out, ref = out.float().numpy(), np.asarray(ref, np.float32)
    np.testing.assert_allclose(out, ref, atol=min(5e-2 * np.sqrt(K), 1.0), rtol=1e-1)
    assert np.abs(out - ref).max() <= 1e-2 * np.abs(ref).max()


SCALED_STRICT_CASES = {
    "a rank": lambda a, b, sa, sb: (a[None], b, sa, sb, None),
    "b rank": lambda a, b, sa, sb: (a, b[None], sa, sb, None),
    "dtypes differ": lambda a, b, sa, sb: (a, b, sa, sb, jnp.float8_e4m3fn),
    "scale_a shape": lambda a, b, sa, sb: (a, b, np.ones(5, np.float32), sb, None),
    "scale_b shape": lambda a, b, sa, sb: (a, b, sa, np.ones(5, np.float32), None),
}


@pytest.mark.parametrize("case", SCALED_STRICT_CASES)
def test_scaled_gemm_strict_errors_match_jax(case, rng):
    a = rng.integers(-8, 8, size=(8, 64)).astype(np.float32)
    b = rng.integers(-8, 8, size=(64, 32)).astype(np.float32)
    a, b, sa, sb, b_dtype = SCALED_STRICT_CASES[case](a, b, np.ones(8, np.float32), np.ones(32, np.float32))
    b_dtype = b_dtype or jnp.int8
    _same_error(
        lambda: jax_gemm.scaled_gemm(_jnp(a, jnp.int8), _jnp(b, b_dtype), _jnp(sa), _jnp(sb), jnp.float32,
                                     strict=True),
        lambda: scaled_gemm(_torch(a, jnp.int8), _torch(b, b_dtype), _torch(sa), _torch(sb), torch.float32,
                            strict=True),
    )


def test_scaled_gemm_strict_passes_valid_input(rng):
    a = rng.integers(-8, 8, size=(8, 64)).astype(np.float32)
    b = rng.integers(-8, 8, size=(64, 32)).astype(np.float32)
    args = (_torch(a, jnp.int8), _torch(b, jnp.int8), torch.ones(8), torch.ones(32), torch.float32)
    assert torch.equal(scaled_gemm(*args, strict=True), scaled_gemm(*args))


def _varlen_inputs(rng):
    return {
        "query": rng.normal(size=(6, 4, 32)).astype(np.float32),
        "key_cache": rng.normal(size=(8, 2, 16, 32)).astype(np.float32),
        "value_cache": rng.normal(size=(8, 2, 16, 32)).astype(np.float32),
        "cu_seqlens_q": np.asarray([0, 2, 6], np.int32),
        "seq_lens": np.asarray([2, 4], np.int32),
        "block_table": np.asarray([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32),
    }


VARLEN_STRICT_CASES = {
    "query rank": {"query": lambda q: q[0]},
    "cache rank": {"key_cache": lambda c: c[0], "value_cache": lambda c: c[0]},
    "caches differ": {"value_cache": lambda c: c[:4]},
    "head size": {"query": lambda q: q[..., :16]},
    "more kv heads than query heads": {"query": lambda q: q[:, :1]},
    "block table rows": {"block_table": lambda t: t[:1]},
    "seq_lens rows": {"seq_lens": lambda s: s[:1]},
}


def _varlen_call(fn, to, arrays: dict, **kw):
    a = {k: to(v) for k, v in arrays.items()}
    return fn(a["query"], a["key_cache"], a["value_cache"], a["cu_seqlens_q"], 4, a["seq_lens"], 4,
              a["block_table"], causal=True, strict=True, **kw)


@pytest.mark.parametrize("case", VARLEN_STRICT_CASES)
def test_varlen_attention_strict_errors_match_jax(case, rng):
    arrays = _varlen_inputs(rng)
    for name, change in VARLEN_STRICT_CASES[case].items():
        arrays[name] = change(arrays[name])
    _same_error(lambda: _varlen_call(jax_varlen_attention, _jnp, arrays),
                lambda: _varlen_call(varlen_attention, _torch, arrays))


def test_varlen_attention_strict_passes_valid_input(rng):
    arrays = _varlen_inputs(rng)
    out = _varlen_call(varlen_attention, _torch, arrays)
    a = {k: _torch(v) for k, v in arrays.items()}
    ref = varlen_attention(a["query"], a["key_cache"], a["value_cache"], a["cu_seqlens_q"], 4, a["seq_lens"], 4,
                           a["block_table"], causal=True)
    assert torch.equal(out, ref)


def _cache_inputs(rng, tokens: int = 10):
    return {
        "key": rng.normal(size=(tokens, 2, 64)).astype(np.float32),
        "value": rng.normal(size=(tokens, 2, 64)).astype(np.float32),
        "key_cache": rng.normal(size=(8, 2, 16, 64)).astype(np.float32),
        "value_cache": rng.normal(size=(8, 2, 16, 64)).astype(np.float32),
        "slot_mapping": rng.choice(8 * 16, size=tokens, replace=False).astype(np.int32),
    }


CACHE_STRICT_CASES = {
    "key and value differ": ({"value": lambda v: v[:, :1]}, {}),
    "key rank": ({"key": lambda k: k[:, 0], "value": lambda v: v[:, 0]}, {}),
    "caches differ": ({"value_cache": lambda c: c[:4]}, {}),
    "cache rank": ({"key_cache": lambda c: c[0], "value_cache": lambda c: c[0]}, {}),
    "kv heads": ({"key_cache": lambda c: c[:, :1], "value_cache": lambda c: c[:, :1]}, {}),
    "head size": ({"key_cache": lambda c: c[..., :32], "value_cache": lambda c: c[..., :32]}, {}),
    "slot mapping rank": ({"slot_mapping": lambda s: s[:, None]}, {}),
    "kv_cache_dtype": ({}, {"kv_cache_dtype": "fp16"}),
}


def _cache_call(fn, to, arrays: dict, **kw):
    a = {k: to(v) for k, v in arrays.items()}
    return fn(a["key"], a["value"], a["key_cache"], a["value_cache"], a["slot_mapping"], strict=True, **kw)


@pytest.mark.parametrize("case", CACHE_STRICT_CASES)
def test_reshape_and_cache_strict_errors_match_jax(case, rng):
    arrays = _cache_inputs(rng)
    changes, kw = CACHE_STRICT_CASES[case]
    for name, change in changes.items():
        arrays[name] = change(arrays[name])
    _same_error(lambda: _cache_call(jax_reshape_and_cache, _jnp, arrays, **kw),
                lambda: _cache_call(reshape_and_cache, _torch, arrays, **kw))


def test_reshape_and_cache_strict_matches_jax(rng):
    """tests/cache_ops_test.py's basic case, strict, f32: equal caches."""
    arrays = _cache_inputs(rng)
    ref_k, ref_v = _cache_call(jax_reshape_and_cache, _jnp, arrays)
    got_k, got_v = _cache_call(reshape_and_cache, _torch, arrays)
    np.testing.assert_array_equal(_bits(got_k), _bits(ref_k))
    np.testing.assert_array_equal(_bits(got_v), _bits(ref_v))


# -- mixed_precision_gemm's output dtype --------------------------------------


def _layout_weights(rng, layout: str):
    """(packed, scales, bits, bias) of a (K, N) weight in ``layout``, made by
    the JAX package."""
    w = rng.normal(size=(K, N)).astype(np.float32) * 0.05
    if layout == "magic":
        q = JaxQuantizedLinear.int4_from_dense(w, GROUP)
        return np.asarray(q.arrays["packed"]), np.asarray(q.arrays["scales"].astype(jnp.float32)), 4, 8
    qt = scalar_types.uint8b128 if layout == "planar" else scalar_types.uint4b8
    bits = 8 if layout == "planar" else 4
    _, w_q, w_s, _ = quantize_weights(w, qt, GROUP)
    packed = pack_rows_planar(np.asarray(w_q), bits, GROUP) if layout == "planar" else pack_rows(np.asarray(w_q), bits)
    return np.asarray(packed), np.asarray(w_s, np.float32), bits, qt.bias


@pytest.mark.parametrize("layout", ["magic", "planar", "gptq"])
def test_mixed_precision_gemm_output_dtype_matches_jax(layout, rng):
    packed, scales, bits, bias = _layout_weights(rng, layout)
    x = rng.normal(size=(16, K)).astype(np.float32)
    ref = jax_gemm.mixed_precision_gemm(_jnp(x, jnp.bfloat16), _jnp(packed), _jnp(scales, jnp.bfloat16), None,
                                        bits, bias, GROUP, output_dtype=jnp.float32, layout=layout, strict=True)
    out = mixed_precision_gemm(_torch(x, jnp.bfloat16), _torch(packed), _torch(scales, jnp.bfloat16), None, bits,
                               bias, GROUP, output_dtype=torch.float32, layout=layout, strict=True)
    assert ref.dtype == jnp.float32 and out.dtype == torch.float32
    ref = np.asarray(ref)
    assert np.abs(out.numpy() - ref).max() <= 1e-3 * np.abs(ref).max()
    # Not rounded through bf16: most outputs are no bf16 value.
    assert (out != out.to(torch.bfloat16).float()).float().mean() > 0.9


# -- copy_blocks --------------------------------------------------------------


def test_copy_blocks_matches_jax(rng):
    """tests/cache_ops_test.py's case: 3 layers, 8 pages, in place."""
    caches = [rng.normal(size=(8, 16 * 2 * 64)).astype(np.float32) for _ in range(6)]
    mapping = np.asarray([[0, 3], [5, 1], [6, 7]], np.int32)
    ref_k, ref_v = jax_copy_blocks([_jnp(c) for c in caches[:3]], [_jnp(c) for c in caches[3:]], _jnp(mapping))
    keys, values = [_torch(c) for c in caches[:3]], [_torch(c) for c in caches[3:]]
    got_k, got_v = copy_blocks(keys, values, _torch(mapping))
    assert all(g is t for g, t in zip(got_k + got_v, keys + values))  # updated in place
    for got, ref in zip(got_k + got_v, list(ref_k) + list(ref_v)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


COPY_BLOCKS_ERRORS = {
    "empty": lambda c, m: ([], [], m),
    "mapping shape": lambda c, m: (c, c, m[:, 0]),
    "layer counts": lambda c, m: (c, c[:1], m),
    "shapes": lambda c, m: (c, [c[0][:2], c[1]], m),
    "dtypes": lambda c, m: (c, [c[0].astype(np.float16), c[1]], m),
}


@pytest.mark.parametrize("case", COPY_BLOCKS_ERRORS)
def test_copy_blocks_errors_match_jax(case):
    caches = [np.zeros((4, 8), np.float32), np.zeros((4, 8), np.float32)]
    keys, values, mapping = COPY_BLOCKS_ERRORS[case](caches, np.asarray([[0, 1]], np.int32))
    _same_error(lambda: jax_copy_blocks([_jnp(c) for c in keys], [_jnp(c) for c in values], _jnp(mapping)),
                lambda: copy_blocks([_torch(c) for c in keys], [_torch(c) for c in values], _torch(mapping)))


# -- checkpoints ----------------------------------------------------------------

TINY = {"vocab_size": 64, "hidden_size": 64, "intermediate_size": 128, "num_layers": 2, "num_heads": 2,
        "num_kv_heads": 1, "head_dim": 32, "max_position": 128}


def _jax_llama(seed: int, quant_mode: str):
    return jax_init_llama_params(seed, JaxLlamaConfig(**TINY), quant_mode, group_size=32)


def _port_tree(jax_tree):
    return tree_from_jax(jax.tree.map(np.asarray, jax_tree), "cpu")


def _port_leaves(tree) -> list:
    from conch_tpu_torch.utils.checkpoint import _flatten

    leaves: list = []
    _flatten(tree, leaves)
    return leaves


@pytest.mark.parametrize("quant_mode", ["bf16", "int4"])
def test_checkpoint_from_jax_restores_in_the_port(quant_mode, tmp_path):
    jax_save_checkpoint(tmp_path / "ckpt", _jax_llama(0, quant_mode))
    restored = restore_checkpoint(tmp_path / "ckpt", _port_tree(_jax_llama(1, quant_mode)))
    expected = _port_leaves(_port_tree(_jax_llama(0, quant_mode)))
    got = _port_leaves(restored)
    assert len(got) == len(expected) == len(jax.tree_util.tree_leaves(_jax_llama(0, quant_mode)))
    for a, b in zip(got, expected):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # The port's own init builds the same tree: it restores the JAX file too.
    native = init_llama_params(1, LlamaConfig(**TINY), quant_mode=quant_mode, group_size=32, device="cpu")
    assert all(torch.equal(_bits_t(a), _bits_t(b))
               for a, b in zip(_port_leaves(restore_checkpoint(tmp_path / "ckpt", native)), expected))


def _bits_t(t: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(_bits(t).copy())


@pytest.mark.parametrize("quant_mode", ["bf16", "int4"])
def test_checkpoint_from_the_port_restores_in_jax(quant_mode, tmp_path):
    save_checkpoint(tmp_path / "ckpt", _port_tree(_jax_llama(0, quant_mode)))
    meta = json.loads((tmp_path / "ckpt.json").read_text())
    assert "treedef" not in meta and meta["num_leaves"] > 0
    restored = jax_restore_checkpoint(tmp_path / "ckpt", _jax_llama(1, quant_mode))
    for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(_jax_llama(0, quant_mode))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_checkpoint_float8_and_structure(tmp_path):
    """e4m3 as uint8 bits, lists and None as JAX flattens them, restored
    onto the template; a template of another structure raises."""
    tree = {"b": [torch.arange(6, dtype=torch.float32).reshape(2, 3).to(torch.float8_e4m3fn), None],
            "a": torch.tensor([1, 2, 3], dtype=torch.int32)}
    save_checkpoint(tmp_path / "ckpt", tree)
    data = np.load(tmp_path / "ckpt.npz")
    assert data["leaf_0"].dtype == np.int32 and data["leaf_1"].dtype == np.uint8
    restored = restore_checkpoint(tmp_path / "ckpt", {"a": torch.zeros(3, dtype=torch.int32),
                                                      "b": [torch.zeros(2, 3, dtype=torch.float8_e4m3fn), None]})
    assert list(restored) == ["a", "b"] and restored["b"][1] is None
    assert torch.equal(restored["b"][0].view(torch.uint8), tree["b"][0].view(torch.uint8))
    with pytest.raises(ValueError, match="tree structure"):
        restore_checkpoint(tmp_path / "ckpt", {"a": torch.zeros(3, dtype=torch.int32),
                                               "c": [torch.zeros(2, 3, dtype=torch.float8_e4m3fn), None]})


def test_checkpoint_mismatched_template_raises_in_both(tmp_path):
    jax_save_checkpoint(tmp_path / "jax", _jax_llama(0, "bf16"))
    save_checkpoint(tmp_path / "port", _port_tree(_jax_llama(0, "bf16")))
    with pytest.raises(ValueError, match="mismatch"):
        restore_checkpoint(tmp_path / "jax", _port_tree(_jax_llama(0, "int4")))
    with pytest.raises(ValueError, match="mismatch"):
        jax_restore_checkpoint(tmp_path / "port", _jax_llama(0, "int4"))
    with pytest.raises(ValueError, match=re.escape("template expects")):
        restore_checkpoint(tmp_path / "port", {**_port_tree(_jax_llama(0, "bf16")), "embedding": torch.zeros(3)})


# -- profiling -------------------------------------------------------------------


def test_profile_fn_writes_a_trace_with_annotations(tmp_path):
    def work(n):
        with annotate("conch_test_range"):
            return torch.ones(n).sum()

    out = profile_fn(work, 16, log_dir=str(tmp_path))
    assert out.item() == 16.0
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1 and "conch_test_range" in traces[0].read_text()
    with trace(str(tmp_path / "again")) as log_dir:
        torch.zeros(4).add_(1)
    assert log_dir == str(tmp_path / "again") and list((tmp_path / "again").glob("*.pt.trace.json"))


def test_step_timeline_summary():
    timeline = StepTimeline()
    for name in ("prefill", "decode", "decode"):
        with timeline.record(name):
            pass
    summary = timeline.summary()
    assert summary["decode"]["count"] == 2 and summary["prefill"]["count"] == 1
    assert all(v["total_s"] >= 0 and v["mean_ms"] >= 0 for v in summary.values())
