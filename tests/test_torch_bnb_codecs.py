# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""The port's bitsandbytes surface (``conch_tpu_torch.ops.quantization.
bitsandbytes``: K12d's module and the 8-bit dynamic code, their plain
versions on the CPU) against the JAX package's (its Pallas kernels in
interpret mode, its XLA paths as they are).

Inputs come from a numpy seed. What is held, and how closely:
- the dynamic map, the shape helpers and the 8-bit codes: equal;
- ``dequantize_4bit`` and ``dequantize_blockwise`` on codes and states
  carried across from JAX (``quant_state_from_jax``), nested or not: bit
  for bit, since each value is a table lookup times one f32 product;
- the port's own double quantization: its 4-bit codes equal JAX's, its
  8-bit absmax codes within one step (the offset is an f32 mean, whose
  order of summation differs between torch and XLA, so it may differ in
  its last bit), the restored values at tests/quantize_blockwise_test.py's
  double-quantization tolerance (atol 0.05, rtol 0.1);
- the port's golden reference, a second yardstick: absmax equal, each
  nibble within one code (tests/quantize_blockwise_test.py's allowance),
  the decode at rtol 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.ops.quantization.bitsandbytes import functional as jax_bnb
from conch_tpu_torch.kernels.quantization.bitsandbytes.blockwise import (
    dequantize4_launcher,
    dequantize_blockwise_launcher,
)
from conch_tpu_torch.ops.quantization import bitsandbytes as bnb
from conch_tpu_torch.reference.quantization.bitsandbytes import blockwise as ref
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _weights(seed: int, shape=(48, 256), scale: float = 0.05) -> np.ndarray:
    """Normal values with an all-zero 64-block and an outlier."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale
    x.reshape(-1)[128:192] = 0.0
    x.reshape(-1)[300] = 4.0 * scale
    return x


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def _port(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def test_public_names_match_jax():
    names = {"create_dynamic_map", "get_absmax_shape", "get_quantized_output_shape", "QuantState",
             "quantize_blockwise", "quantize_4bit", "dequantize_blockwise", "dequantize_4bit"}
    for name in names:
        assert hasattr(jax_bnb, name) and hasattr(bnb, name)
    assert bnb.functional.SUPPORTED_BLOCKSIZES == jax_bnb.SUPPORTED_BLOCKSIZES
    assert bnb.functional.SUPPORTED_QUANT_TYPES == jax_bnb.SUPPORTED_QUANT_TYPES


@pytest.mark.parametrize("signed", [True, False])
def test_create_dynamic_map_matches_jax(signed):
    ours = bnb.create_dynamic_map(signed=signed)
    assert ours.dtype == torch.float32 and ours.shape == (256,)
    np.testing.assert_array_equal(_bits(ours.numpy()), _bits(jax_bnb.create_dynamic_map(signed=signed)))


@pytest.mark.parametrize("size", [1, 63, 64, 4097, 12288])
def test_shape_helpers_match_jax(size):
    for blocksize in (64, 4096):
        assert bnb.get_absmax_shape(size, blocksize) == jax_bnb.get_absmax_shape(size, blocksize)
    for quant_type in ("nf4", "fp4", "fp8"):
        assert bnb.get_quantized_output_shape(size, quant_type) == jax_bnb.get_quantized_output_shape(size, quant_type)
    assert bnb.get_quantized_output_shape(size, "nf4", torch.float32) == jax_bnb.get_quantized_output_shape(
        size, "nf4", jnp.float32)


@pytest.mark.parametrize("blocksize", [64, 256, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_8bit_dynamic_code_matches_jax(blocksize, dtype):
    """quantize_blockwise("fp8", code) and both forms of dequantize_blockwise."""
    x = _weights(blocksize)
    jcode, code = jax_bnb.create_dynamic_map(), bnb.create_dynamic_map()
    jpacked, jstate = jax_bnb.quantize_blockwise(jnp.asarray(x, JAX_DTYPES[dtype]), code=jcode, blocksize=blocksize,
                                                 quant_type="fp8")
    packed, state = bnb.quantize_blockwise(torch.from_numpy(x).to(TORCH_DTYPES[dtype]), code=code,
                                           blocksize=blocksize, quant_type="fp8")
    assert packed.dtype == torch.uint8 and packed.shape == (x.size,)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    np.testing.assert_array_equal(_bits(state.absmax.numpy()), _bits(jstate.absmax))
    assert state.dtype == TORCH_DTYPES[dtype] and state.shape == x.shape and state.quant_type == "fp8"
    with_state = bnb.dequantize_blockwise(packed, quant_state=state)
    jwith_state = jax_bnb.dequantize_blockwise(jpacked, quant_state=jstate)
    assert with_state.dtype == TORCH_DTYPES[dtype] and with_state.shape == (x.size,)
    np.testing.assert_array_equal(_bits(with_state.float().numpy()), _bits(np.asarray(jwith_state, np.float32)))
    bare = bnb.dequantize_blockwise(packed, absmax=state.absmax, code=code, blocksize=blocksize, quant_type="fp8")
    jbare = jax_bnb.dequantize_blockwise(jpacked, absmax=jstate.absmax, code=jcode, blocksize=blocksize,
                                         quant_type="fp8")
    assert bare.dtype == torch.float32
    np.testing.assert_array_equal(_bits(bare.numpy()), _bits(jbare))


@pytest.fixture(scope="module")
def jax_codes():
    """JAX's 4-bit codes and states, one per (quant_type, blocksize)."""
    x = _weights(7)
    return x, {
        (qt, bs): jax_bnb.quantize_4bit(jnp.asarray(x, jnp.bfloat16), blocksize=bs, quant_type=qt)
        for qt in ("nf4", "fp4") for bs in (64, 256, 512, 1024, 4096)
    }


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
@pytest.mark.parametrize("blocksize", [64, 256, 512, 1024, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_dequantize_4bit_carried_state_bit_for_bit(jax_codes, quant_type, blocksize, dtype):
    x, codes = jax_codes
    jpacked, jstate = codes[(quant_type, blocksize)]
    jstate = dataclasses.replace(jstate, dtype=jnp.dtype(JAX_DTYPES[dtype]))
    state = bnb.quant_state_from_jax(jstate, device="cpu")
    assert state.dtype == TORCH_DTYPES[dtype] and state.shape == x.shape and not state.nested
    before = dequantize4_launcher.launches
    out = bnb.dequantize_4bit(_port(jpacked), quant_state=state)
    assert dequantize4_launcher.launches == before  # the CPU takes the plain version, no kernel
    expected = jax_bnb.dequantize_4bit(jpacked, quant_state=jstate)
    assert out.dtype == TORCH_DTYPES[dtype] and out.shape == (x.size,)  # flat, as in JAX
    np.testing.assert_array_equal(_bits(out.float().numpy()), _bits(np.asarray(expected, np.float32)))


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_dequantize_blockwise_bare_form_matches_jax(jax_codes, quant_type):
    """Without a state: absmax given, f32 out, x.numel() * 2 values."""
    _, codes = jax_codes
    jpacked, jstate = codes[(quant_type, 64)]
    out = bnb.dequantize_blockwise(_port(jpacked), absmax=_port(jstate.absmax), blocksize=64, quant_type=quant_type)
    expected = jax_bnb.dequantize_blockwise(jpacked, absmax=jstate.absmax, blocksize=64, quant_type=quant_type)
    assert out.dtype == torch.float32 and out.shape == (2 * jpacked.size,)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(expected))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nested_state_carried_across_decodes_bit_for_bit(dtype):
    x = _weights(8, (64, 512))
    jpacked, jstate = jax_bnb.quantize_4bit(jnp.asarray(x, JAX_DTYPES[dtype]), blocksize=64, quant_type="nf4",
                                            compress_statistics=True)
    state = bnb.quant_state_from_jax(jstate, device="cpu")
    assert state.nested and state.offset == jstate.offset and state.absmax.dtype == torch.uint8
    assert state.state2.blocksize == 256 and state.state2.quant_type == "fp8"
    out = bnb.dequantize_4bit(_port(jpacked), quant_state=state)
    expected = jax_bnb.dequantize_4bit(jpacked, quant_state=jstate)
    assert out.dtype == TORCH_DTYPES[dtype]
    np.testing.assert_array_equal(_bits(out.float().numpy()), _bits(np.asarray(expected, np.float32)))


def test_compress_statistics_within_one_step_of_jax():
    x = _weights(9, (64, 512))
    jpacked, jstate = jax_bnb.quantize_4bit(jnp.asarray(x), blocksize=64, quant_type="nf4", compress_statistics=True)
    packed, state = bnb.quantize_4bit(torch.from_numpy(x), blocksize=64, quant_type="nf4", compress_statistics=True)
    assert state.nested and state.blocksize == 64 and state.state2.quant_type == "fp8"
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))  # the 4-bit codes do not see the offset
    np.testing.assert_allclose(state.offset, jstate.offset, rtol=1e-6)
    steps = np.abs(state.absmax.numpy().astype(np.int32) - np.asarray(jstate.absmax).astype(np.int32))
    assert steps.max() <= 1
    np.testing.assert_allclose(state.state2.absmax.numpy(), np.asarray(jstate.state2.absmax), rtol=1e-6)
    restored = bnb.dequantize_4bit(packed, quant_state=state).numpy()
    np.testing.assert_allclose(restored, np.asarray(jax_bnb.dequantize_4bit(jpacked, quant_state=jstate)),
                               atol=0.05, rtol=0.1)
    flat_packed, flat_state = bnb.quantize_4bit(torch.from_numpy(x), blocksize=64, quant_type="nf4")
    flat = bnb.dequantize_4bit(flat_packed, quant_state=flat_state).numpy()
    np.testing.assert_allclose(restored, flat, atol=0.05, rtol=0.1)


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_all_zero_blocks_decode_to_exact_zeros(quant_type):
    x = np.random.default_rng(5).normal(size=192).astype(np.float32)
    x[64:128] = 0.0
    for values in (np.zeros(128, np.float32), x):
        for compress in (False, True):
            packed, state = bnb.quantize_4bit(torch.from_numpy(values), blocksize=64, quant_type=quant_type,
                                              compress_statistics=compress)
            out = bnb.dequantize_4bit(packed, state).numpy()
            assert np.all(np.isfinite(out))
            if not compress or not values.any():
                zero = values == 0.0
                np.testing.assert_array_equal(out[zero], 0.0)
    # The plain decode of zero absmax gives exact zeros for every code.
    every = torch.arange(256, dtype=torch.int64).to(torch.uint8)
    np.testing.assert_array_equal(dequantize4_launcher(every, torch.zeros(8), 64, quant_type).abs().numpy(), 0.0)


def test_odd_and_mismatched_sizes_raise():
    with pytest.raises(ValueError, match="even input size"):
        bnb.quantize_4bit(torch.ones(65), blocksize=64, quant_type="nf4")
    packed, state = bnb.quantize_4bit(torch.ones(128), blocksize=64, quant_type="nf4")
    with pytest.raises(ValueError):
        dequantize_blockwise_launcher(packed, state.absmax, None, 64, 255, "nf4")
    with pytest.raises(ValueError):
        dequantize4_launcher(packed.reshape(-1), state.absmax[:1], 64, "nf4")  # an absmax short of the blocks
    with pytest.raises(ValueError, match="code"):
        bnb.quantize_blockwise(torch.ones(64), quant_type="fp8")
    with pytest.raises(NotImplementedError):
        bnb.quantize_blockwise(torch.ones(64), blocksize=32, quant_type="nf4")
    with pytest.raises(NotImplementedError):
        bnb.quantize_4bit(torch.ones(64), quant_type="nf4", quant_storage=torch.float32)


@pytest.mark.parametrize("blocksize", [64, 1024])
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_float16_inputs_to_quantize_4bit_match_jax(blocksize, quant_type):
    x = _weights(blocksize + 1)
    jpacked, jstate = jax_bnb.quantize_4bit(jnp.asarray(x, jnp.float16), blocksize=blocksize, quant_type=quant_type)
    packed, state = bnb.quantize_4bit(torch.from_numpy(x).half(), blocksize=blocksize, quant_type=quant_type)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    np.testing.assert_array_equal(_bits(state.absmax.numpy()), _bits(jstate.absmax))
    assert state.dtype == torch.float16
    out = bnb.dequantize_4bit(packed, quant_state=state)
    assert out.dtype == torch.float16
    np.testing.assert_array_equal(_bits(out.float().numpy()),
                                  _bits(np.asarray(jax_bnb.dequantize_4bit(jpacked, quant_state=jstate), np.float32)))


@pytest.mark.parametrize("quant_type", ["nf4", "fp4", "fp8"])
def test_golden_reference_agrees(quant_type):
    """The port's golden reference, a second yardstick beside JAX. It
    divides by the absmax as the JAX package's golden reference does, so
    an all-zero block gives 0 / 0 there: these inputs have none (the
    kernels' guard is held in test_all_zero_blocks_decode_to_exact_zeros)."""
    x = torch.from_numpy(np.random.default_rng(12).normal(size=(32, 128)).astype(np.float32))
    code = bnb.create_dynamic_map() if quant_type == "fp8" else None
    packed, state = bnb.quantize_blockwise(x, code=code, blocksize=64, quant_type=quant_type)
    golden, golden_absmax = ref.quantize_blockwise(x, 64, quant_type, code)
    np.testing.assert_array_equal(state.absmax.numpy(), golden_absmax.numpy())
    ours, theirs = packed.numpy().astype(np.int32).reshape(-1), golden.numpy().astype(np.int32).reshape(-1)
    if quant_type == "fp8":
        assert np.all(np.abs(ours - theirs) <= 1)
    else:
        assert np.all(np.abs((ours >> 4) - (theirs >> 4)) <= 1) and np.all(np.abs((ours & 15) - (theirs & 15)) <= 1)
    decoded = bnb.dequantize_blockwise(packed, quant_state=state).numpy()
    expected = ref.dequantize_blockwise(packed, state.absmax, 64, x.numel(), quant_type, code).numpy()
    np.testing.assert_allclose(decoded, expected, rtol=1e-6)
    for c in range(16):
        if quant_type == "nf4":
            assert ref.nf4_quantize_scalar(ref.nf4_dequantize_scalar(c)) == c
        elif quant_type == "fp4" and c != 8:  # -0.0 encodes as +0
            assert ref.fp4_quantize_scalar(ref.fp4_dequantize_scalar(c)) == c


def test_quant_state_from_jax_defaults_to_the_card(monkeypatch):
    """Without a device the state goes to the card, as with every entry point
    (``platforms.resolve_device``): with no card that raises and names
    ``device='cpu'``; asked for, the CPU works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, jstate = jax_bnb.quantize_4bit(jnp.asarray(_weights(9, (8, 64)), jnp.float32), blocksize=64, quant_type="nf4")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bnb.quant_state_from_jax(jstate)
    assert bnb.quant_state_from_jax(jstate, device="cpu").absmax.device.type == "cpu"
