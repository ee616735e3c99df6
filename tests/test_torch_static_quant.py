# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Port static-scale quantization (conch_tpu_torch, K9's public ops) against the JAX package.

The same numpy inputs go through ``conch_tpu.ops.quantization``'s
``scaled_int8_quant`` / ``scaled_fp8_quant`` (the Pallas kernels in
interpret mode) and the port's ops on ``device="cpu"``, on
tests/static_quant_test.py's shapes, dtypes and saturation cases. int8 is
held at that test's atol=1 (an off-by-one code), and the count of int8
elements that differ at all is recorded (``int8_elements_differing`` in
the junit properties; 0 on every case so far); fp8 is held exactly, byte
for byte.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.ops.quantization.fp8 import scaled_fp8_quant as jax_fp8
from conch_tpu.ops.quantization.int8 import scaled_int8_quant as jax_int8
from conch_tpu_torch.kernels.quantization.fp8 import static_scaled_fp8_quant_launcher
from conch_tpu_torch.kernels.quantization.int8 import static_scaled_int8_quant_launcher
from conch_tpu_torch.ops.quantization import (
    scaled_fp8_quant,
    scaled_int8_quant,
    static_scaled_fp8_quant,
    static_scaled_int8_quant,
)
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

SHAPES = [(1, 128), (16, 4096), (257, 1024), (7, 531)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _inputs(shape, dtype, gain, seed):
    """The same values on both sides: drawn in f32, rounded to the dtype by torch."""
    x = torch.from_numpy((np.random.default_rng(seed).normal(size=shape) * gain).astype(np.float32))
    x = x.to(DTYPES[dtype][1])
    return x, jnp.asarray(x.float().numpy(), DTYPES[dtype][0])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_static_scaled_int8_quant_matches_jax(shape, dtype, record_property):
    x, xj = _inputs(shape, dtype, 100.0, 31)
    scale = np.array([1.7], np.float32)
    ref, _ = jax_int8(xj, jnp.asarray(scale))
    before = static_scaled_int8_quant_launcher.launches
    out, out_scale = scaled_int8_quant(x, torch.from_numpy(scale))
    assert out.dtype == torch.int8 and out.shape == shape and out_scale.item() == np.float32(1.7)
    ref = np.asarray(ref, np.int32)
    np.testing.assert_allclose(out.numpy().astype(np.int32), ref, atol=1)
    record_property("int8_elements_differing", int((out.numpy() != ref).sum()))
    assert static_scaled_int8_quant_launcher.launches == before  # CPU: the plain version, no launch


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_static_scaled_fp8_quant_matches_jax(shape, dtype):
    x, xj = _inputs(shape, dtype, 10.0, 32)
    scale = np.array([0.5], np.float32)
    ref, _ = jax_fp8(xj, jnp.asarray(scale))
    before = static_scaled_fp8_quant_launcher.launches
    out, _ = scaled_fp8_quant(x, torch.from_numpy(scale))
    assert out.dtype == torch.float8_e4m3fn and out.shape == shape
    np.testing.assert_array_equal(out.view(torch.uint8).numpy(), np.asarray(ref).view(np.uint8))
    assert static_scaled_fp8_quant_launcher.launches == before


def test_scale_reciprocal_is_taken_in_f32():
    """x times the f32 reciprocal of the scale, not x / scale: at scale 0.37
    the two differ on 20 of these int8 inputs (x / scale lands on a whole
    number, the product just below it, and truncation drops a step) and on
    2 of these fp8 inputs. The port gives the JAX package's codes on all."""
    scale = np.array([0.37], np.float32)
    s = torch.from_numpy(scale)
    x_i8 = (torch.arange(-127, 128, dtype=torch.float32) * s).reshape(1, -1)
    x_f8 = (torch.linspace(-400.0, 400.0, 200001) * s).reshape(1, -1)
    ref_i8, _ = jax_int8(jnp.asarray(x_i8.numpy()), jnp.asarray(scale))
    ref_f8, _ = jax_fp8(jnp.asarray(x_f8.numpy()), jnp.asarray(scale))
    out_i8 = static_scaled_int8_quant(x_i8, s)
    out_f8 = static_scaled_fp8_quant(x_f8, s).view(torch.uint8)
    np.testing.assert_array_equal(out_i8.numpy(), np.asarray(ref_i8))
    np.testing.assert_array_equal(out_f8.numpy(), np.asarray(ref_f8).view(np.uint8))
    divided_i8 = (x_i8 / s).clamp(-128, 127).to(torch.int8)
    divided_f8 = (x_f8 / s).clamp(-448, 448).to(torch.float8_e4m3fn).view(torch.uint8)
    assert (divided_i8 != out_i8).sum() == 20 and (divided_f8 != out_f8).sum() == 2


def test_int8_truncates_and_saturates():
    x = torch.tensor([[1e6, -1e6, 1.9, -1.9, 126.99, -0.5] + [0.0] * 122])
    out, _ = scaled_int8_quant(x, torch.tensor([1.0]))
    assert out[0, :6].tolist() == [127, -128, 1, -1, 126, 0]


def test_fp8_saturates():
    x = torch.tensor([[1e6, -1e6, 448.0, 464.0] + [0.0] * 124])
    out, _ = scaled_fp8_quant(x, torch.tensor([1.0]))
    assert out[0, :4].float().tolist() == [448.0, -448.0, 448.0, 448.0]


def test_dynamic_not_implemented():
    x = torch.zeros((4, 128))
    with pytest.raises(NotImplementedError):
        scaled_int8_quant(x)
    with pytest.raises(NotImplementedError):
        scaled_fp8_quant(x)
