# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Port gelu_tanh_and_mul (K10b's module, its plain versions on the CPU)
against the JAX package's ops (the Pallas kernel in interpret mode).

Both call forms: fused ``[gate|up]`` halves and separate parts (row-strided
views of one fused input, as the model would slice them). d 256, 300 (not
a multiple of 128, which the JAX op routes through its parts launcher) and
1024; f32 and bf16. Tolerances are those of tests/activation_test.py:16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.ops.activation import gelu_tanh_and_mul as jax_gelu
from conch_tpu.ops.activation import gelu_tanh_and_mul_parts as jax_gelu_parts
from conch_tpu_torch.kernels.activation.gelu_tanh_and_mul import (
    gelu_tanh_and_mul_launcher,
    gelu_tanh_and_mul_parts_launcher,
)
from conch_tpu_torch.ops.activation import gelu_tanh_and_mul, gelu_tanh_and_mul_parts
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

TOLERANCES = {"float32": 1e-6, "bfloat16": 1e-2, "float16": 1e-3}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
SHAPES = [(1, 512), (17, 600), (130, 2048)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("form", ["halves", "parts"])
def test_gelu_tanh_and_mul_matches_jax(shape, dtype, form):
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    x = (2.0 * rng.normal(size=shape)).astype(np.float32)
    d = shape[1] // 2
    jd, td = JAX_DTYPES[dtype], TORCH_DTYPES[dtype]
    jx, tx = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    before = gelu_tanh_and_mul_launcher.launches + gelu_tanh_and_mul_parts_launcher.launches
    if form == "halves":
        ref, out = jax_gelu(jx), gelu_tanh_and_mul(tx)
    else:
        ref, out = jax_gelu_parts(jx[:, :d], jx[:, d:]), gelu_tanh_and_mul_parts(tx[:, :d], tx[:, d:])
    assert gelu_tanh_and_mul_launcher.launches + gelu_tanh_and_mul_parts_launcher.launches == before
    assert out.dtype == td and out.shape == (shape[0], d)
    tol = TOLERANCES[dtype]
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol)


def test_gelu_tanh_and_mul_3d_and_tanh_form():
    """A (2, 9, 512) input keeps its leading axes, and the sigmoid form the
    kernel evaluates equals the tanh form of the JAX reference."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(2, 9, 512)).astype(np.float32))
    out = gelu_tanh_and_mul(x)
    g, u = x[..., :256].double(), x[..., 256:].double()
    tanh_form = 0.5 * g * (1.0 + torch.tanh(np.sqrt(2.0 / np.pi) * (g + 0.044715 * g**3))) * u
    assert out.shape == (2, 9, 256)
    torch.testing.assert_close(out.double(), tanh_form, atol=1e-6, rtol=1e-6)
