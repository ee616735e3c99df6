# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Port silu_and_mul (K6's module, its plain versions on the CPU) against
the JAX package's ops (the Pallas kernel in interpret mode), in both call
forms: fused ``[gate|up]`` halves and separate parts.

Inputs come from a numpy seed. Shapes include 300 rows (above the 128
rows the port took before K6) and d = 531 (not a multiple of 128, where
the JAX package slices the halves). Tolerances are those of
tests/activation_test.py:16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.ops.activation import silu_and_mul as jax_silu_and_mul
from conch_tpu.ops.activation.silu_and_mul import silu_and_mul_parts as jax_silu_and_mul_parts
from conch_tpu_torch.ops.activation import silu_and_mul, silu_and_mul_parts
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

TOLERANCES = {"float32": 1e-6, "bfloat16": 1e-2, "float16": 1e-3}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
SHAPES = [(1, 256), (17, 2048), (300, 512), (4, 1062), (2, 3, 256)]


def _check(out: torch.Tensor, ref, dtype: str) -> None:
    assert out.dtype == TORCH_DTYPES[dtype]
    tol = TOLERANCES[dtype]
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, dtype=np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_silu_and_mul_halves_match_jax(shape, dtype):
    x = np.random.default_rng(shape[-1]).normal(size=shape).astype(np.float32) * 3
    ref = jax_silu_and_mul(jnp.asarray(x, JAX_DTYPES[dtype]))
    out = silu_and_mul(torch.from_numpy(x).to(TORCH_DTYPES[dtype]))
    assert out.shape == shape[:-1] + (shape[-1] // 2,)
    _check(out, ref, dtype)


@pytest.mark.parametrize("rows,d", [(1, 128), (300, 256), (4, 531)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_silu_and_mul_parts_match_jax(rows, d, dtype):
    rng = np.random.default_rng(rows + d)
    gate = rng.normal(size=(rows, d)).astype(np.float32) * 3
    up = rng.normal(size=(rows, d)).astype(np.float32)
    ref = jax_silu_and_mul_parts(jnp.asarray(gate, JAX_DTYPES[dtype]), jnp.asarray(up, JAX_DTYPES[dtype]))
    out = silu_and_mul_parts(torch.from_numpy(gate).to(TORCH_DTYPES[dtype]), torch.from_numpy(up).to(TORCH_DTYPES[dtype]))
    assert out.shape == (rows, d)
    _check(out, ref, dtype)
    # The same values as halves of one fused row (the CPU's vectorized
    # sigmoid may differ by an ulp between strided and contiguous inputs).
    fused = silu_and_mul(torch.from_numpy(np.concatenate([gate, up], axis=1)).to(TORCH_DTYPES[dtype]))
    torch.testing.assert_close(out, fused, rtol=TOLERANCES[dtype], atol=TOLERANCES[dtype])
