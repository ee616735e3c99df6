# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Port rms_norm (K4's module, its plain version on the CPU) against the
JAX package's op (the Pallas kernel in interpret mode).

Inputs come from a numpy seed. Shapes include 300 rows (above the 128
rows the port took before K4) and hidden 531 (not a multiple of 128).
Tolerances are those of tests/rms_norm_test.py:25.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.ops.normalization import rms_norm as jax_rms_norm
from conch_tpu_torch.kernels.normalization.rms_norm import rms_norm_launcher
from conch_tpu_torch.ops.normalization import rms_norm
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

TOLERANCES = {"float32": 1e-5, "float16": 1e-3, "bfloat16": 2e-2}
JAX_DTYPES = {"float32": jnp.float32, "float16": jnp.float16, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}
SHAPES = [(1, 128), (7, 768), (32, 4096), (300, 256), (5, 531), (2, 3, 256)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_rms_norm_matches_jax(shape, dtype):
    rng = np.random.default_rng(len(shape) * 1000 + shape[-1])
    x = rng.normal(size=shape).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    ref = jax_rms_norm(jnp.asarray(x, JAX_DTYPES[dtype]), jnp.asarray(w, JAX_DTYPES[dtype]), 1e-5)
    before = rms_norm_launcher.launches
    out = rms_norm(torch.from_numpy(x).to(TORCH_DTYPES[dtype]), torch.from_numpy(w).to(TORCH_DTYPES[dtype]), 1e-5)
    assert rms_norm_launcher.launches == before  # the CPU takes the plain version, no kernel
    assert out.dtype == TORCH_DTYPES[dtype] and out.shape == shape
    tol = TOLERANCES[dtype]
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, dtype=np.float32), atol=tol, rtol=tol)
