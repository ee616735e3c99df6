# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Port fused_add_rms_norm (K4b's module, its plain version on the CPU)
and rms_norm in float16 (K4's) against the JAX package's ops (the Pallas
kernels in interpret mode).

Inputs come from a numpy seed. Shapes and tolerances are those of
tests/rms_norm_test.py (``TOLERANCES`` for the normalized output). The sum
``x + residual`` is held bit for bit: both packages round one f32 add to
the dtype.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.ops.normalization import fused_add_rms_norm as jax_fused_add_rms_norm
from conch_tpu.ops.normalization import rms_norm as jax_rms_norm
from conch_tpu_torch.kernels.normalization.rms_norm import fused_add_rms_norm_launcher, rms_norm_launcher
from conch_tpu_torch.ops.normalization import fused_add_rms_norm, rms_norm
from conch_tpu_torch.reference.normalization.rms_norm import fused_add_rms_norm as fused_add_rms_norm_ref
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

TOLERANCES = {"float32": 1e-5, "float16": 1e-3, "bfloat16": 2e-2}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
SHAPES = [(1, 128), (7, 768), (32, 4096), (5, 531)]


def _bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_fused_add_rms_norm_matches_jax(shape, dtype):
    rng = np.random.default_rng(shape[0] * 10000 + shape[1])
    x, r = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    w = rng.normal(size=shape[-1:]).astype(np.float32)
    jd, td = JAX_DTYPES[dtype], TORCH_DTYPES[dtype]
    ref_out, ref_res = jax_fused_add_rms_norm(jnp.asarray(x, jd), jnp.asarray(r, jd), jnp.asarray(w, jd), 1e-6)
    xt, rt = torch.from_numpy(x).to(td), torch.from_numpy(r).to(td)
    before = fused_add_rms_norm_launcher.launches
    out, res = fused_add_rms_norm(xt, rt, torch.from_numpy(w).to(td), 1e-6)
    assert fused_add_rms_norm_launcher.launches == before  # the CPU takes the plain version, no kernel
    assert out.dtype == res.dtype == td and out.shape == res.shape == shape
    np.testing.assert_array_equal(_bits(res.float().numpy()), _bits(np.asarray(ref_res, np.float32)))
    tol = TOLERANCES[dtype]
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref_out, np.float32), atol=tol, rtol=tol)
    # New tensors: the inputs are not updated.
    assert torch.equal(xt, torch.from_numpy(x).to(td)) and torch.equal(rt, torch.from_numpy(r).to(td))


def test_fused_add_rms_norm_3d_and_reference():
    """(..., hidden) inputs keep their shape; the op equals the golden
    reference (one plain version)."""
    rng = np.random.default_rng(11)
    x, r = (torch.from_numpy(rng.normal(size=(2, 5, 256)).astype(np.float32)).to(torch.bfloat16) for _ in range(2))
    w = torch.from_numpy(rng.normal(size=256).astype(np.float32)).to(torch.bfloat16)
    out, res = fused_add_rms_norm(x, r, w, 1e-5)
    ref_out, ref_res = fused_add_rms_norm_ref(x, r, w, 1e-5)
    assert out.shape == res.shape == (2, 5, 256)
    assert torch.equal(out, ref_out) and torch.equal(res, ref_res)


@pytest.mark.parametrize("shape", [(7, 768), (5, 531)])
def test_rms_norm_float16_matches_jax(shape):
    rng = np.random.default_rng(shape[1])
    x = rng.normal(size=shape).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    ref = jax_rms_norm(jnp.asarray(x, jnp.float16), jnp.asarray(w, jnp.float16), 1e-5)
    before = rms_norm_launcher.launches
    out = rms_norm(torch.from_numpy(x).half(), torch.from_numpy(w).half(), 1e-5)
    assert rms_norm_launcher.launches == before
    assert out.dtype == torch.float16 and out.shape == shape
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=1e-3, rtol=1e-3)
