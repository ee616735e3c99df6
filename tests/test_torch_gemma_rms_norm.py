# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Port gemma_rms_norm (K10a's module, its plain version on the CPU)
against the JAX package's op (the Pallas kernel in interpret mode).

Inputs come from a numpy seed, with random weights (the model initializes
them to zero, where ``(1 + w)`` is 1 and a dropped weight would pass).
Hidden 256 and 300 (not a multiple of 128), with and without the residual,
f32, bf16 and f16 (which the JAX launcher computes in f32 and casts once,
as the port does). Tolerances are those of tests/gemma_rms_norm_test.py:15.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.ops.normalization import gemma_rms_norm as jax_gemma_rms_norm
from conch_tpu_torch.kernels.normalization.gemma_rms_norm import gemma_rms_norm_launcher
from conch_tpu_torch.ops.normalization import gemma_rms_norm

TOLERANCES = {"float32": 1e-5, "bfloat16": 1e-2, "float16": 1e-3}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
SHAPES = [(7, 256), (300, 256), (5, 300), (2, 3, 300)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("use_residual", [False, True])
def test_gemma_rms_norm_matches_jax(shape, dtype, use_residual):
    rng = np.random.default_rng(shape[0] * 1000 + shape[-1])
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=shape[-1]).astype(np.float32)
    r = rng.normal(size=shape).astype(np.float32) if use_residual else None
    jd, td = JAX_DTYPES[dtype], TORCH_DTYPES[dtype]
    ref = jax_gemma_rms_norm(
        jnp.asarray(x, jd), jnp.asarray(w, jd), 1e-6, None if r is None else jnp.asarray(r, jd)
    )
    before = gemma_rms_norm_launcher.launches
    out = gemma_rms_norm(
        torch.from_numpy(x).to(td), torch.from_numpy(w).to(td), 1e-6,
        None if r is None else torch.from_numpy(r).to(td),
    )
    assert gemma_rms_norm_launcher.launches == before  # the CPU takes the plain version, no kernel
    outs, refs = (out, ref) if use_residual else ((out,), (ref,))
    tol = TOLERANCES[dtype]
    for o, e in zip(outs, refs):
        assert o.dtype == td and o.shape == shape
        np.testing.assert_allclose(o.float().numpy(), np.asarray(e, dtype=np.float32), atol=tol, rtol=tol)


def test_gemma_rms_norm_keeps_the_product_in_f32():
    """Gemma rounds once, after the weight multiply: with bf16 inputs the
    result equals the f32 product rounded to bf16, which Llama's rms_norm
    (rounding before the multiply) does not give here."""
    from conch_tpu_torch.ops.normalization import rms_norm

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(64, 300)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.normal(size=300).astype(np.float32)).bfloat16()
    xf = x.float()
    exact = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6) * (1 + w.float())).bfloat16()
    assert torch.equal(gemma_rms_norm(x, w, 1e-6), exact)
    assert not torch.equal(rms_norm(x, (1 + w.float()).bfloat16(), 1e-6), exact)
