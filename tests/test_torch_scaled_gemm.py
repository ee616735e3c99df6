# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Port scaled GEMM (K8's module, its plain version on the CPU) against
the JAX package's ``scaled_gemm`` (the Pallas kernel ``_scaled_gemm_kernel``
in interpret mode), and the w8a8 ``QuantizedLinear`` built on it.

Tolerances are tests/gemm_test.py's: int8 ``atol=1e-1, rtol=1e-1``, fp8
``atol=1.0, rtol=1e-1``. Beside them the int8 path must match exactly
(both sides sum in exact integers and apply ``* sa * sb`` in f32 in the
same order), and the row scales span 10x so that swapping the row and
column scales could not pass.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.models.linear import QuantizedLinear as JaxQuantizedLinear
from conch_tpu.ops.quantization.gemm import scaled_gemm as jax_scaled_gemm
from conch_tpu_torch.kernels.quantization.gemm import scaled_gemm_launcher
from conch_tpu_torch.models.linear import QuantizedLinear, quantize_linear
from conch_tpu_torch.ops.quantization import scaled_gemm
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

MNK_SHAPES = [(1, 256, 512), (16, 512, 256), (33, 384, 640)]
JAX_OUT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_OUT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
L = 3


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _scales(rng, m: int, n: int, per_channel: bool):
    if per_channel:
        return np.logspace(-3, -2, m).astype(np.float32), rng.uniform(0.001, 0.02, size=(n,)).astype(np.float32)
    return np.array([0.01], np.float32), np.array([0.02], np.float32)


@pytest.mark.parametrize("m,k,n", MNK_SHAPES)
@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_scaled_gemm_int8_matches_jax(m, k, n, per_channel, out):
    rng = np.random.default_rng(m * 7 + k)
    a = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    b = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    sa, sb = _scales(rng, m, n, per_channel)
    ref = np.asarray(jax_scaled_gemm(jnp.asarray(a), jnp.asarray(b), jnp.asarray(sa), jnp.asarray(sb), JAX_OUT[out]),
                     np.float32)
    got = scaled_gemm(_to_torch(a), _to_torch(b), _to_torch(sa), _to_torch(sb), TORCH_OUT[out])
    assert got.dtype == TORCH_OUT[out] and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-1, rtol=1e-1)
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_scaled_gemm_int8_bias_and_stack_match_jax():
    """The bias added after the scaling (f32 result, as jnp promotes), and
    each layer of an (L, K, N) stack with (L, N) column scales."""
    rng = np.random.default_rng(3)
    m, k, n = 16, 256, 128
    a = rng.integers(-64, 64, size=(m, k)).astype(np.int8)
    b = rng.integers(-64, 64, size=(L, k, n)).astype(np.int8)
    sa = np.logspace(-3, -2, m).astype(np.float32)
    sb = rng.uniform(0.001, 0.02, size=(L, n)).astype(np.float32)
    bias = rng.normal(size=(n,)).astype(np.float32)
    for layer in range(L):
        ref = jax_scaled_gemm(jnp.asarray(a), jnp.asarray(b[layer]), jnp.asarray(sa), jnp.asarray(sb[layer]),
                              jnp.bfloat16, bias=jnp.asarray(bias))
        got = scaled_gemm(_to_torch(a), _to_torch(b), _to_torch(sa), _to_torch(sb), torch.bfloat16,
                          _to_torch(bias), layer_index=layer)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-1, rtol=1e-1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_scaled_gemm_fp8_matches_jax(out):
    rng = np.random.default_rng(4)
    m, k, n = 16, 256, 128
    a = np.asarray(jnp.asarray(rng.normal(size=(m, k)), jnp.float8_e4m3fn))
    b = np.asarray(jnp.asarray(rng.normal(size=(k, n)), jnp.float8_e4m3fn))
    sa, sb = np.array([0.5], np.float32), rng.uniform(0.5, 2.0, size=(n,)).astype(np.float32)
    ref = jax_scaled_gemm(jnp.asarray(a), jnp.asarray(b), jnp.asarray(sa), jnp.asarray(sb), JAX_OUT[out])
    got = scaled_gemm(_to_torch(a), _to_torch(b), _to_torch(sa), _to_torch(sb), TORCH_OUT[out])
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=1.0, rtol=1e-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_linear_matches_jax(dtype):
    """``w8a8_from_dense`` bit for bit as the JAX package's; ``apply``
    quantizes each activation row (rows 10x apart in size) as the JAX
    package does and gives its product."""
    rng = np.random.default_rng(11)
    k, n, m = 256, 384, 6
    w = rng.normal(size=(k, n)).astype(np.float32) * 0.02
    jq = JaxQuantizedLinear.w8a8_from_dense(w)
    tq = quantize_linear(torch.from_numpy(w), "w8a8")
    assert tq.kind == "w8a8" and tq.meta == jq.meta == {}
    np.testing.assert_array_equal(tq.arrays["w8"].numpy(), np.asarray(jq.arrays["w8"]))
    np.testing.assert_array_equal(tq.arrays["out_scales"].numpy(), np.asarray(jq.arrays["out_scales"]))
    x = rng.normal(size=(m, k)).astype(np.float32) * np.logspace(0, 1, m, dtype=np.float32)[:, None]
    jdt = JAX_OUT[dtype]
    ref = np.asarray(jq.apply(jnp.asarray(x, jdt)), np.float32)
    got = tq.apply(torch.from_numpy(x).to(TORCH_OUT[dtype]))
    assert got.dtype == TORCH_OUT[dtype]
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-1, rtol=1e-1)
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_w8a8_concat_matches_jax():
    """concat_n of w8a8 projections concatenates ``w8`` and ``out_scales``."""
    rng = np.random.default_rng(12)
    pieces = [JaxQuantizedLinear.w8a8_from_dense(rng.normal(size=(128, n)).astype(np.float32)) for n in (128, 64)]
    fused = JaxQuantizedLinear.concat_n(pieces)
    port = QuantizedLinear.concat_n([QuantizedLinear("w8a8", {a: _to_torch(v) for a, v in q.arrays.items()}, {})
                                     for q in pieces])
    for name in ("w8", "out_scales"):
        assert torch.equal(_to_torch(fused.arrays[name]), port.arrays[name])


def test_scaled_plain_version_counts_no_launch():
    before = scaled_gemm_launcher.launches
    scaled_gemm_launcher(torch.zeros((4, 64), dtype=torch.int8), torch.zeros((64, 32), dtype=torch.int8),
                         torch.ones(4), torch.ones(32), torch.bfloat16)
    assert scaled_gemm_launcher.launches == before
