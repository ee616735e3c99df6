# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Port GPTQ-row / codebook GEMM (K1c's module, its plain version on the
CPU) against the JAX package's ``mixed_precision_gemm`` with
``layout="gptq"`` (the Pallas kernel ``_mixed_gemm_kernel`` in interpret
mode), and the nf4 and GPTQ-row int4 ``QuantizedLinear`` built on it.

Codes are random over each bit width's full range, packed by the JAX
package's numpy ``pack_rows``. The codebooks are the JAX package's NF4 and
FP4 tables. Tolerances as tests/test_torch_planar_gemm.py: tests/gemm_test.py's
``atol=min(5e-2*sqrt(K), 1), rtol=1e-1`` and max |diff| <= 1e-2 * max |ref|;
both sides dequantize in f32, round the weight to the activation dtype and
sum in f32.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.kernels.quantization.bitsandbytes.blockwise import FP4_MAGNITUDE_CODE, NF4_CODE as JAX_NF4_CODE
from conch_tpu.models.linear import QuantizedLinear as JaxQuantizedLinear
from conch_tpu.ops.quantization.gemm import mixed_precision_gemm as jax_gemm
from conch_tpu.utils.quant_utils import pack_rows as jax_pack_rows
from conch_tpu_torch.kernels.quantization.bitsandbytes.blockwise import NF4_CODE
from conch_tpu_torch.kernels.quantization.gemm import mixed_gemm_rows_launcher
from conch_tpu_torch.models.linear import QuantizedLinear, quantize_linear
from conch_tpu_torch.ops.quantization import mixed_precision_gemm
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BIAS = {2: 2, 4: 8, 8: 128}
FP4_CODE = tuple(float(v) for v in FP4_MAGNITUDE_CODE) + tuple(-float(v) for v in FP4_MAGNITUDE_CODE)
CODEBOOKS = {"nf4": tuple(float(v) for v in JAX_NF4_CODE), "fp4": FP4_CODE}
L = 3


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _assert_close(out, ref, k: int) -> None:
    out = out.float().numpy()
    ref = np.asarray(ref, dtype=np.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=min(5e-2 * math.sqrt(k), 1.0), rtol=1e-1)
    assert np.abs(out - ref).max() <= 1e-2 * np.abs(ref).max()


def _operands(rng, bits: int, k: int, n: int, group: int, zp_mode: str, scale_dtype, layers: int | None = None):
    lead = () if layers is None else (layers,)
    codes = rng.integers(0, 1 << bits, size=(*lead, k, n))
    packed = np.stack([jax_pack_rows(c, bits) for c in codes.reshape(-1, k, n)]).reshape(*lead, k * bits // 32, n)
    scales = jnp.asarray(rng.uniform(1e-3, 2e-2, size=(*lead, k // group, n)), scale_dtype)
    if zp_mode == "none":
        zp = None
    elif zp_mode == "scalar":
        zp = np.array([float(rng.integers(-4, 4))], np.float32)
    else:
        zp = rng.integers(-4, 4, size=(*lead, k // group, n)).astype(np.float32)
    return packed, scales, zp


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("zp_mode", ["none", "per-group", "scalar"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_gemm_matches_jax(bits, zp_mode, dtype):
    m, k, n, group = 9, 512, 256, 64
    rng = np.random.default_rng(bits * 10 + len(zp_mode))
    packed, scales, zp = _operands(rng, bits, k, n, group, zp_mode, jnp.bfloat16)
    x = rng.normal(size=(m, k)).astype(np.float32)
    ref = jax_gemm(jnp.asarray(x, JAX_DTYPES[dtype]), jnp.asarray(packed), scales,
                   None if zp is None else jnp.asarray(zp), bits, BIAS[bits], group)
    out = mixed_precision_gemm(torch.from_numpy(x).to(TORCH_DTYPES[dtype]), _to_torch(packed), _to_torch(scales),
                               None if zp is None else _to_torch(zp), bits, BIAS[bits], group, layout="gptq")
    assert out.dtype == TORCH_DTYPES[dtype]
    _assert_close(out, ref, k)


@pytest.mark.parametrize("book", ["nf4", "fp4"])
@pytest.mark.parametrize("zp_mode", ["none", "per-group"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codebook_gemm_matches_jax(book, zp_mode, dtype):
    """4-bit codes through a 16-entry codebook, f32 absmax per 64 rows (the
    nf4 projections' storage); the bias is ignored."""
    m, k, n, group = 9, 256, 384, 64
    rng = np.random.default_rng(len(book) + len(zp_mode))
    packed, absmax, zp = _operands(rng, 4, k, n, group, zp_mode, jnp.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    ref = jax_gemm(jnp.asarray(x, JAX_DTYPES[dtype]), jnp.asarray(packed), absmax,
                   None if zp is None else jnp.asarray(zp), 4, 0, group, codebook=CODEBOOKS[book])
    out = mixed_precision_gemm(torch.from_numpy(x).to(TORCH_DTYPES[dtype]), _to_torch(packed), _to_torch(absmax),
                               None if zp is None else _to_torch(zp), 4, 0, group, codebook=CODEBOOKS[book])
    _assert_close(out, ref, k)


@pytest.mark.parametrize("m", [1, 33])
def test_stacked_nf4_gemm_matches_jax(m):
    """Each layer of an (L, K/8, N) NF4 stack, selected by layer_index."""
    k, n, group = 256, 256, 64
    rng = np.random.default_rng(m)
    packed, absmax, _ = _operands(rng, 4, k, n, group, "none", jnp.float32, layers=L)
    x = rng.normal(size=(m, k)).astype(np.float32)
    xt = torch.from_numpy(x)
    for layer in range(L):
        ref = jax_gemm(jnp.asarray(x), jnp.asarray(packed), absmax, None, 4, 0, group,
                       codebook=CODEBOOKS["nf4"], layer_index=jnp.int32(layer))
        out = mixed_precision_gemm(xt, _to_torch(packed), _to_torch(absmax), None, 4, 0, group, codebook=NF4_CODE,
                                   layer_index=layer)
        _assert_close(out, ref, k)
        single = mixed_precision_gemm(xt, _to_torch(packed[layer]), _to_torch(absmax[layer]), None, 4, 0, group,
                                      codebook=NF4_CODE)
        torch.testing.assert_close(out, single, rtol=0, atol=0)


@pytest.mark.parametrize("k,n", [(256, 384), (128, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nf4_linear_matches_jax(k, n, dtype):
    """``nf4_from_dense`` (bf16-rounded transpose, K12q codes, GPTQ rows,
    f32 absmax) bit for bit as the JAX package's, and its product."""
    rng = np.random.default_rng(k + n)
    w = rng.normal(size=(k, n)).astype(np.float32) * 0.05
    jq = JaxQuantizedLinear.nf4_from_dense(w)
    tq = quantize_linear(torch.from_numpy(w), "nf4")
    assert tq.kind == jq.kind == "nf4" and tq.meta == jq.meta
    np.testing.assert_array_equal(tq.arrays["packed"].numpy(), np.asarray(jq.arrays["packed"]))
    np.testing.assert_array_equal(tq.arrays["absmax"].numpy(), np.asarray(jq.arrays["absmax"]))
    x = rng.normal(size=(7, k)).astype(np.float32)
    out = tq.apply(torch.from_numpy(x).to(TORCH_DTYPES[dtype]))
    _assert_close(out, jq.apply(jnp.asarray(x, JAX_DTYPES[dtype])), k)
    with pytest.raises(ValueError):  # pinned shape: nf4 stays unfused, as in JAX
        QuantizedLinear.concat_n([tq, tq])
    with pytest.raises(ValueError):
        quantize_linear(torch.zeros((96, 8)), "nf4")  # K not a multiple of the blocksize


@pytest.mark.parametrize("group", [4, 2])
def test_int4_gptq_rows_layout_matches_jax(group):
    """A group that is not a multiple of 8 cannot take the magic or planar
    packing: int4 falls back to GPTQ rows and K1c, as in the JAX package."""
    k, n = 256, 96
    rng = np.random.default_rng(group)
    w = rng.normal(size=(k, n)).astype(np.float32) * 0.05
    jq = JaxQuantizedLinear.int4_from_dense(w, group_size=group)
    tq = quantize_linear(torch.from_numpy(w), "int4", group_size=group)
    assert tq.meta == jq.meta and tq.meta["layout"] == "gptq" and tq.meta["out_features"] == n
    np.testing.assert_array_equal(tq.arrays["packed"].numpy(), np.asarray(jq.arrays["packed"]))
    x = rng.normal(size=(5, k)).astype(np.float32)
    out = tq.apply(torch.from_numpy(x))
    assert out.shape == (5, n)
    _assert_close(out, jq.apply(jnp.asarray(x)), k)


def test_rows_plain_version_counts_no_launch():
    rng = np.random.default_rng(5)
    packed, absmax, _ = _operands(rng, 4, 128, 64, 64, "none", jnp.float32)
    before = mixed_gemm_rows_launcher.launches
    mixed_gemm_rows_launcher(torch.zeros((4, 128), dtype=torch.bfloat16), _to_torch(packed), _to_torch(absmax), None,
                             4, 0, 64, NF4_CODE)
    assert mixed_gemm_rows_launcher.launches == before
