# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Port planar GEMM (K1b's module, its plain version on the CPU) against
the JAX package's ``mixed_precision_gemm`` with ``layout="planar"`` (the
Pallas kernel ``_mixed_gemm_planar_kernel`` in interpret mode), and the
int8 ``QuantizedLinear`` built on it.

Codes are random over each bit width's full range, packed by the JAX
package's numpy ``pack_rows_planar`` and carried across as they are, so a
swapped row index cannot pass on constant data. Tolerance:
tests/gemm_test.py's ``atol=min(5e-2*sqrt(K), 1), rtol=1e-1`` and the
scale-relative bound of the int4 tests, max |diff| <= 1e-2 * max |ref|:
both sides take the group's product of raw codes in f32 and subtract the
zero-point term after it, so they differ only in the order of the sums.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.models.linear import QuantizedLinear as JaxQuantizedLinear
from conch_tpu.ops.quantization.gemm import mixed_precision_gemm as jax_gemm
from conch_tpu.utils.quant_utils import pack_rows_planar as jax_pack_rows_planar
from conch_tpu_torch.kernels.quantization.gemm import mixed_gemm_planar_launcher
from conch_tpu_torch.models.linear import QuantizedLinear, quantize_linear
from conch_tpu_torch.ops.quantization import mixed_precision_gemm
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BIAS = {2: 2, 4: 8, 8: 128}
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


def _operands(rng, bits: int, k: int, n: int, group: int, zp_mode: str, layers: int | None = None):
    """Packed planar codes, bf16 scales and zero-points (None, one value, or
    per group), stacked when ``layers`` is given."""
    lead = () if layers is None else (layers,)
    codes = rng.integers(0, 1 << bits, size=(*lead, k, n))
    packed = np.stack([jax_pack_rows_planar(c, bits, group) for c in codes.reshape(-1, k, n)]).reshape(
        *lead, k * bits // 32, n
    )
    scales = jnp.asarray(rng.uniform(1e-3, 2e-2, size=(*lead, k // group, n)), jnp.bfloat16)
    if zp_mode == "none":
        zp = None
    elif zp_mode == "scalar":
        zp = np.array([float(rng.integers(0, 1 << bits))], np.float32)
    else:
        zp = rng.integers(0, 1 << bits, size=(*lead, k // group, n)).astype(np.float32)
    return packed, scales, zp


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("zp_mode", ["none", "per-group", "scalar"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_planar_gemm_matches_jax(bits, zp_mode, dtype):
    m, k, n, group = 9, 512, 256, 128
    rng = np.random.default_rng(bits * 10 + len(zp_mode))
    packed, scales, zp = _operands(rng, bits, k, n, group, zp_mode)
    x = rng.normal(size=(m, k)).astype(np.float32)
    ref = jax_gemm(jnp.asarray(x, JAX_DTYPES[dtype]), jnp.asarray(packed), scales,
                   None if zp is None else jnp.asarray(zp), bits, BIAS[bits], group, layout="planar")
    out = mixed_precision_gemm(torch.from_numpy(x).to(TORCH_DTYPES[dtype]), _to_torch(packed), _to_torch(scales),
                               None if zp is None else _to_torch(zp), bits, BIAS[bits], group, layout="planar")
    assert out.dtype == TORCH_DTYPES[dtype]
    _assert_close(out, ref, k)


@pytest.mark.parametrize("bits,group", [(8, 32), (4, 64), (2, 128)])
@pytest.mark.parametrize("zp_mode", ["none", "per-group"])
def test_planar_gemm_at_8_word_rows_matches_jax(bits, group, zp_mode):
    """Groups of 8 word rows (K1b's 8-row slices on the card): int8 at
    group 32 (DeepSeek's int8), 4-bit at 64 and 2-bit at 128 (the cases of
    tests/gemm_test.py:246), each layer of a stack against JAX's planar
    GEMM."""
    m, k, n = 9, 4 * group, 256
    rng = np.random.default_rng(bits * 100 + group + len(zp_mode))
    packed, scales, zp = _operands(rng, bits, k, n, group, zp_mode, layers=2)
    x = rng.normal(size=(m, k)).astype(np.float32)
    for layer in range(2):
        ref = jax_gemm(jnp.asarray(x), jnp.asarray(packed), scales, None if zp is None else jnp.asarray(zp), bits,
                       BIAS[bits], group, layout="planar", layer_index=jnp.int32(layer))
        out = mixed_precision_gemm(torch.from_numpy(x), _to_torch(packed), _to_torch(scales),
                                   None if zp is None else _to_torch(zp), bits, BIAS[bits], group, layout="planar",
                                   layer_index=layer)
        _assert_close(out, ref, k)


@pytest.mark.parametrize("m", [1, 33])
@pytest.mark.parametrize("zp_mode", ["none", "per-group"])
def test_stacked_planar_gemm_matches_jax(m, zp_mode):
    """Each layer of an (L, K/4, N) int8 stack, selected by layer_index (the
    per-group zero-points stacked with it)."""
    k, n, group = 256, 384, 128
    rng = np.random.default_rng(m)
    packed, scales, zp = _operands(rng, 8, k, n, group, zp_mode, layers=L)
    x = rng.normal(size=(m, k)).astype(np.float32)
    xt = torch.from_numpy(x)
    zp_t = None if zp is None else _to_torch(zp)
    for layer in range(L):
        ref = jax_gemm(jnp.asarray(x), jnp.asarray(packed), scales, None if zp is None else jnp.asarray(zp), 8, 128,
                       group, layout="planar", layer_index=jnp.int32(layer))
        out = mixed_precision_gemm(xt, _to_torch(packed), _to_torch(scales), zp_t, 8, 128, group, layout="planar",
                                   layer_index=layer)
        _assert_close(out, ref, k)
        single = mixed_precision_gemm(xt, _to_torch(packed[layer]), _to_torch(scales[layer]),
                                      None if zp is None else zp_t[layer], 8, 128, group, layout="planar")
        torch.testing.assert_close(out, single, rtol=0, atol=0)


@pytest.mark.parametrize("k,n", [(256, 384), (512, 128), (64, 40)])
def test_int8_linear_matches_jax(k, n):
    """``int8_grouped_from_dense`` (uint8b128, group min(128, K), planar,
    N unpadded) bit for bit as the JAX package's, and its product."""
    rng = np.random.default_rng(k + n)
    w = rng.normal(size=(k, n)).astype(np.float32) * 0.05
    jq = JaxQuantizedLinear.int8_grouped_from_dense(w)
    tq = quantize_linear(torch.from_numpy(w), "int8")
    assert tq.kind == jq.kind == "int8_grouped" and tq.meta == jq.meta and tq.meta["layout"] == "planar"
    np.testing.assert_array_equal(tq.arrays["packed"].numpy(), np.asarray(jq.arrays["packed"]))
    np.testing.assert_array_equal(tq.arrays["scales"].view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(jq.arrays["scales"]).view(np.uint16))
    x = rng.normal(size=(7, k)).astype(np.float32)
    _assert_close(tq.apply(torch.from_numpy(x)), jq.apply(jnp.asarray(x)), k)


def test_int8_concat_matches_jax():
    """concat_n of int8 projections is the JAX package's, and applies as the
    separate projections side by side."""
    rng = np.random.default_rng(7)
    k = 256
    pieces = [JaxQuantizedLinear.int8_grouped_from_dense(rng.normal(size=(k, n)).astype(np.float32) * 0.05)
              for n in (256, 128, 128)]
    fused = JaxQuantizedLinear.concat_n(pieces)
    port = [QuantizedLinear(q.kind, {a: _to_torch(v) for a, v in q.arrays.items()}, dict(q.meta)) for q in pieces]
    port_fused = QuantizedLinear.concat_n(port)
    for name in ("packed", "scales"):
        assert torch.equal(_to_torch(fused.arrays[name]), port_fused.arrays[name])
    x = torch.from_numpy(rng.normal(size=(5, k)).astype(np.float32))
    torch.testing.assert_close(port_fused.apply(x), torch.cat([q.apply(x) for q in port], dim=-1), rtol=1e-6,
                               atol=1e-6)


def test_planar_plain_version_counts_no_launch():
    rng = np.random.default_rng(5)
    packed, scales, _ = _operands(rng, 8, 256, 128, 128, "none")
    before = mixed_gemm_planar_launcher.launches
    mixed_gemm_planar_launcher(torch.zeros((4, 256), dtype=torch.bfloat16), _to_torch(packed), _to_torch(scales),
                               None, 8, 128, 128)
    assert mixed_gemm_planar_launcher.launches == before
