# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Port int4 magic GEMM (K1's module, its plain version on the CPU) against
the JAX package's ``mixed_precision_gemm`` (the Pallas kernel in interpret
mode), and the int4 ``QuantizedLinear`` built on it.

Weights are quantized and magic-packed by the JAX package from a numpy
seed and carried across as they are. Tolerance: tests/gemm_test.py's
``atol=min(5e-2*sqrt(K), 1), rtol=1e-1``, and a tighter scale-relative
bound, max |diff| <= 1e-2 * max |ref|: both sides sum exact products in
f32 and differ only in the order of the sums and the output rounding,
while a wrong nibble order would shift every output by a fraction of its
scale, which at K = 4096 an atol of 1 could miss.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.models.linear import QuantizedLinear as JaxQuantizedLinear
from conch_tpu.ops.quantization.gemm import mixed_precision_gemm as jax_gemm
from conch_tpu_torch.kernels.quantization.gemm import mixed_gemm_magic_launcher
from conch_tpu_torch.models.linear import QuantizedLinear, quantize_linear
from conch_tpu_torch.ops.quantization import mixed_precision_gemm
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
L = 3


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, dtype=np.float32)


def _assert_close(out, ref, k: int) -> None:
    out, ref = _f32(out), _f32(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=min(5e-2 * math.sqrt(k), 1.0), rtol=1e-1)
    assert np.abs(out - ref).max() <= 1e-2 * np.abs(ref).max()


def _jax_int4(rng, k: int, n: int, group_size: int = 128) -> JaxQuantizedLinear:
    return JaxQuantizedLinear.int4_from_dense(rng.normal(size=(k, n)).astype(np.float32) * 0.05, group_size)


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("m", [1, 8, 33])
@pytest.mark.parametrize("k,n", [(256, 384), (512, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_matches_jax(m, k, n, dtype):
    rng = np.random.default_rng(m * 1000 + k)
    q = _jax_int4(rng, k, n)
    assert q.meta["layout"] == "magic"
    x = rng.normal(size=(m, k)).astype(np.float32)
    ref = jax_gemm(jnp.asarray(x, JAX_DTYPES[dtype]), q.arrays["packed"], q.arrays["scales"], None, 4, 8, 128,
                   layout="magic")
    out = mixed_precision_gemm(torch.from_numpy(x).to(TORCH_DTYPES[dtype]), _to_torch(q.arrays["packed"]),
                               _to_torch(q.arrays["scales"]), None, 4, 8, 128, layout="magic")
    assert out.dtype == TORCH_DTYPES[dtype]
    _assert_close(out, ref, k)


@pytest.mark.parametrize("m", [1, 8, 33])
@pytest.mark.parametrize("scale_dtype", ["bfloat16", "float16"])
def test_f16_gemm_matches_jax(m, scale_dtype):
    """f16 x over bf16 scales (the JAX package's int4 init at an f16
    model dtype) and over f16 scales (a GPTQ checkpoint's), with group 1
    of the weight scaled down so that its scales lie near 1e-5, where a
    scaled f16 weight is subnormal: a single weight and layer 1 of a
    stack, f16 out."""
    k, n = 512, 256
    rng = np.random.default_rng(16 + m)
    dense = [rng.normal(size=(k, n)).astype(np.float32) * 0.05 for _ in range(2)]
    for w in dense:
        w[128:256] *= 5e-4
    layers = [JaxQuantizedLinear.int4_from_dense(w, 128) for w in dense]
    packed = jnp.stack([q.arrays["packed"] for q in layers])
    scales = jnp.stack([q.arrays["scales"] for q in layers]).astype(JAX_DTYPES[scale_dtype])
    assert 1e-6 < float(jnp.abs(scales[:, 1].astype(jnp.float32)).max()) < 3e-5
    x = rng.normal(size=(m, k)).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.float16), torch.from_numpy(x).to(torch.float16)
    for layer in (None, 1):
        pj, sj = (packed[1], scales[1]) if layer is None else (packed, scales)
        li = {} if layer is None else {"layer_index": jnp.int32(layer)}
        ref = jax_gemm(xj, pj, sj, None, 4, 8, 128, layout="magic", **li)
        out = mixed_precision_gemm(xt, _to_torch(pj), _to_torch(sj), None, 4, 8, 128, layout="magic",
                                   layer_index=layer)
        assert out.dtype == torch.float16 and _to_torch(sj).dtype == TORCH_DTYPES[scale_dtype]
        _assert_close(out, ref, k)


@pytest.mark.parametrize("m", [1, 8, 33])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stacked_gemm_matches_jax(m, dtype):
    """Each layer of an (L, K/8, N) stack, selected by layer_index."""
    k, n = 512, 256
    rng = np.random.default_rng(m)
    layers = [_jax_int4(rng, k, n) for _ in range(L)]
    packed = jnp.stack([q.arrays["packed"] for q in layers])
    scales = jnp.stack([q.arrays["scales"] for q in layers])
    x = rng.normal(size=(m, k)).astype(np.float32)
    xt = torch.from_numpy(x).to(TORCH_DTYPES[dtype])
    for layer in range(L):
        ref = jax_gemm(jnp.asarray(x, JAX_DTYPES[dtype]), packed, scales, None, 4, 8, 128, layout="magic",
                       layer_index=jnp.int32(layer))
        out = mixed_precision_gemm(xt, _to_torch(packed), _to_torch(scales), None, 4, 8, 128, layout="magic",
                                   layer_index=layer)
        _assert_close(out, ref, k)
        # The layer is selected, not copied: the per-layer product is the same.
        single = mixed_precision_gemm(xt, _to_torch(packed[layer]), _to_torch(scales[layer]), None, 4, 8, 128,
                                      layout="magic")
        torch.testing.assert_close(out, single, rtol=0, atol=0)


@pytest.mark.parametrize("m", [1, 8, 33])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group64_gemm_matches_jax(m, dtype):
    """K1 at group 64 (the magic layout's group is 8 word rows, not 16): a
    single weight and each layer of a stack, against JAX's group-64 GEMM."""
    k, n = 512, 256
    rng = np.random.default_rng(64 + m)
    layers = [_jax_int4(rng, k, n, 64) for _ in range(L)]
    assert layers[0].meta["layout"] == "magic" and layers[0].meta["group_size"] == 64
    packed = jnp.stack([q.arrays["packed"] for q in layers])
    scales = jnp.stack([q.arrays["scales"] for q in layers])
    assert scales.shape == (L, k // 64, n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    xj, xt = jnp.asarray(x, JAX_DTYPES[dtype]), torch.from_numpy(x).to(TORCH_DTYPES[dtype])
    ref = jax_gemm(xj, layers[0].arrays["packed"], layers[0].arrays["scales"], None, 4, 8, 64, layout="magic")
    out = mixed_precision_gemm(xt, _to_torch(layers[0].arrays["packed"]), _to_torch(layers[0].arrays["scales"]),
                               None, 4, 8, 64, layout="magic")
    _assert_close(out, ref, k)
    for layer in range(L):
        ref = jax_gemm(xj, packed, scales, None, 4, 8, 64, layout="magic", layer_index=jnp.int32(layer))
        out = mixed_precision_gemm(xt, _to_torch(packed), _to_torch(scales), None, 4, 8, 64, layout="magic",
                                   layer_index=layer)
        _assert_close(out, ref, k)


@pytest.mark.parametrize("m", [1, 8, 33])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group32_gemm_matches_jax(m, dtype):
    """K1 at group 32 (DeepSeek's int4: 4 word rows a group, two groups a
    slice on the card), K 416 (13 groups: the card's last slice is half
    past K): a single weight and each layer of a stack, against JAX's
    group-32 GEMM."""
    k, n = 416, 256
    rng = np.random.default_rng(32 + m)
    layers = [_jax_int4(rng, k, n, 32) for _ in range(L)]
    assert layers[0].meta["layout"] == "magic" and layers[0].meta["group_size"] == 32
    packed = jnp.stack([q.arrays["packed"] for q in layers])
    scales = jnp.stack([q.arrays["scales"] for q in layers])
    assert scales.shape == (L, k // 32, n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    xj, xt = jnp.asarray(x, JAX_DTYPES[dtype]), torch.from_numpy(x).to(TORCH_DTYPES[dtype])
    ref = jax_gemm(xj, layers[0].arrays["packed"], layers[0].arrays["scales"], None, 4, 8, 32, layout="magic")
    out = mixed_precision_gemm(xt, _to_torch(layers[0].arrays["packed"]), _to_torch(layers[0].arrays["scales"]),
                               None, 4, 8, 32, layout="magic")
    _assert_close(out, ref, k)
    for layer in range(L):
        ref = jax_gemm(xj, packed, scales, None, 4, 8, 32, layout="magic", layer_index=jnp.int32(layer))
        out = mixed_precision_gemm(xt, _to_torch(packed), _to_torch(scales), None, 4, 8, 32, layout="magic",
                                   layer_index=layer)
        _assert_close(out, ref, k)


def test_linear_int4_concat_and_out_features_match_jax():
    """concat_n of int4 projections equals packing the concatenation (bit
    for bit, as in JAX) and applies as the separate projections side by
    side; a pack-time-padded projection slices back to its N and refuses
    to fuse."""
    rng = np.random.default_rng(3)
    k, m = 256, 8
    pieces = [_jax_int4(rng, k, n) for n in (256, 128, 128)]
    fused = JaxQuantizedLinear.concat_n(pieces)
    port = [QuantizedLinear("int4", {a: _to_torch(v) for a, v in q.arrays.items()}, dict(q.meta)) for q in pieces]
    port_fused = QuantizedLinear.concat_n(port)
    for name in ("packed", "scales"):
        assert torch.equal(_to_torch(fused.arrays[name]), port_fused.arrays[name])
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    separate = torch.cat([q.apply(x) for q in port], dim=-1)
    torch.testing.assert_close(port_fused.apply(x), separate, rtol=1e-6, atol=1e-6)
    _assert_close(port_fused.apply(x), fused.apply(jnp.asarray(x.numpy())), k)

    w = rng.normal(size=(k, 40)).astype(np.float32) * 0.05
    padded_jax = JaxQuantizedLinear.int4_from_dense(w)
    padded = quantize_linear(torch.from_numpy(w), "int4")
    assert padded.meta["out_features"] == 40 and padded.arrays["packed"].shape == (k // 8, 128)
    out = padded.apply(x)
    assert out.shape == (m, 40)
    _assert_close(out, padded_jax.apply(jnp.asarray(x.numpy())), k)
    with pytest.raises(ValueError):
        QuantizedLinear.concat_n([padded, padded])


def test_unported_layouts_and_kinds_raise():
    """What the GEMM op and the projections still refuse: a stack without a
    layer and a layer without a stack, the JAX launcher's layout checks
    (planar or magic with a codebook, magic at other bit widths), the magic
    layout with zero-points (not ported), and unknown kinds and modes."""
    rng = np.random.default_rng(4)
    q = _jax_int4(rng, 256, 128)
    x = torch.zeros((2, 256))
    packed, scales = _to_torch(q.arrays["packed"]), _to_torch(q.arrays["scales"])
    with pytest.raises(ValueError):  # a stack without a layer, and a layer without a stack
        mixed_precision_gemm(x, packed[None], scales[None], None, 4, 8, 128, layout="magic")
    with pytest.raises(ValueError):
        mixed_precision_gemm(x, packed, scales, None, 4, 8, 128, layout="magic", layer_index=0)
    for layout in ("planar", "magic"):
        with pytest.raises(ValueError, match="codebook"):
            mixed_precision_gemm(x, packed, scales, None, 4, 0, 128, layout=layout, codebook=tuple(range(16)))
    with pytest.raises(ValueError, match="magic"):
        mixed_precision_gemm(x, packed[:16], scales, None, 2, 2, 128, layout="magic")
    with pytest.raises(NotImplementedError):
        mixed_precision_gemm(x, packed, scales, torch.zeros(1), 4, 8, 128, layout="magic")
    with pytest.raises(ValueError):
        QuantizedLinear("int3", {}, {})
    with pytest.raises(ValueError):
        quantize_linear(torch.zeros((256, 128)), "fp6")


def test_plain_version_counts_no_launch():
    rng = np.random.default_rng(5)
    q = _jax_int4(rng, 256, 128)
    before = mixed_gemm_magic_launcher.launches
    mixed_gemm_magic_launcher(torch.zeros((4, 256), dtype=torch.bfloat16), _to_torch(q.arrays["packed"]),
                              _to_torch(q.arrays["scales"]), 128, 8)
    assert mixed_gemm_magic_launcher.launches == before
