# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Port quantization and the row packings against the JAX package.

The port's torch versions (``conch_tpu_torch.utils.quant_utils``,
``QuantizedLinear.int4_from_dense``) must give codes, scales and packed
words bit for bit equal to ``conch_tpu.utils.quant_utils`` and
``conch_tpu.models.linear`` from the same float32 weight (numpy seed),
including all-zero padded columns and K below one group of 128; the GPTQ
row and planar packings, for 1, 2, 4 and 8-bit codes over their full range,
must be the numpy ones word for word and unpack back.
"""

import jax
import numpy as np
import pytest
import torch

from conch_tpu.models.linear import QuantizedLinear as JaxQuantizedLinear
from conch_tpu.models.linear import padded_out_features as jax_padded_out_features
from conch_tpu.types.scalar_type import scalar_types as jax_scalar_types
from conch_tpu.utils import quant_utils as jax_quant
from conch_tpu_torch.models.linear import QuantizedLinear, padded_out_features
from conch_tpu_torch.types.scalar_type import ScalarType, scalar_types
from conch_tpu_torch.utils.quant_utils import (
    pack_rows,
    pack_rows_magic,
    pack_rows_planar,
    quantize_weights,
    unpack_rows,
    unpack_rows_magic,
    unpack_rows_planar,
)
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

# (K, N, group): a multi-group K, K below 128 (one group spans K), and N
# that is not a multiple of 128.
SHAPES = [(512, 256, 128), (256, 384, 128), (64, 40, 64), (96, 136, 32)]


def _weight(k: int, n: int, seed: int = 0) -> np.ndarray:
    w = np.random.default_rng(seed).standard_normal((k, n), dtype=np.float32) * 0.02
    w[:, -5:] = 0.0  # all-zero columns, as pack-time N padding makes
    return w


@pytest.mark.parametrize("k,n,group", SHAPES)
@pytest.mark.parametrize("biased", [True, False])
def test_quantize_and_pack_bit_identical(k, n, group, biased):
    w = _weight(k, n)
    jax_type, port_type = (
        (jax_scalar_types.uint4b8, scalar_types.uint4b8) if biased else (jax_scalar_types.uint4, ScalarType.uint(4))
    )
    j_ref, j_q, j_s, _ = jax_quant.quantize_weights(w, jax_type, group)
    t_ref, t_q, t_s = quantize_weights(torch.from_numpy(w), port_type, group)
    np.testing.assert_array_equal(t_q.numpy(), j_q)
    np.testing.assert_array_equal(t_s.numpy(), j_s)
    np.testing.assert_array_equal(t_ref.numpy(), j_ref)
    assert t_s.dtype == torch.float32 and (t_s[:, -5:] == 0).all()
    packed = pack_rows_magic(t_q, group)
    assert packed.dtype == torch.int32 and packed.shape == (k // 8, n)
    np.testing.assert_array_equal(packed.numpy(), jax_quant.pack_rows_magic(j_q, 4, group))


@pytest.mark.parametrize("k,n,group", SHAPES)
def test_unpack_round_trip(k, n, group):
    codes = torch.from_numpy(np.random.default_rng(1).integers(0, 16, size=(k, n)))
    packed = pack_rows_magic(codes, group)
    torch.testing.assert_close(unpack_rows_magic(packed, k, group), codes, rtol=0, atol=0)
    np.testing.assert_array_equal(
        unpack_rows_magic(packed, k, group).numpy(), jax_quant.unpack_rows_magic(packed.numpy(), k, group)
    )


@pytest.mark.parametrize("k,n", [(256, 384), (64, 40), (512, 4136)])
def test_int4_from_dense_matches_jax(k, n):
    """The whole int4 projection: N padding, group min(128, K), bf16 scales."""
    w = _weight(k, n, seed=2)
    jq = JaxQuantizedLinear.int4_from_dense(w)
    tq = QuantizedLinear.int4_from_dense(torch.from_numpy(w))
    assert tq.kind == jq.kind == "int4"
    assert tq.meta == jq.meta
    np.testing.assert_array_equal(tq.arrays["packed"].numpy(), np.asarray(jq.arrays["packed"]))
    jax_scale_bits = np.asarray(jax.device_get(jq.arrays["scales"])).view(np.uint16)
    np.testing.assert_array_equal(tq.arrays["scales"].view(torch.int16).numpy().view(np.uint16), jax_scale_bits)


@pytest.mark.parametrize("n", [256, 576, 4096, 6144, 128256])
def test_padded_out_features_matches_jax(n):
    assert padded_out_features(n) == jax_padded_out_features(n)


def test_scalar_type_range_matches_jax():
    for ours, ref in ((scalar_types.uint4b8, jax_scalar_types.uint4b8), (ScalarType.uint(4), jax_scalar_types.uint4)):
        assert (ours.min(), ours.max(), ours.bias, ours.has_bias()) == (ref.min(), ref.max(), ref.bias, ref.has_bias())
    for name in ("uint4", "uint8", "uint2b2", "uint4b8", "uint8b128"):
        ours, ref = getattr(scalar_types, name), getattr(jax_scalar_types, name)
        assert (ours.size_bits, ours.min(), ours.max(), ours.bias) == (ref.size_bits, ref.min(), ref.max(), ref.bias)


ROW_SHAPES = [(256, 96, 128), (64, 40, 64), (512, 32, 256)]


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("k,n,group", ROW_SHAPES)
def test_row_packings_bit_identical(bits, k, n, group):
    """GPTQ rows (word r, field i: row r*epp + i) and planar (group row
    i*rpg + r) equal the numpy packers, and unpack to the codes."""
    codes = np.random.default_rng(bits).integers(0, 1 << bits, size=(k, n))
    t = torch.from_numpy(codes)
    rows = pack_rows(t, bits)
    assert rows.dtype == torch.int32 and rows.shape == (k * bits // 32, n)
    np.testing.assert_array_equal(rows.numpy(), jax_quant.pack_rows(codes, bits))
    np.testing.assert_array_equal(unpack_rows(rows, bits, k).numpy(), codes)
    np.testing.assert_array_equal(unpack_rows(rows, bits, k).numpy(), jax_quant.unpack_rows(rows.numpy(), bits, k))
    planar = pack_rows_planar(t, bits, group)
    np.testing.assert_array_equal(planar.numpy(), jax_quant.pack_rows_planar(codes, bits, group))
    np.testing.assert_array_equal(unpack_rows_planar(planar, bits, k, group).numpy(), codes)
    np.testing.assert_array_equal(
        unpack_rows_planar(planar, bits, k, group).numpy(), jax_quant.unpack_rows_planar(planar.numpy(), bits, k, group)
    )


@pytest.mark.parametrize("k,n,group", [(512, 256, 128), (64, 40, 64)])
def test_uint8b128_quantize_bit_identical(k, n, group):
    w = _weight(k, n, seed=3)
    j_ref, j_q, j_s, _ = jax_quant.quantize_weights(w, jax_scalar_types.uint8b128, group)
    t_ref, t_q, t_s = quantize_weights(torch.from_numpy(w), scalar_types.uint8b128, group)
    np.testing.assert_array_equal(t_q.numpy(), j_q)
    np.testing.assert_array_equal(t_s.numpy(), j_s)
    np.testing.assert_array_equal(t_ref.numpy(), j_ref)
    with pytest.raises(ValueError):
        pack_rows(t_q[:-2], 8)  # K not a multiple of the pack factor
