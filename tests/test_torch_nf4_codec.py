# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Port NF4/FP4 encoder (K12q's module, its plain version on the CPU) and
``quantize_4bit`` against the JAX package's (the Pallas kernel
``_quantize4_kernel`` in interpret mode): packed bytes and absmax must be
identical, byte for byte, for float32 and bfloat16 inputs, at blocksizes
the Pallas path takes and beyond, with an all-zero block (absmax 0, codes
of 0 * 0) and a partial last block."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.kernels.quantization.bitsandbytes.blockwise import NF4_CODE as JAX_NF4_CODE
from conch_tpu.kernels.quantization.bitsandbytes.blockwise import NF4_THRESHOLDS as JAX_NF4_THRESHOLDS
from conch_tpu.ops.quantization.bitsandbytes.functional import quantize_4bit as jax_quantize_4bit
from conch_tpu_torch.kernels.quantization.bitsandbytes.blockwise import (
    NF4_CODE,
    nf4_thresholds,
    quantize4_launcher,
    quantize4_plain,
)
from conch_tpu_torch.ops.quantization.bitsandbytes import quantize_4bit
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _input(rng, shape, scale: float = 1.0) -> np.ndarray:
    x = rng.normal(size=shape).astype(np.float32) * scale
    x.reshape(-1)[64:128] = 0.0  # an all-zero block at blocksize 64
    x.reshape(-1)[200] = 3.0 * scale  # an outlier: codes of its block squeeze toward 0
    return x


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
@pytest.mark.parametrize("blocksize", [64, 128, 512, 1024, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_4bit_bytes_match_jax(quant_type, blocksize, dtype):
    rng = np.random.default_rng(blocksize)
    x = _input(rng, (24, 160), 0.05)
    packed_j, state_j = jax_quantize_4bit(jnp.asarray(x, JAX_DTYPES[dtype]), blocksize=blocksize, quant_type=quant_type)
    packed, state = quantize_4bit(torch.from_numpy(x).to(TORCH_DTYPES[dtype]), blocksize=blocksize,
                                  quant_type=quant_type)
    assert packed.dtype == torch.uint8 and tuple(packed.shape) == tuple(packed_j.shape)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(packed_j))
    np.testing.assert_array_equal(state.absmax.numpy(), np.asarray(state_j.absmax))
    assert state.shape == tuple(state_j.shape) and state.blocksize == blocksize and state.quant_type == quant_type
    assert state.dtype == TORCH_DTYPES[dtype] and not state.nested


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_codes_cover_every_level(quant_type):
    """Values on and around every threshold (a ramp over [-1, 1] times the
    absmax) land on the JAX package's codes, so the strict comparison and
    the FP4 level table are the same."""
    ramp = np.linspace(-1.0, 1.0, 4096, dtype=np.float32)
    x = np.concatenate([ramp, np.asarray(JAX_NF4_THRESHOLDS, np.float32), [1.0, -1.0]]).astype(np.float32)
    x = np.concatenate([x, np.zeros((-x.size) % 64, np.float32)])
    packed_j, state_j = jax_quantize_4bit(jnp.asarray(x), blocksize=64, quant_type=quant_type)
    packed, absmax = quantize4_plain(torch.from_numpy(x), 64, quant_type)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(packed_j).reshape(-1))
    np.testing.assert_array_equal(absmax.numpy(), np.asarray(state_j.absmax))
    codes = np.stack([packed.numpy() >> 4, packed.numpy() & 15], axis=1).reshape(-1)
    # Every code is reached (FP4's 8, a negative value below the first
    # threshold, needs a block whose absmax dwarfs it: not on this ramp).
    assert set(np.unique(codes)) == set(range(16)) - ({8} if quant_type == "fp4" else set())


def test_tables_match_jax():
    np.testing.assert_array_equal(np.asarray(NF4_CODE, np.float32), JAX_NF4_CODE)
    np.testing.assert_array_equal(nf4_thresholds().numpy(), JAX_NF4_THRESHOLDS)


def test_unported_options_raise_and_plain_counts_no_launch():
    x = torch.randn(256)
    with pytest.raises(NotImplementedError):
        quantize_4bit(x, quant_type="nf4", quant_storage=torch.float32)
    with pytest.raises(NotImplementedError):
        quantize_4bit(x, quant_type="fp8")
    with pytest.raises(NotImplementedError):
        quantize_4bit(x, blocksize=32)
    with pytest.raises(ValueError):
        quantize4_launcher(torch.randn(255), 64, "nf4")  # odd size
    before = quantize4_launcher.launches
    quantize4_launcher(x, 64, "nf4")
    assert quantize4_launcher.launches == before
