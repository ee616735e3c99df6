# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Blockwise NF4/FP4 encoder: the CUDA kernel (K12q) and its plain version.

The kernel is ``csrc/quantize4.cu``; it replaces
``conch_tpu/kernels/quantization/bitsandbytes/blockwise.py:_quantize4_kernel``
(launcher ``quantize_blockwise_launcher`` with ``quant_type`` "nf4" or
"fp4"). Per block of ``blocksize`` elements of the flat input: the f32
absmax, the IEEE reciprocal (0 for an all-zero block), the scaled values,
their codes, and two codes a byte with the even element in the high
nibble: bytes and absmax bit for bit the JAX package's. The tables below
are the port's own copies of that module's. ``quantize4_launcher`` takes
the plain version for CPU tensors only; on CUDA it launches the kernel or
raises. The 8-bit dynamic code and the decoders are not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from conch_tpu_torch.kernels.common import cdiv, check_launch, dtype_code, kernel_function, stream_of

# The 16 quantiles of a standard normal normalized to [-1, 1] (QLoRA appendix E).
NF4_CODE = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453, -0.28444138169288635,
    -0.18477343022823334, -0.09105003625154495, 0.0, 0.07958029955625534, 0.16093020141124725,
    0.24611230194568634, 0.33791524171829224, 0.44070982933044434, 0.5626170039176941, 0.7229568362236023, 1.0,
)
# FP4 values by 3-bit magnitude code (the sign is bit 3).
FP4_MAGNITUDE_CODE = (0.0, 0.0052083333, 0.6666666, 1.0, 0.333333, 0.5, 0.166666, 0.25)
FP4_THRESHOLDS = (0.00260417, 0.0859375, 0.208333334, 0.29166667, 0.4166667, 0.5833334, 0.83333334)
FP4_LEVEL_TO_CODE = (0, 1, 6, 7, 4, 5, 2, 3)
KERNEL_MAX_BLOCKSIZE = 2048  # the CUDA kernel holds a block in one warp's registers


def nf4_thresholds(device: torch.device | str = "cpu") -> torch.Tensor:
    """Midpoints of consecutive NF4 values, in f32 as the JAX package
    computes them."""
    code = torch.tensor(NF4_CODE, dtype=torch.float32, device=device)
    return (code[:-1] + code[1:]) / 2.0


def _rank(values: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """How many thresholds each value strictly exceeds (uint8)."""
    rank = torch.zeros(values.shape, dtype=torch.uint8, device=values.device)
    for t in thresholds:
        rank += values > t
    return rank


def quantize4_plain(x: torch.Tensor, blocksize: int, quant_type: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K12q on any device: (packed (size / 2,)
    uint8, absmax (ceil(size / blocksize),) f32)."""
    flat = x.reshape(-1).to(torch.float32)
    size = flat.numel()
    num_blocks = cdiv(size, blocksize)
    blocks = torch.nn.functional.pad(flat, (0, num_blocks * blocksize - size)).view(num_blocks, blocksize)
    absmax = blocks.abs().amax(dim=1)
    recip = torch.where(absmax > 0.0, 1.0 / absmax, torch.zeros_like(absmax))
    scaled = (blocks * recip[:, None]).reshape(-1)[:size]
    if quant_type == "nf4":
        codes = _rank(scaled, nf4_thresholds(x.device))
    else:
        level = _rank(scaled.abs(), torch.tensor(FP4_THRESHOLDS, dtype=torch.float32, device=x.device))
        lut = torch.tensor(FP4_LEVEL_TO_CODE, dtype=torch.uint8, device=x.device)
        codes = lut[level.long()] + (scaled < 0.0).to(torch.uint8) * 8
    return (codes[0::2] << 4) | codes[1::2], absmax


def _quantize4_cuda(x: torch.Tensor, blocksize: int, quant_type: str) -> tuple[torch.Tensor, torch.Tensor]:
    size = x.numel()
    if not x.is_contiguous() or blocksize % 2 or not 0 < blocksize <= KERNEL_MAX_BLOCKSIZE:
        msg = (
            f"quantize4 kernel: needs a contiguous input and an even blocksize up to {KERNEL_MAX_BLOCKSIZE} "
            f"(blocksize {blocksize})"
        )
        raise ValueError(msg)
    packed = torch.empty((size // 2,), dtype=torch.uint8, device=x.device)
    absmax = torch.empty((cdiv(size, blocksize),), dtype=torch.float32, device=x.device)
    fn = kernel_function("conch_quantize4", (
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ))
    code = fn(x.data_ptr(), dtype_code(x), packed.data_ptr(), absmax.data_ptr(), size, blocksize,
              int(quant_type == "nf4"), stream_of(x))
    check_launch("conch_quantize4", code)
    quantize4_launcher.launches += 1
    return packed, absmax


def quantize4_launcher(x: torch.Tensor, blocksize: int, quant_type: str) -> tuple[torch.Tensor, torch.Tensor]:
    """NF4/FP4-encode ``x`` (flattened; an even number of float32 or
    bfloat16 values) in blocks of ``blocksize``: (packed uint8 (size / 2,),
    absmax float32 (ceil(size / blocksize),)).

    ``launches`` counts kernel launches.
    """
    if quant_type not in ("nf4", "fp4"):
        msg = f"quantize4 encodes nf4 or fp4, got {quant_type!r}"
        raise ValueError(msg)
    if x.numel() % 2:
        msg = f"4-bit quantization requires an even input size, got {x.numel()}"
        raise ValueError(msg)
    if x.device.type == "cpu":
        return quantize4_plain(x, blocksize, quant_type)
    return _quantize4_cuda(x, blocksize, quant_type)


quantize4_launcher.launches = 0
