# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Blockwise bitsandbytes codecs: the NF4/FP4 encoder (K12q) and decoder
(K12d), their plain versions, and the 8-bit dynamic code.

K12q is ``csrc/quantize4.cu``; it replaces
``conch_tpu/kernels/quantization/bitsandbytes/blockwise.py:_quantize4_kernel``
(launcher ``quantize_blockwise_launcher`` with ``quant_type`` "nf4" or
"fp4"). Per block of ``blocksize`` elements of the flat input: the f32
absmax, the IEEE reciprocal (0 for an all-zero block), the scaled values,
their codes, and two codes a byte with the even element in the high
nibble: bytes and absmax bit for bit the JAX package's.

K12d is ``csrc/dequantize4.cu``; it replaces ``_dequantize4_kernel``
(launcher ``dequantize_blockwise_launcher``, "nf4" and "fp4"; above
blocksize 512 the JAX package computes the same function in XLA, and the
port sends every blocksize to K12d): each code's table value times its
block's absmax in f32, cast once to the output dtype, bit for bit.

The tables below are the port's own copies of that module's. The 8-bit
dynamic code ("fp8" in the JAX package: a 256-entry code table) is plain
torch on either device, because the JAX package computes it in XLA and
has no Pallas kernel for it: that is its own dispatch, not a fallback.
``quantize4_launcher`` and ``dequantize4_launcher`` take their plain
versions for CPU tensors only; on CUDA they launch their kernels or raise.
"""

from __future__ import annotations

import ctypes

import torch

from conch_tpu_torch.kernels.common import (
    FLOAT_DTYPES,
    cdiv,
    check_launch,
    dtype_code,
    kernel_function,
    require_cuda,
    sm_count,
    stream_of,
)

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
KERNEL_MAX_BLOCKSIZE = 4096  # K12q: a block of 4096 held in the registers of one CTA


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


def _blocks(x: torch.Tensor, blocksize: int) -> torch.Tensor:
    """The flat input in f32, zero-padded to whole blocks: (blocks, blocksize)."""
    flat = x.reshape(-1).to(torch.float32)
    num_blocks = cdiv(flat.numel(), blocksize)
    return torch.nn.functional.pad(flat, (0, num_blocks * blocksize - flat.numel())).view(num_blocks, blocksize)


def _times_absmax(values: torch.Tensor, absmax: torch.Tensor, blocksize: int, output_dtype: torch.dtype) -> torch.Tensor:
    """Each decoded f32 value times its block's absmax in f32, cast once to
    ``output_dtype``: the decoders' last step."""
    blocks = _blocks(values, blocksize)
    scaled = blocks * absmax.reshape(-1)[: blocks.shape[0]].to(torch.float32)[:, None]
    return scaled.reshape(-1)[: values.numel()].to(output_dtype)


def _scaled(x: torch.Tensor, blocksize: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The encoders' first step: (each value times its block's f32 absmax
    reciprocal, 0 for an all-zero block, flat; the f32 absmax)."""
    blocks = _blocks(x, blocksize)
    absmax = blocks.abs().amax(dim=1)
    recip = torch.where(absmax > 0.0, 1.0 / absmax, torch.zeros_like(absmax))
    return (blocks * recip[:, None]).reshape(-1)[: x.numel()], absmax


def quantize4_plain(x: torch.Tensor, blocksize: int, quant_type: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K12q on any device: (packed (size / 2,)
    uint8, absmax (ceil(size / blocksize),) f32)."""
    scaled, absmax = _scaled(x, blocksize)
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
    code = fn(x.data_ptr(), dtype_code(x, FLOAT_DTYPES), packed.data_ptr(), absmax.data_ptr(), size, blocksize,
              int(quant_type == "nf4"), stream_of(x))
    check_launch("conch_quantize4", code)
    quantize4_launcher.launches += 1
    return packed, absmax


def quantize4_launcher(x: torch.Tensor, blocksize: int, quant_type: str) -> tuple[torch.Tensor, torch.Tensor]:
    """NF4/FP4-encode ``x`` (flattened; an even number of float32, bfloat16
    or float16 values) in blocks of ``blocksize``: (packed uint8 (size / 2,),
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


# -- K12d: the NF4 / FP4 decoder --------------------------------------------


def decode_table(quant_type: str, device: torch.device | str = "cpu") -> torch.Tensor:
    """The 16 f32 values of the 4-bit codes: NF4's, or FP4's magnitudes for
    codes 0..7 and their negations (the sign bit) for 8..15."""
    if quant_type == "nf4":
        return torch.tensor(NF4_CODE, dtype=torch.float32, device=device)
    magnitude = torch.tensor(FP4_MAGNITUDE_CODE, dtype=torch.float32, device=device)
    return torch.cat([magnitude, -magnitude])


def _check_decode(packed: torch.Tensor, absmax: torch.Tensor, blocksize: int, quant_type: str,
                  output_dtype: torch.dtype) -> None:
    if quant_type not in ("nf4", "fp4"):
        msg = f"dequantize4 decodes nf4 or fp4, got {quant_type!r}"
        raise ValueError(msg)
    if output_dtype not in FLOAT_DTYPES:
        msg = f"dequantize4 outputs float32, bfloat16 or float16, got {output_dtype}"
        raise ValueError(msg)
    if packed.dtype != torch.uint8 or blocksize <= 0 or absmax.numel() < cdiv(2 * packed.numel(), blocksize):
        msg = (
            f"dequantize4: needs uint8 codes and an absmax per block of {blocksize} (got {packed.dtype}, "
            f"{packed.numel()} bytes, {absmax.numel()} absmax values)"
        )
        raise ValueError(msg)


def dequantize4_plain(packed: torch.Tensor, absmax: torch.Tensor, blocksize: int, quant_type: str,
                      output_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of K12d on any device: the flat (2 * bytes,)
    decode in ``output_dtype``."""
    flat = packed.reshape(-1)
    codes = torch.stack([flat >> 4, flat & 0x0F], dim=1).reshape(-1).long()
    return _times_absmax(decode_table(quant_type, packed.device)[codes], absmax, blocksize, output_dtype)


def _dequantize4_cuda(packed: torch.Tensor, absmax: torch.Tensor, blocksize: int, quant_type: str,
                      output_dtype: torch.dtype) -> torch.Tensor:
    absmax = absmax.to(torch.float32)
    require_cuda(packed, absmax)
    if not (packed.is_contiguous() and absmax.is_contiguous()) or packed.data_ptr() % 4 or blocksize % 8:
        msg = (
            f"dequantize4 kernel: needs contiguous codes on a 4-byte boundary, a contiguous absmax and a "
            f"blocksize that is a multiple of 8 (blocksize {blocksize})"
        )
        raise ValueError(msg)
    num_bytes = packed.numel()
    out = torch.empty((2 * num_bytes,), dtype=output_dtype, device=packed.device)
    fn = kernel_function("conch_dequantize4", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ))
    code = fn(packed.data_ptr(), absmax.data_ptr(), out.data_ptr(), dtype_code(out, FLOAT_DTYPES), num_bytes,
              blocksize, int(quant_type == "nf4"), sm_count(packed.device.index), stream_of(packed))
    check_launch("conch_dequantize4", code)
    dequantize4_launcher.launches += 1
    return out


def dequantize4_launcher(packed: torch.Tensor, absmax: torch.Tensor, blocksize: int, quant_type: str,
                         output_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """NF4/FP4-decode the uint8 codes ``packed`` (two a byte, the even
    element in the high nibble) with one absmax per ``blocksize`` elements:
    the flat (2 * bytes,) tensor in ``output_dtype`` (float32, bfloat16 or
    float16).

    ``launches`` counts kernel launches.
    """
    _check_decode(packed, absmax, blocksize, quant_type, output_dtype)
    if packed.device.type == "cpu":
        return dequantize4_plain(packed, absmax, blocksize, quant_type, output_dtype)
    return _dequantize4_cuda(packed, absmax, blocksize, quant_type, output_dtype)


dequantize4_launcher.launches = 0


# -- the 8-bit dynamic code (plain torch, as the JAX package's XLA) ---------


def code8_encode(scaled: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """Nearest-code rounding into a sorted 256-entry f32 code table (the JAX
    package's ``_code8_encode``): the left insertion index clipped to
    [1, 255], then the lower neighbour unless the value lies above the f32
    midpoint of the two."""
    hi = torch.searchsorted(code, scaled, side="left").clamp_(1, 255)
    lo = hi - 1
    midpoint = (code[lo] + code[hi]) * 0.5
    return torch.where(scaled > midpoint, hi, lo).to(torch.uint8)


def quantize8(x: torch.Tensor, code: torch.Tensor, blocksize: int) -> tuple[torch.Tensor, torch.Tensor]:
    """8-bit dynamic-code blockwise quantization: (codes uint8 (size,),
    absmax f32 (ceil(size / blocksize),)); an all-zero block scales by 0."""
    scaled, absmax = _scaled(x, blocksize)
    return code8_encode(scaled, code.to(torch.float32).contiguous()), absmax


def dequantize8(codes: torch.Tensor, absmax: torch.Tensor, code: torch.Tensor, blocksize: int,
                output_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The inverse: ``code[c] * absmax`` of each block in f32, cast to ``output_dtype``."""
    return _times_absmax(code.to(torch.float32)[codes.reshape(-1).long()], absmax, blocksize, output_dtype)


# -- the launchers of the JAX package's blockwise.py ------------------------


def quantize_blockwise_launcher(
    x: torch.Tensor, code: torch.Tensor | None, blocksize: int, input_size: int, quant_type: str
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise quantize ``x`` (flattened) to NF4/FP4 (K12q; packed uint8
    (size / 2, 1)) or to the 8-bit ``code`` (uint8 (size,)): (codes, f32
    absmax). The JAX package's launcher of the same name."""
    if input_size != x.numel():
        msg = f"input_size {input_size} for an input of {x.numel()} values"
        raise ValueError(msg)
    if quant_type in ("nf4", "fp4"):
        packed, absmax = quantize4_launcher(x, blocksize, quant_type)
        return packed.reshape(-1, 1), absmax
    if code is None:
        msg = "8-bit quantization requires a code table"
        raise ValueError(msg)
    return quantize8(x, code, blocksize)


def dequantize_blockwise_launcher(
    x: torch.Tensor, absmax: torch.Tensor, code: torch.Tensor | None, blocksize: int, output_size: int,
    quant_type: str, output_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Blockwise dequantize NF4/FP4 (K12d; two codes a byte) or 8-bit codes
    to a flat ``output_dtype`` tensor of ``output_size`` values. Raises
    where the codes do not hold exactly ``output_size`` values."""
    per_byte = 2 if quant_type in ("nf4", "fp4") else 1
    if x.numel() * per_byte != output_size:
        msg = f"{x.numel()} bytes of {quant_type} codes do not hold {output_size} values"
        raise ValueError(msg)
    if per_byte == 2:
        return dequantize4_launcher(x.reshape(-1), absmax, blocksize, quant_type, output_dtype)
    if code is None:
        msg = "8-bit dequantization requires a code table"
        raise ValueError(msg)
    return dequantize8(x, absmax, code, blocksize, output_dtype)
