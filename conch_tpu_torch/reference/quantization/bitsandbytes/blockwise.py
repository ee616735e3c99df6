# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Golden bitsandbytes blockwise codecs (counterpart of
``conch_tpu/reference/quantization/bitsandbytes/blockwise.py``).

An implementation apart from the kernels' plain versions: scalar codecs
that count thresholds one value at a time, and blockwise codecs that
compare every value with every threshold at once and divide by the absmax
(where the kernels multiply by its reciprocal). The tests use them as a
second yardstick beside the JAX package.
"""

from __future__ import annotations

import torch

from conch_tpu_torch.kernels.quantization.bitsandbytes.blockwise import (
    FP4_LEVEL_TO_CODE,
    FP4_MAGNITUDE_CODE,
    FP4_THRESHOLDS,
    NF4_CODE,
    nf4_thresholds,
)


def nf4_quantize_scalar(x: float) -> int:
    """Scalar NF4 encode: how many NF4 thresholds ``x`` strictly exceeds."""
    return int((torch.tensor(x, dtype=torch.float32) > nf4_thresholds()).sum())


def fp4_quantize_scalar(x: float) -> int:
    """Scalar FP4 encode: sign bit (8) plus the code of the magnitude's level."""
    level = int((torch.tensor(abs(x), dtype=torch.float32) > torch.tensor(FP4_THRESHOLDS)).sum())
    return (8 if x < 0 else 0) + FP4_LEVEL_TO_CODE[level]


def nf4_dequantize_scalar(code: int) -> float:
    return float(torch.tensor(NF4_CODE[code], dtype=torch.float32))


def fp4_dequantize_scalar(code: int) -> float:
    sign = -1.0 if code >= 8 else 1.0
    return sign * float(torch.tensor(FP4_MAGNITUDE_CODE[code & 0x7], dtype=torch.float32))


def quantize_blockwise(
    x: torch.Tensor, blocksize: int, quant_type: str, code: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise quantize; returns (packed uint8 (n / 2, 1) for 4-bit or
    codes (n,) for the 8-bit ``code``, per-block absmax f32)."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    num_blocks = -(-n // blocksize)
    padded = torch.nn.functional.pad(flat, (0, num_blocks * blocksize - n)).view(num_blocks, blocksize)
    absmax = padded.abs().amax(dim=1)
    scaled = padded / absmax[:, None]

    if quant_type == "nf4":
        codes = (scaled[..., None] > nf4_thresholds(scaled.device)).sum(-1)
    elif quant_type == "fp4":
        level = (scaled.abs()[..., None] > torch.tensor(FP4_THRESHOLDS, device=scaled.device)).sum(-1)
        codes = torch.where(scaled < 0, 8, 0) + torch.tensor(FP4_LEVEL_TO_CODE, device=scaled.device)[level]
    else:
        if code is None:
            msg = "8-bit quantization requires a code table"
            raise ValueError(msg)
        sorted_code = code.to(torch.float32)
        vals = scaled.reshape(-1)
        hi = torch.searchsorted(sorted_code, vals, side="left").clamp(1, 255)
        lo = hi - 1
        mid = (sorted_code[lo] + sorted_code[hi]) * 0.5
        return torch.where(vals > mid, hi, lo).to(torch.uint8)[:n], absmax

    pairs = codes.reshape(-1, 2)
    packed = (pairs[:, 0] * 16 + pairs[:, 1]).to(torch.uint8)[: n // 2]
    return packed.reshape(-1, 1), absmax


def dequantize_blockwise(
    packed: torch.Tensor,
    absmax: torch.Tensor,
    blocksize: int,
    output_size: int,
    quant_type: str,
    code: torch.Tensor | None = None,
) -> torch.Tensor:
    """Blockwise dequantize back to f32 (output_size,)."""
    flat = packed.reshape(-1).to(torch.uint8)
    if quant_type in ("nf4", "fp4"):
        codes = torch.stack([flat >> 4, flat & 0x0F], dim=-1).reshape(-1).long()
        if quant_type == "nf4":
            values = torch.tensor(NF4_CODE, dtype=torch.float32, device=flat.device)[codes]
        else:
            magnitude = torch.tensor(FP4_MAGNITUDE_CODE, dtype=torch.float32, device=flat.device)[codes & 0x7]
            values = torch.where(codes >= 8, -1.0, 1.0) * magnitude
    else:
        if code is None:
            msg = "8-bit dequantization requires a code table"
            raise ValueError(msg)
        values = code.to(torch.float32)[flat.long()]

    num_blocks = -(-output_size // blocksize)
    values = torch.nn.functional.pad(values, (0, num_blocks * blocksize - values.numel()))
    values = values.view(num_blocks, blocksize) * absmax.to(torch.float32)[:, None]
    return values.reshape(-1)[:output_size]
