# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Golden static-scale fp8 quantization (counterpart of
``conch_tpu/reference/quantization/fp8.py``): scale, saturate, round."""

from __future__ import annotations

import torch

from conch_tpu_torch.reference.quantization.int8 import inverted_scale

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def scaled_fp8_quant(input_tensor: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(x * (1 / scale), -448, 448)`` cast to float8_e4m3fn, rounding to
    nearest even."""
    scaled = input_tensor.float() * inverted_scale(scale)
    return scaled.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
