# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Golden static-scale int8 quantization (counterpart of
``conch_tpu/reference/quantization/int8.py``): scale, clip, truncate."""

from __future__ import annotations

import torch


def inverted_scale(scale: torch.Tensor) -> torch.Tensor:
    """The f32 reciprocal of a one-element scale, taken in f32 as the TPU
    kernel takes it (not in Python's float64)."""
    return torch.reciprocal(scale.reshape(()).float())


def scaled_int8_quant(input_tensor: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(x * (1 / scale), -128, 127)`` cast to int8 by truncation toward
    zero (torch's ``.to(int8)``, as the TPU kernel's ``astype``)."""
    scaled = input_tensor.float() * inverted_scale(scale)
    return scaled.clamp(-128.0, 127.0).to(torch.int8)
