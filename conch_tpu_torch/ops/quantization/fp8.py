# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""FP8 quantization public ops (counterpart of ``conch_tpu/ops/quantization/fp8.py``)."""

from __future__ import annotations

import torch

from conch_tpu_torch.kernels.quantization.fp8 import static_scaled_fp8_quant_launcher


def static_scaled_fp8_quant(input_tensor: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize the input tensor to float8_e4m3fn with a static scalar scale
    (K9 on CUDA).

    Args:
        input_tensor: Input to scale, shape (num_tokens, hidden_size),
            float32, bfloat16 or float16.
        scale: Static scaling factor, one element.

    Returns:
        float8_e4m3fn tensor of the same shape: ``clip(x * (1 / scale),
        -448, 448)`` rounded to nearest even.
    """
    assert scale.numel() == 1
    return static_scaled_fp8_quant_launcher(input_tensor, scale)


def scaled_fp8_quant(
    input_tensor: torch.Tensor,
    scale: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scaled fp8 quantization (static only, like the JAX package).

    Returns:
        (quantized fp8 tensor, scale).
    """
    if scale is None:
        msg = "Dynamic fp8 quantization not implemented yet"
        raise NotImplementedError(msg)
    return static_scaled_fp8_quant(input_tensor, scale), scale
