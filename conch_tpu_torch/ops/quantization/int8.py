# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Int8 quantization public ops (counterpart of ``conch_tpu/ops/quantization/int8.py``)."""

from __future__ import annotations

import torch

from conch_tpu_torch.kernels.quantization.int8 import static_scaled_int8_quant_launcher


def static_scaled_int8_quant(input_tensor: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize the input tensor to int8 with a static scalar scale (K9 on CUDA).

    Args:
        input_tensor: Input to scale, shape (num_tokens, hidden_size),
            float32, bfloat16 or float16.
        scale: Static scaling factor, one element.

    Returns:
        int8 tensor of the same shape: ``clip(x * (1 / scale), -128, 127)``
        truncated toward zero.
    """
    assert scale.numel() == 1
    return static_scaled_int8_quant_launcher(input_tensor, scale)


def scaled_int8_quant(
    input_tensor: torch.Tensor,
    scale: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scaled int8 quantization (static only, like the JAX package).

    Returns:
        (quantized int8 tensor, scale).
    """
    if scale is None:
        msg = "Dynamic int8 quantization not yet implemented"
        raise NotImplementedError(msg)
    return static_scaled_int8_quant(input_tensor, scale), scale
