# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Static-scale int8 quantization: the CUDA kernel (K9) and its plain version.

The kernel is ``csrc/static_quant.cu`` (shared with the fp8 launcher,
``fp8.py``); it replaces
``conch_tpu/kernels/quantization/int8.py:_static_scaled_int8_quant_kernel``:
``clip(x * (1 / scale), -128, 127)`` truncated to int8, the reciprocal
taken in f32 on the card. ``static_scaled_int8_quant_launcher`` takes the
plain version for CPU tensors only; on CUDA it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from conch_tpu_torch.kernels.common import (
    STORAGE_CODES,
    check_launch,
    kernel_function,
    require_cuda,
    sm_count,
    storage_code,
    stream_of,
)
from conch_tpu_torch.reference.quantization.int8 import scaled_int8_quant as static_scaled_int8_quant_plain

INPUT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def check_static_quant_inputs(x: torch.Tensor, scale: torch.Tensor) -> None:
    """Raise unless ``x`` is (tokens, hidden) f32 / bf16 / f16 and ``scale``
    holds one element."""
    if x.dim() != 2 or x.dtype not in INPUT_DTYPES:
        msg = f"static quantization takes (tokens, hidden) f32, bf16 or f16, got {tuple(x.shape)} {x.dtype}"
        raise ValueError(msg)
    if scale.numel() != 1:
        msg = f"static quantization takes a one-element scale, got shape {tuple(scale.shape)}"
        raise ValueError(msg)


def static_quant_cuda(x: torch.Tensor, scale: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Launch K9 on the card: ``x`` quantized to ``out_dtype`` (int8 or
    float8_e4m3fn). The scale moves to ``x``'s device as one f32."""
    if x.device.type != "cuda":
        msg = f"static quantization kernel: input must lie on a CUDA device, got {x.device}"
        raise ValueError(msg)
    scale = scale.reshape(1).to(device=x.device, dtype=torch.float32)
    require_cuda(x, scale)
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel loads 16 bytes at a time
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    fn = kernel_function("conch_static_scaled_quant", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ))
    code = fn(x.data_ptr(), out.data_ptr(), scale.data_ptr(), x.numel(), storage_code(x), STORAGE_CODES[out_dtype],
              sm_count(x.device.index), stream_of(x))
    check_launch("conch_static_scaled_quant", code)
    return out


def static_scaled_int8_quant_launcher(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize (tokens, hidden) to int8 with a one-element static scale.
    ``launches`` counts kernel launches."""
    check_static_quant_inputs(x, scale)
    if x.device.type == "cpu":
        return static_scaled_int8_quant_plain(x, scale)
    out = static_quant_cuda(x, scale, torch.int8)
    static_scaled_int8_quant_launcher.launches += 1
    return out


static_scaled_int8_quant_launcher.launches = 0
