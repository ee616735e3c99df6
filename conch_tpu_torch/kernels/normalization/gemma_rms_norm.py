# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Gemma RMS norm: the CUDA kernel (K10a) and its plain version.

The kernel is ``csrc/gemma_rms_norm.cu``; it replaces
``conch_tpu/kernels/normalization/gemma_rms_norm.py:_gemma_rms_norm_kernel``.
Both keep ``x * rsqrt(mean(x^2) + eps) * (1 + w)`` in f32 and cast once.
The weight is first cast to x's dtype, as the JAX launcher does.
``gemma_rms_norm_launcher`` takes the plain version for CPU tensors only;
on CUDA it launches the kernel, at any row count and hidden size, or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from conch_tpu_torch.kernels.common import check_launch, dtype_code, kernel_function, require_cuda, stream_of
from conch_tpu_torch.reference.normalization.gemma_rms_norm import gemma_rms_norm as _reference


def gemma_rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, epsilon: float) -> torch.Tensor:
    """Plain PyTorch version of K10a, on any device."""
    return _reference(x, weight.to(x.dtype), epsilon)


def _gemma_rms_norm_cuda(x: torch.Tensor, weight: torch.Tensor, epsilon: float) -> torch.Tensor:
    weight = weight.to(x.dtype).contiguous()
    require_cuda(x, weight)
    rows, hidden = x.shape
    if x.stride(1) != 1 or weight.shape != (hidden,):
        msg = f"gemma_rms_norm kernel: x rows must be contiguous and the weight ({hidden},), got {tuple(weight.shape)}"
        raise ValueError(msg)
    out = torch.empty((rows, hidden), dtype=x.dtype, device=x.device)
    fn = kernel_function("conch_gemma_rms_norm", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ))
    code = fn(
        x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, hidden, x.stride(0), epsilon, dtype_code(x),
        stream_of(x),
    )
    check_launch("conch_gemma_rms_norm", code)
    gemma_rms_norm_launcher.launches += 1
    return out


def gemma_rms_norm_launcher(x: torch.Tensor, weight: torch.Tensor, epsilon: float) -> torch.Tensor:
    """Gemma RMS norm over the last axis of a 2D (rows, hidden) input.

    ``launches`` counts kernel launches.
    """
    if x.device.type == "cpu":
        return gemma_rms_norm_plain(x, weight, epsilon)
    return _gemma_rms_norm_cuda(x, weight, epsilon)


gemma_rms_norm_launcher.launches = 0
