# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""GeLU-tanh-and-mul (GeGLU gate): the CUDA kernel (K10b) and its plain versions.

The kernel is ``csrc/gelu_tanh_and_mul.cu``; it replaces
``conch_tpu/kernels/activation/gelu_tanh_and_mul.py:_gelu_tanh_and_mul_kernel``
in both of its call forms:

- ``gelu_tanh_and_mul_launcher``: the fused halves of a (T, 2d)
  ``[gate|up]`` input, read in place (no slice copies);
- ``gelu_tanh_and_mul_parts_launcher``: separate (T, d) gate and up.

The gate ``g * sigmoid(2 beta (g + kappa g^3))`` is computed in f32 and
rounded to the dtype before the multiply by up. Each launcher takes its
plain version for CPU tensors only; on CUDA it launches the kernel or
raises, and counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from conch_tpu_torch.kernels.common import check_launch, check_rows, dtype_code, kernel_function, stream_of
from conch_tpu_torch.reference.activation.gelu_tanh_and_mul import (
    gelu_tanh_and_mul as gelu_tanh_and_mul_plain,
    gelu_tanh_and_mul_parts as gelu_tanh_and_mul_parts_plain,
)

__all__ = [
    "gelu_tanh_and_mul_launcher",
    "gelu_tanh_and_mul_parts_launcher",
    "gelu_tanh_and_mul_parts_plain",
    "gelu_tanh_and_mul_plain",
]


def gelu_tanh_and_mul_launcher(x: torch.Tensor) -> torch.Tensor:
    """GeGLU over a 2D (T, 2d) input; returns (T, d)."""
    if x.device.type == "cpu":
        return gelu_tanh_and_mul_plain(x)
    check_rows("gelu_tanh_and_mul", x)
    rows, two_d = x.shape
    if two_d % 2:
        msg = f"gelu_tanh_and_mul kernel: the last axis ({two_d}) must be even"
        raise ValueError(msg)
    out = torch.empty((rows, two_d // 2), dtype=x.dtype, device=x.device)
    fn = kernel_function("conch_gelu_tanh_and_mul", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ))
    code = fn(x.data_ptr(), out.data_ptr(), rows, two_d // 2, x.stride(0), dtype_code(x), stream_of(x))
    check_launch("conch_gelu_tanh_and_mul", code)
    gelu_tanh_and_mul_launcher.launches += 1
    return out


def gelu_tanh_and_mul_parts_launcher(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """GeGLU on separate 2D (T, d) gate and up; returns (T, d)."""
    if gate.shape != up.shape:
        msg = f"gate {tuple(gate.shape)} and up {tuple(up.shape)} must have one shape"
        raise ValueError(msg)
    if gate.device.type == "cpu":
        return gelu_tanh_and_mul_parts_plain(gate, up)
    check_rows("gelu_tanh_and_mul_parts", gate, up)
    rows, d = gate.shape
    out = torch.empty((rows, d), dtype=gate.dtype, device=gate.device)
    fn = kernel_function("conch_gelu_tanh_and_mul_parts", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ))
    code = fn(
        gate.data_ptr(), up.data_ptr(), out.data_ptr(), rows, d, gate.stride(0), up.stride(0), dtype_code(gate),
        stream_of(gate),
    )
    check_launch("conch_gelu_tanh_and_mul_parts", code)
    gelu_tanh_and_mul_parts_launcher.launches += 1
    return out


gelu_tanh_and_mul_launcher.launches = 0
gelu_tanh_and_mul_parts_launcher.launches = 0
