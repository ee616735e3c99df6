# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""SiLU-and-mul (SwiGLU gate): the CUDA kernel (K6) and its plain versions.

The kernel is ``csrc/silu_and_mul.cu``; it replaces
``conch_tpu/kernels/activation/silu_and_mul.py:_silu_and_mul_kernel`` in
both of its call forms:

- ``silu_and_mul_launcher``: the fused halves of a (T, 2d) ``[gate|up]``
  input, read in place (no slice copies), as ``_fused_halves_launcher``;
- ``silu_and_mul_parts_launcher``: separate (T, d) gate and up.

silu is computed in f32 and rounded to the dtype before the multiply by
up. Each launcher takes its plain version for CPU tensors only; on CUDA it
launches the kernel or raises, and counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from conch_tpu_torch.kernels.common import check_launch, check_rows, dtype_code, kernel_function, stream_of


def silu_and_mul_parts_plain(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K6 on separate halves, on any device."""
    gf = gate.float()
    return (gf * torch.sigmoid(gf)).to(gate.dtype) * up


def silu_and_mul_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K6 on fused ``[gate|up]`` halves."""
    d = x.shape[-1] // 2
    return silu_and_mul_parts_plain(x[..., :d], x[..., d:])


def silu_and_mul_launcher(x: torch.Tensor) -> torch.Tensor:
    """SwiGLU over a 2D (T, 2d) input; returns (T, d)."""
    if x.device.type == "cpu":
        return silu_and_mul_plain(x)
    check_rows("silu_and_mul", x)
    rows, two_d = x.shape
    if two_d % 2:
        msg = f"silu_and_mul kernel: the last axis ({two_d}) must be even"
        raise ValueError(msg)
    out = torch.empty((rows, two_d // 2), dtype=x.dtype, device=x.device)
    fn = kernel_function("conch_silu_and_mul", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ))
    code = fn(x.data_ptr(), out.data_ptr(), rows, two_d // 2, x.stride(0), dtype_code(x), stream_of(x))
    check_launch("conch_silu_and_mul", code)
    silu_and_mul_launcher.launches += 1
    return out


def silu_and_mul_parts_launcher(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """SwiGLU on separate 2D (T, d) gate and up; returns (T, d)."""
    if gate.shape != up.shape:
        msg = f"gate {tuple(gate.shape)} and up {tuple(up.shape)} must have one shape"
        raise ValueError(msg)
    if gate.device.type == "cpu":
        return silu_and_mul_parts_plain(gate, up)
    check_rows("silu_and_mul_parts", gate, up)
    rows, d = gate.shape
    out = torch.empty((rows, d), dtype=gate.dtype, device=gate.device)
    fn = kernel_function("conch_silu_and_mul_parts", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ))
    code = fn(
        gate.data_ptr(), up.data_ptr(), out.data_ptr(), rows, d, gate.stride(0), up.stride(0), dtype_code(gate),
        stream_of(gate),
    )
    check_launch("conch_silu_and_mul_parts", code)
    silu_and_mul_parts_launcher.launches += 1
    return out


silu_and_mul_launcher.launches = 0
silu_and_mul_parts_launcher.launches = 0
