# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""RMS norm (K4) and fused residual add + RMS norm (K4b): the CUDA kernels
and their plain versions.

Both kernels are in ``csrc/rms_norm.cu``; they replace
``conch_tpu/kernels/normalization/rms_norm.py:_rms_norm_kernel`` and
``_fused_add_rms_norm_kernel``. Both take the squares and the rsqrt in
f32 (the squares summed in f64, the mean rounded once to f32) and round
the normalized value to x's dtype before the weight multiply; K4b first forms ``s = x + r`` rounded to the dtype and
returns ``(norm(s), s)`` as two new tensors. The plain versions are the
golden ones of ``reference/normalization/rms_norm.py``. Each launcher
takes the plain version for CPU tensors only; on CUDA it launches its
kernel, at any row count and hidden size, in f32, bf16 or f16, or raises.

K4 is the register-held row kernel of ``csrc/row_norm.cuh`` (K10a's), on
the plan of ``row_norm.py:row_norm_plan``; ``rms_norm_launcher.pdl``
(default True) launches it as a programmatic dependent of the kernel
before it. K4b keeps a block a row.
"""

from __future__ import annotations

import ctypes

import torch

from conch_tpu_torch.kernels.common import (
    FLOAT_DTYPES,
    check_launch,
    dtype_code,
    kernel_function,
    require_cuda,
    stream_of,
)
from conch_tpu_torch.kernels.normalization.row_norm import launch_row_norm
from conch_tpu_torch.reference.normalization.rms_norm import fused_add_rms_norm as fused_add_rms_norm_plain
from conch_tpu_torch.reference.normalization.rms_norm import rms_norm as rms_norm_plain

__all__ = ["fused_add_rms_norm_launcher", "fused_add_rms_norm_plain", "rms_norm_launcher", "rms_norm_plain"]


def _check_rows(name: str, weight: torch.Tensor, *rows: torch.Tensor) -> None:
    """Raise unless each (rows, hidden) input has contiguous rows, they
    share a shape, and the weight is (hidden,)."""
    hidden = rows[0].shape[1]
    if any(t.stride(1) != 1 or t.shape != rows[0].shape for t in rows) or weight.shape != (hidden,):
        msg = (
            f"{name} kernel: inputs must be (rows, hidden) of one shape with contiguous rows and the weight "
            f"({hidden},), got {[tuple(t.shape) for t in rows]} and {tuple(weight.shape)}"
        )
        raise ValueError(msg)


def _rms_norm_cuda(x: torch.Tensor, weight: torch.Tensor, epsilon: float) -> torch.Tensor:
    out = launch_row_norm("conch_rms_norm", x, weight, epsilon, rms_norm_launcher.pdl)
    if x.shape[0]:
        rms_norm_launcher.launches += 1
    return out


def rms_norm_launcher(x: torch.Tensor, weight: torch.Tensor, epsilon: float) -> torch.Tensor:
    """RMS norm over the last axis of a 2D (rows, hidden) input.

    ``launches`` counts kernel launches; ``pdl`` launches the kernel as a
    programmatic dependent.
    """
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, epsilon)
    return _rms_norm_cuda(x, weight, epsilon)


rms_norm_launcher.launches = 0
rms_norm_launcher.pdl = True


def _fused_add_rms_norm_cuda(
    x: torch.Tensor, residual: torch.Tensor, weight: torch.Tensor, epsilon: float
) -> tuple[torch.Tensor, torch.Tensor]:
    weight = weight.to(x.dtype).contiguous()
    require_cuda(x, residual, weight)
    if residual.dtype != x.dtype:
        msg = f"fused_add_rms_norm kernel: x and residual must share a dtype, got {x.dtype} and {residual.dtype}"
        raise ValueError(msg)
    _check_rows("fused_add_rms_norm", weight, x, residual)
    rows, hidden = x.shape
    out = torch.empty((rows, hidden), dtype=x.dtype, device=x.device)
    res_out = torch.empty((rows, hidden), dtype=x.dtype, device=x.device)
    fn = kernel_function("conch_fused_add_rms_norm", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ))
    code = fn(
        x.data_ptr(), residual.data_ptr(), weight.data_ptr(), out.data_ptr(), res_out.data_ptr(), rows, hidden,
        x.stride(0), residual.stride(0), epsilon, dtype_code(x, FLOAT_DTYPES), stream_of(x),
    )
    check_launch("conch_fused_add_rms_norm", code)
    fused_add_rms_norm_launcher.launches += 1
    return out, res_out


def fused_add_rms_norm_launcher(
    x: torch.Tensor, residual: torch.Tensor, weight: torch.Tensor, epsilon: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Residual add fused with RMS norm over the last axis of 2D (rows,
    hidden) inputs: ``(rms_norm(x + residual), x + residual)``, two new
    tensors (nothing is updated in place).

    ``launches`` counts kernel launches.
    """
    if x.device.type == "cpu":
        return fused_add_rms_norm_plain(x, residual, weight, epsilon)
    return _fused_add_rms_norm_cuda(x, residual, weight, epsilon)


fused_add_rms_norm_launcher.launches = 0
