# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""int4 weight-only GEMM over the magic packing: the CUDA kernel (K1) and
its plain version.

The kernel is ``csrc/mixed_gemm_magic.cu``; it replaces
``conch_tpu/kernels/quantization/gemm.py:_mixed_gemm_magic_kernel``
(launched by ``mixed_precision_gemm_launcher`` with ``layer_index``). For a
per-layer stack of weights, (L, K/8, N) int32 and (L, K/128, N) scales,
the wrapper offsets the pointers to the layer, so no slice of the stack is
ever copied. ``mixed_gemm_magic_launcher`` takes the plain version for CPU
tensors only; on CUDA it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from conch_tpu_torch.kernels.common import check_launch, kernel_function, require_cuda, stream_of
from conch_tpu_torch.utils.quant_utils import unpack_rows_magic

KERNEL_GROUP_SIZE = 128  # the group size the CUDA kernel is written for


def _layer(a: torch.Tensor, layer_index: int | None) -> torch.Tensor:
    if layer_index is None:
        return a
    if not 0 <= layer_index < a.shape[0]:
        msg = f"layer_index {layer_index} outside the {a.shape[0]}-layer stack"
        raise IndexError(msg)
    return a[layer_index]


def dequantize_magic(packed: torch.Tensor, scales: torch.Tensor, k: int, group_size: int, bias: int) -> torch.Tensor:
    """The (K, N) float32 weight ``(code - bias) * scale`` of one layer."""
    codes = unpack_rows_magic(packed, k, group_size)
    return (codes - bias).to(torch.float32) * scales.to(torch.float32).repeat_interleave(group_size, dim=0)


def mixed_gemm_magic_plain(
    x: torch.Tensor,
    packed: torch.Tensor,
    scales: torch.Tensor,
    group_size: int,
    bias: int,
    layer_index: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of K1, on any device: dequantize the layer's
    weight in f32, multiply in f32, round to x's dtype."""
    packed, scales = _layer(packed, layer_index), _layer(scales, layer_index)
    w = dequantize_magic(packed, scales, x.shape[1], group_size, bias)
    return torch.matmul(x.float(), w).to(x.dtype)


def _magic_gemm_cuda(x, packed, scales, group_size: int, bias: int, layer_index: int | None) -> torch.Tensor:
    require_cuda(x, packed, scales)
    m, k = x.shape
    n = packed.shape[-1]
    if x.dtype != torch.bfloat16 or scales.dtype != torch.bfloat16 or packed.dtype != torch.int32:
        msg = (
            f"mixed_gemm_magic kernel: x and scales must be bfloat16 and packed int32, got x {x.dtype}, "
            f"scales {scales.dtype}, packed {packed.dtype}"
        )
        raise NotImplementedError(msg)
    if group_size != KERNEL_GROUP_SIZE or k % KERNEL_GROUP_SIZE or n % 128:
        msg = f"mixed_gemm_magic kernel: needs group_size 128 and K, N multiples of 128 (K={k}, N={n}, group={group_size})"
        raise ValueError(msg)
    if not (packed.is_contiguous() and scales.is_contiguous()):
        msg = "mixed_gemm_magic kernel: packed weights and scales must be contiguous"
        raise ValueError(msg)
    if x.stride(1) != 1 or x.stride(0) % 8 or x.data_ptr() % 16:
        msg = "mixed_gemm_magic kernel: x rows must be contiguous, 16-byte aligned, with a row stride that is a multiple of 8"
        raise ValueError(msg)
    rank = 2 if layer_index is None else 3
    if (packed.dim(), scales.dim()) != (rank, rank) or tuple(packed.shape[-2:]) != (k // 8, n) or tuple(
        scales.shape[-2:]
    ) != (k // group_size, n):
        msg = f"mixed_gemm_magic kernel: packed {tuple(packed.shape)} / scales {tuple(scales.shape)} do not fit x {tuple(x.shape)}"
        raise ValueError(msg)
    w_ptr, s_ptr = packed.data_ptr(), scales.data_ptr()
    if layer_index is not None:
        _layer(packed, layer_index)  # range check
        w_ptr += layer_index * packed.stride(0) * packed.element_size()
        s_ptr += layer_index * scales.stride(0) * scales.element_size()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    fn = kernel_function("conch_mixed_gemm_magic", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ))
    code = fn(x.data_ptr(), w_ptr, s_ptr, out.data_ptr(), m, n, k, x.stride(0), bias, stream_of(x))
    check_launch("conch_mixed_gemm_magic", code)
    mixed_gemm_magic_launcher.launches += 1
    return out


def mixed_gemm_magic_launcher(
    x: torch.Tensor,  # (M, K)
    packed: torch.Tensor,  # (K/8, N) int32, or (L, K/8, N) with layer_index
    scales: torch.Tensor,  # (K/group, N), or (L, K/group, N)
    group_size: int,
    bias: int,
    layer_index: int | None = None,
) -> torch.Tensor:
    """``x @ ((code - bias) * scale)`` in f32, rounded to x's dtype: (M, N).

    ``launches`` counts kernel launches.
    """
    if x.device.type == "cpu":
        return mixed_gemm_magic_plain(x, packed, scales, group_size, bias, layer_index)
    return _magic_gemm_cuda(x, packed, scales, group_size, bias, layer_index)


mixed_gemm_magic_launcher.launches = 0
