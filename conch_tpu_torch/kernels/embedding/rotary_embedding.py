# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""NeoX rotary embedding: the CUDA kernel (K5) and its plain version.

The kernel is ``csrc/rotary_embedding.cu``; it replaces
``conch_tpu/kernels/embedding/rotary_embedding.py:_rope_kernel``. Both
rotate in f32 and round once on store. ``rotary_embedding_launcher``
takes the plain version for CPU tensors only; on CUDA it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from conch_tpu_torch.kernels.common import (
    check_launch,
    dtype_code,
    kernel_function,
    require_cuda,
    stream_of,
)


def rotary_embedding_plain(
    positions: torch.Tensor,
    query: torch.Tensor,
    key: torch.Tensor,
    head_size: int,
    cos_sin_cache: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on any device."""
    rot_dim = cos_sin_cache.shape[-1]
    half = rot_dim // 2
    pos = positions.long().clamp(0, cos_sin_cache.shape[0] - 1)
    cos_sin = cos_sin_cache[pos].float()
    cos, sin = cos_sin[:, None, :half], cos_sin[:, None, half:]

    def rotate(x: torch.Tensor) -> torch.Tensor:
        xh = x.reshape(x.shape[0], -1, head_size)
        x1, x2 = xh[..., :half].float(), xh[..., half:rot_dim].float()
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
        return torch.cat([out, xh[..., rot_dim:]], dim=-1).reshape(x.shape[0], -1)

    return rotate(query), rotate(key)


def _rope_cuda(
    positions: torch.Tensor,
    query: torch.Tensor,
    key: torch.Tensor,
    head_size: int,
    cos_sin_cache: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    require_cuda(positions, query, key, cos_sin_cache)
    num_tokens = query.shape[0]
    rot_dim = cos_sin_cache.shape[-1]
    if query.dtype != key.dtype or cos_sin_cache.dtype != torch.float32 or positions.dtype != torch.int32:
        msg = "rotary_embedding kernel: q and k share a dtype, the cache is float32, positions int32"
        raise ValueError(msg)
    if query.stride(1) != 1 or key.stride(1) != 1 or not cos_sin_cache.is_contiguous() or not positions.is_contiguous():
        msg = "rotary_embedding kernel: rows of q and k, the cache and positions must be contiguous"
        raise ValueError(msg)
    if rot_dim % 2 or rot_dim > head_size or query.shape[1] % head_size or key.shape[1] % head_size:
        msg = f"rotary_embedding kernel: bad head_size {head_size} / rot_dim {rot_dim}"
        raise ValueError(msg)
    q_out = torch.empty(query.shape, dtype=query.dtype, device=query.device)
    k_out = torch.empty(key.shape, dtype=key.dtype, device=key.device)
    fn = kernel_function("conch_rotary_embedding", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ))
    code = fn(
        query.data_ptr(), key.data_ptr(), q_out.data_ptr(), k_out.data_ptr(), cos_sin_cache.data_ptr(),
        positions.data_ptr(), num_tokens, query.stride(0), key.stride(0),
        query.shape[1] // head_size, key.shape[1] // head_size, head_size, rot_dim,
        cos_sin_cache.shape[0], dtype_code(query), stream_of(query),
    )
    check_launch("conch_rotary_embedding", code)
    rotary_embedding_launcher.launches += 1
    return q_out, k_out


def rotary_embedding_launcher(
    positions: torch.Tensor,
    query: torch.Tensor,
    key: torch.Tensor,
    head_size: int,
    cos_sin_cache: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotate q (T, QH*D) and k (T, KH*D) by ``positions`` (T,).

    Returns new contiguous (q, k). Row-strided inputs (slices of a fused
    qkv projection) are read in place. ``launches`` counts kernel launches.
    """
    if query.device.type == "cpu":
        return rotary_embedding_plain(positions, query, key, head_size, cos_sin_cache)
    return _rope_cuda(positions, query, key, head_size, cos_sin_cache)


rotary_embedding_launcher.launches = 0
