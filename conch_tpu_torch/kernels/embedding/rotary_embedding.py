# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""NeoX rotary embedding: the CUDA kernel (K5) and its plain version.

The kernel is ``csrc/rotary_embedding.cu``; it replaces
``conch_tpu/kernels/embedding/rotary_embedding.py:_rope_kernel``. Both
rotate in f32 and round once on store (f16 too, as JAX's launcher upcasts
it). ``rotary_embedding_launcher`` takes the plain version for CPU tensors
only; on CUDA it launches the kernel or raises.

``rope_plan`` sets the kernel's launch from shapes alone: its path (16-byte
vectors only where every address is 16-byte aligned, else scalar), its
block of (chunks or threads of a head, heads of a group) and its grid of
(tokens, head groups), with fewer heads a block while a step has fewer
blocks than the card has SMs. ``rotary_embedding_launcher.pdl`` (default
True) launches the kernel as a programmatic dependent of the kernel before
it.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from conch_tpu_torch.kernels.common import (
    FLOAT_DTYPES,
    aligned16,
    cdiv,
    check_launch,
    dtype_code,
    kernel_function,
    next_power_of_2,
    require_cuda,
    stream_of,
)

VECTOR, SCALAR = 0, 1  # the kernel's paths (csrc/rotary_embedding.cu: rope_kernel's VEC)
MAX_THREADS = 1024  # csrc/rotary_embedding.cu: kMaxThreads
BLOCK_THREADS = 256  # a block's threads when a step has blocks enough (fewer, larger blocks launch faster)
SCALAR_THREADS = 64  # threads of a head on the scalar path
SPREAD_BLOCKS = 132  # a step has at least this many blocks where heads allow: one for each SM of an H100


@dataclasses.dataclass(frozen=True)
class RopePlan:
    """A launch of K5: block (``block[0]`` threads of a head, ``block[1]``
    heads), grid (tokens, head groups). On the vector path thread x of a
    head owns chunk x: ``vec`` consecutive pairs (x < ``rot_dim // 2 //
    vec``) or ``vec`` elements of the tail past rot_dim (the chunks after),
    so ``block[0]`` is the head's chunk count and ``items`` 1. On the scalar
    path (``vec`` 1) thread x walks the head's pairs, then its tail
    elements, from x in steps of ``block[0]``: ``items`` each at most."""

    path: int
    vec: int
    block: tuple[int, int]
    grid: tuple[int, int]
    items: int


def rope_plan(
    num_tokens: int, num_q_heads: int, num_k_heads: int, head_size: int, rot_dim: int, itemsize: int,
    q_row_stride: int, k_row_stride: int, aligned: bool,
) -> RopePlan:
    """K5's launch from shapes only. ``aligned``: q, k, their outputs and the
    cos/sin cache start on 16-byte boundaries. The vector path needs that,
    row strides (when there are rows after the first), ``rot_dim // 2`` and
    the tail past rot_dim in whole 16-byte vectors; else the scalar path.
    A block takes the heads rounded up to a power of two, at most as many
    as keep it within BLOCK_THREADS threads, halved while the step has
    fewer than SPREAD_BLOCKS blocks."""
    vec = 16 // itemsize
    half, tail = rot_dim // 2, head_size - rot_dim
    chunks = half // vec + tail // vec
    strides = num_tokens <= 1 or (q_row_stride % vec == 0 and k_row_stride % vec == 0)
    if aligned and strides and half % vec == 0 and tail % vec == 0 and 0 < chunks <= MAX_THREADS:
        path, vec, bx, items = VECTOR, vec, chunks, 1
    else:
        bx = min(next_power_of_2(half + tail), SCALAR_THREADS)
        path, vec, items = SCALAR, 1, cdiv(half + tail, bx)
    heads = num_q_heads + num_k_heads
    by = 1
    while by < heads and bx * by * 2 <= BLOCK_THREADS:
        by *= 2
    while by > 1 and num_tokens * cdiv(heads, by) < SPREAD_BLOCKS:
        by //= 2
    return RopePlan(path=path, vec=vec, block=(bx, by), grid=(num_tokens, cdiv(heads, by)), items=items)


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
        xh = x.reshape(x.shape[0], x.shape[1] // head_size, head_size)
        x1, x2 = xh[..., :half].float(), xh[..., half:rot_dim].float()
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
        return torch.cat([out, xh[..., rot_dim:]], dim=-1).reshape(x.shape)

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
    if key.shape[0] != num_tokens or positions.shape != (num_tokens,):
        msg = f"rotary_embedding kernel: q, k and positions must have {num_tokens} rows"
        raise ValueError(msg)
    q_out = torch.empty(query.shape, dtype=query.dtype, device=query.device)
    k_out = torch.empty(key.shape, dtype=key.dtype, device=key.device)
    if num_tokens == 0:
        return q_out, k_out
    num_q_heads, num_k_heads = query.shape[1] // head_size, key.shape[1] // head_size
    plan = rope_plan(
        num_tokens, num_q_heads, num_k_heads, head_size, rot_dim, query.element_size(), query.stride(0),
        key.stride(0), aligned16(query, key, q_out, k_out, cos_sin_cache),
    )
    fn = kernel_function("conch_rotary_embedding", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ))
    code = fn(
        query.data_ptr(), key.data_ptr(), q_out.data_ptr(), k_out.data_ptr(), cos_sin_cache.data_ptr(),
        positions.data_ptr(), num_tokens, query.stride(0), key.stride(0), num_q_heads, num_k_heads, head_size,
        rot_dim, cos_sin_cache.shape[0], dtype_code(query, FLOAT_DTYPES), plan.path, *plan.block, plan.grid[1],
        int(rotary_embedding_launcher.pdl), stream_of(query),
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
    qkv projection) are read in place. ``launches`` counts kernel launches;
    ``pdl`` launches the kernel as a programmatic dependent.
    """
    if query.device.type == "cpu":
        return rotary_embedding_plain(positions, query, key, head_size, cos_sin_cache)
    return _rope_cuda(positions, query, key, head_size, cos_sin_cache)


rotary_embedding_launcher.launches = 0
rotary_embedding_launcher.pdl = True
