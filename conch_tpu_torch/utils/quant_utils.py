# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Groupwise weight quantization and the int4 "magic" packing, in torch.

Counterpart of ``conch_tpu/utils/quant_utils.py`` (``quantize_weights``,
``pack_rows_magic``, ``unpack_rows_magic``). These run on any device, so
``init_llama_params`` can quantize an 8B model on the card without passing
it through the host. They compute in float64 and round half to even, as
numpy does, so codes, scales and packed words are bit for bit those of
the numpy originals from the same float32 weight.
"""

from __future__ import annotations

import torch

from conch_tpu_torch.types.scalar_type import ScalarType

_WORD = 1 << 32


def quantize_weights(
    w: torch.Tensor, quant_type: ScalarType, group_size: int | None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Symmetric groupwise quantization of a (K, N) float weight.

    Returns ``(w_ref, w_q, w_s)``: the dequantized weight in w's dtype, the
    int64 codes with the type's bias added, and the (K // group_size, N)
    scales in w's dtype. A group whose values are all zero (pack-time N
    padding) gets scale 0 and is quantized with scale 1, so no 0/0 occurs.
    """
    orig_dtype = w.dtype
    size_k, size_n = w.shape
    if group_size is None or group_size == -1:
        group_size = size_k
    if size_k % group_size:
        msg = f"K={size_k} is not a multiple of group_size={group_size}"
        raise ValueError(msg)
    w = w.to(torch.float64)
    wg = w.reshape(size_k // group_size, group_size, size_n)
    max_q, min_q = float(quant_type.max()), float(quant_type.min())
    w_s = (wg.amax(dim=1) / max_q).abs()
    if min_q != 0:
        w_s = torch.maximum(w_s, (wg.amin(dim=1) / min_q).abs())
    s_full = w_s.repeat_interleave(group_size, dim=0)
    s_safe = torch.where(s_full == 0.0, torch.ones_like(s_full), s_full)
    w_q = torch.round(w / s_safe).clamp(min_q, max_q)
    w_ref = (w_q * s_full).to(orig_dtype)
    return w_ref, w_q.to(torch.int64) + quant_type.bias, w_s.to(orig_dtype)


def pack_rows_magic(q_w: torch.Tensor, group_size: int) -> torch.Tensor:
    """Pack (K, N) 4-bit codes into (K // 8, N) int32 words, magic layout.

    In group ``G``, word row ``r`` (``0 <= r < group_size // 8``) and
    column ``n``, bits ``4j + 16h`` hold logical row
    ``G * group_size + j * group_size // 4 + 2r + h``: each 16-bit half of
    a word holds four codes, and the two halves of field ``j`` are two
    neighbouring rows.
    """
    size_k, size_n = q_w.shape
    if size_k % group_size or group_size % 8:
        msg = f"magic packing needs K % group_size == 0 and group_size % 8 == 0 (K={size_k}, group={group_size})"
        raise ValueError(msg)
    spg = group_size // 4  # logical rows per field slab
    c = (q_w.to(torch.int64) & 0xF).reshape(size_k // group_size, 4, spg // 2, 2, size_n)
    packed = torch.zeros((size_k // group_size, spg // 2, size_n), dtype=torch.int64, device=q_w.device)
    for j in range(4):
        for h in range(2):
            packed |= c[:, j, :, h] << (4 * j + 16 * h)
    packed = torch.where(packed >= _WORD // 2, packed - _WORD, packed)  # uint32 bits as int32
    return packed.reshape(size_k // 8, size_n).to(torch.int32)


def unpack_rows_magic(packed: torch.Tensor, size_k: int, group_size: int) -> torch.Tensor:
    """Inverse of :func:`pack_rows_magic`; returns (K, N) int64 codes 0..15."""
    spg = group_size // 4
    p = (packed.to(torch.int64) & (_WORD - 1)).reshape(size_k // group_size, spg // 2, -1)
    out = torch.empty((size_k // group_size, 4, spg // 2, 2, p.shape[-1]), dtype=torch.int64, device=packed.device)
    for j in range(4):
        for h in range(2):
            out[:, j, :, h] = (p >> (4 * j + 16 * h)) & 0xF
    return out.reshape(size_k, p.shape[-1])
