# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Groupwise weight quantization and the int32 row packings, in torch.

Counterpart of ``conch_tpu/utils/quant_utils.py`` (``quantize_weights``,
``pack_rows`` / ``unpack_rows`` (GPTQ rows), ``pack_rows_planar`` /
``unpack_rows_planar`` and ``pack_rows_magic`` / ``unpack_rows_magic``).
These run on any device, so ``init_llama_params`` can quantize an 8B model
on the card without passing it through the host. They compute in float64
and round half to even, as numpy does, so codes, scales and packed words
are bit for bit those of the numpy originals from the same float32 weight.
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
    # Divisors as 0-dim tensors on w's device: CUDA divides by a Python
    # scalar as a product with its reciprocal, one rounding off numpy's
    # division, which moves codes at rounding ties away from the CPU's.
    max_q, min_q = (wg.new_full((), float(v)) for v in (quant_type.max(), quant_type.min()))
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


def get_pack_factor(num_bits: int) -> int:
    """Codes per int32 word; the row packings take 1, 2, 4 or 8 bits."""
    if num_bits not in (1, 2, 4, 8):
        msg = f"the row packings take 1, 2, 4 or 8-bit codes, got {num_bits}"
        raise ValueError(msg)
    return 32 // num_bits


def _pack_fields(fields: torch.Tensor, num_bits: int) -> torch.Tensor:
    """(W, epp, N) codes -> (W, N) int32 words, field ``i`` in bits
    ``[i*num_bits, (i+1)*num_bits)``; built byte by byte (little-endian),
    so no intermediate wider than the codes is made."""
    w, epp, n = fields.shape
    per_byte = epp // 4
    f = (fields.to(torch.uint8) & ((1 << num_bits) - 1)).reshape(w, 4, per_byte, n)
    octets = f[:, :, 0].clone()
    for j in range(1, per_byte):
        octets |= f[:, :, j] << (num_bits * j)
    return octets.permute(0, 2, 1).contiguous().view(torch.int32).reshape(w, n)


def _unpack_fields(packed: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Inverse of :func:`_pack_fields`: (W, N) int32 -> (W, epp, N) int32 codes."""
    w, n = packed.shape
    per_byte = 8 // num_bits
    octets = packed.contiguous().view(torch.uint8).reshape(w, n, 4).permute(0, 2, 1)  # (W, 4, N)
    mask = (1 << num_bits) - 1
    fields = torch.stack([(octets >> (num_bits * j)) & mask for j in range(per_byte)], dim=2)  # (W, 4, per_byte, N)
    return fields.reshape(w, 4 * per_byte, n).to(torch.int32)


def pack_rows(q_w: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Pack (K, N) codes into (K // pack_factor, N) int32 words, GPTQ rows:
    word ``r`` holds logical row ``r * pack_factor + i`` in bit field ``i``."""
    size_k, size_n = q_w.shape
    epp = get_pack_factor(num_bits)
    if size_k % epp:
        msg = f"K={size_k} is not a multiple of the pack factor {epp}"
        raise ValueError(msg)
    return _pack_fields(q_w.reshape(size_k // epp, epp, size_n), num_bits)


def unpack_rows(packed: torch.Tensor, num_bits: int, size_k: int) -> torch.Tensor:
    """Inverse of :func:`pack_rows`; returns (K, N) int32 codes."""
    return _unpack_fields(packed, num_bits).reshape(size_k, packed.shape[-1])


def pack_rows_planar(q_w: torch.Tensor, num_bits: int, group_size: int) -> torch.Tensor:
    """Pack (K, N) codes planar within each group of ``group_size`` rows:
    word row ``r`` of a group holds the group's row ``i * rpg + r`` in bit
    field ``i`` (``rpg = group_size / pack_factor``)."""
    size_k, size_n = q_w.shape
    epp = get_pack_factor(num_bits)
    if size_k % group_size or group_size % epp:
        msg = f"planar packing needs K % group_size == 0 and group_size % {epp} == 0 (K={size_k}, group={group_size})"
        raise ValueError(msg)
    rpg = group_size // epp
    fields = q_w.reshape(size_k // group_size, epp, rpg, size_n).transpose(1, 2).reshape(-1, epp, size_n)
    return _pack_fields(fields, num_bits)


def unpack_rows_planar(packed: torch.Tensor, num_bits: int, size_k: int, group_size: int) -> torch.Tensor:
    """Inverse of :func:`pack_rows_planar`; returns (K, N) int32 codes."""
    epp = get_pack_factor(num_bits)
    rpg = group_size // epp
    n = packed.shape[-1]
    fields = _unpack_fields(packed, num_bits).reshape(size_k // group_size, rpg, epp, n)
    return fields.transpose(1, 2).reshape(size_k, n)
