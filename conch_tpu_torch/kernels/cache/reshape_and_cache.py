# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Paged KV-cache token insertion.

- ``reshape_and_cache_stacked_launcher``: the CUDA kernel (K2,
  ``csrc/reshape_and_cache.cu``) that replaces
  ``conch_tpu/kernels/cache/reshape_and_cache.py:_stacked_write_kernel``,
  writing decode tokens into one layer of the stacked (L, P, KH, ps, D)
  pool in place. It takes its plain version for CPU tensors only.
- ``reshape_and_cache_launcher``: the per-layer write of prefill. The JAX
  package does it with an XLA scatter, not a Pallas kernel, so here it is
  plain PyTorch indexing on every device.

Both update the caches in place (the JAX package donates them) and skip
tokens whose slot is negative. Into int8 or float8_e4m3fn caches both
store what ``conch_tpu/kernels/cache/reshape_and_cache.py:_quantize_store``
stores (``quantize_store``): x times the f32 reciprocal of the scale, then
int8: round half to even and clip to [-128, 127]; e4m3: clip to +-448 and
round to nearest even. K2 fuses that into its copy.

``cache_write_plan`` sets K2's launch from shapes alone: its path (16-byte
vectors only where every row start is 16-byte aligned, else scalars), the
threads of a (token, head) row of K or V and the rows of a block, so that a
decode step spreads over the card's SMs.
``reshape_and_cache_stacked_launcher.pdl`` (default True) launches K2 as a
programmatic dependent of the kernel before it (K5 on every served decode
step).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from conch_tpu_torch.kernels.common import (
    FLOAT_DTYPES,
    QUANTIZED_CACHE_DTYPES,
    aligned16,
    cdiv,
    check_kv_dtypes,
    check_launch,
    dtype_code,
    kernel_function,
    next_power_of_2,
    require_cuda,
    storage_code,
    stream_of,
)

FP8_MAX = 448.0  # largest finite float8_e4m3fn

VECTOR, SCALAR = 0, 1  # K2's paths (csrc/reshape_and_cache.cu: launch's path)
MAX_THREADS = 256  # a block's threads (csrc/reshape_and_cache.cu: kMaxThreads)
ROW_THREADS = 64  # a row's threads at most; wider rows loop
SPREAD_BLOCKS = 132  # one block for each SM of an H100: rows share a block only while a step keeps this many


@dataclasses.dataclass(frozen=True)
class CacheWritePlan:
    """A launch of K2: block (``threads_per_row``, ``rows_per_block``),
    ``grid`` blocks over the ``2 * tokens * KH`` rows (row r: token r // (2
    KH), head r // 2 % KH, V when r is odd). A row is ``head_size // vec``
    chunks of ``vec`` elements; chunk j belongs to the row's thread ``j %
    threads_per_row``, which moves ``items`` of them at most."""

    path: int
    vec: int
    threads_per_row: int
    rows_per_block: int
    items: int
    grid: int


def cache_write_plan(
    num_tokens: int, num_kv_heads: int, head_size: int, itemsize: int, k_row_stride: int, v_row_stride: int,
    aligned: bool,
) -> CacheWritePlan:
    """K2's launch from shapes only. ``itemsize``: the keys' element size;
    ``aligned``: k, v and both caches start on 16-byte boundaries. Vectors
    need that, a head size in whole 16-byte vectors of the keys and, when
    there are tokens after the first, row strides in whole vectors too. A
    row gets a thread a chunk up to ROW_THREADS (a power of two); rows share
    a warp when they are narrower, and a block up to MAX_THREADS threads
    while the step keeps SPREAD_BLOCKS blocks."""
    vec = 16 // itemsize
    strides = num_tokens <= 1 or (k_row_stride % vec == 0 and v_row_stride % vec == 0)
    path = VECTOR if aligned and strides and head_size % vec == 0 else SCALAR
    if path == SCALAR:
        vec = 1
    chunks = head_size // vec
    tpr = min(next_power_of_2(chunks), ROW_THREADS)
    rows = 2 * num_tokens * num_kv_heads
    rpb = max(32 // tpr, 1)
    while tpr * rpb * 2 <= MAX_THREADS and cdiv(rows, rpb * 2) >= SPREAD_BLOCKS:
        rpb *= 2
    return CacheWritePlan(path=path, vec=vec, threads_per_row=tpr, rows_per_block=rpb, items=cdiv(chunks, tpr),
                          grid=cdiv(rows, rpb))


def quantize_store(x: torch.Tensor, scale: float, cache_dtype: torch.dtype) -> torch.Tensor:
    """The value an int8 or float8_e4m3fn cache stores for ``x``."""
    # The f32 reciprocal (numpy's f32 division rounds as the card's does),
    # taken on the host: an f32 value, so the product below stays in f32.
    inv = float(np.float32(1.0) / np.float32(scale))
    scaled = x.float() * inv
    if cache_dtype == torch.int8:
        return torch.round(scaled).clamp(-128.0, 127.0).to(torch.int8)
    return scaled.clamp(-FP8_MAX, FP8_MAX).to(cache_dtype)


def reshape_and_cache_launcher(
    key: torch.Tensor,  # (T, KH, D)
    value: torch.Tensor,
    key_cache: torch.Tensor,  # (P, KH, ps, D), updated in place
    value_cache: torch.Tensor,
    slot_mapping: torch.Tensor,  # (T,), negative = skip
    k_scale: float = 1.0,  # quantization scales, read for int8 / float8_e4m3fn caches
    v_scale: float = 1.0,
) -> None:
    """Write token t to ``cache[slot // ps, :, slot % ps, :]`` in place."""
    page_size = key_cache.shape[2]
    rows = torch.nonzero(slot_mapping >= 0).squeeze(1)
    slots = slot_mapping[rows].long()
    pages, entries = slots // page_size, slots % page_size
    key, value = key[rows], value[rows]
    if key_cache.dtype in QUANTIZED_CACHE_DTYPES:
        key, value = quantize_store(key, k_scale, key_cache.dtype), quantize_store(value, v_scale, value_cache.dtype)
    key_cache[pages, :, entries] = key.to(key_cache.dtype)
    value_cache[pages, :, entries] = value.to(value_cache.dtype)


def reshape_and_cache_stacked_plain(
    key: torch.Tensor,
    value: torch.Tensor,
    key_caches: torch.Tensor,  # (L, P, KH, ps, D), updated in place
    value_caches: torch.Tensor,
    slot_mapping: torch.Tensor,
    layer_idx: int,
    k_scale: float = 1.0,
    v_scale: float = 1.0,
) -> None:
    """Plain PyTorch version of K2, on any device."""
    reshape_and_cache_launcher(
        key, value, key_caches[layer_idx], value_caches[layer_idx], slot_mapping, k_scale, v_scale
    )


def _stacked_write_cuda(key, value, key_caches, value_caches, slot_mapping, layer_idx: int, k_scale, v_scale) -> None:
    require_cuda(key, value, key_caches, value_caches, slot_mapping)
    num_layers, num_pages, num_kv_heads, page_size, head_size = key_caches.shape
    if value.dtype != key.dtype:
        msg = f"reshape_and_cache_stacked kernel: keys and values of one dtype, got {key.dtype}, {value.dtype}"
        raise NotImplementedError(msg)
    check_kv_dtypes("reshape_and_cache_stacked", key, key_caches, value_caches)
    if not (key_caches.is_contiguous() and value_caches.is_contiguous() and slot_mapping.is_contiguous()):
        msg = "reshape_and_cache_stacked kernel: caches and slot_mapping must be contiguous"
        raise ValueError(msg)
    if key.stride(2) != 1 or value.stride(2) != 1 or key.stride(1) != head_size or value.stride(1) != head_size:
        msg = "reshape_and_cache_stacked kernel: each token's (KH, D) row must be contiguous"
        raise ValueError(msg)
    if slot_mapping.dtype != torch.int32:
        msg = "reshape_and_cache_stacked kernel: slot_mapping must be int32"
        raise ValueError(msg)
    num_tokens = key.shape[0]
    plan = cache_write_plan(num_tokens, num_kv_heads, head_size, key.element_size(), key.stride(0), value.stride(0),
                            aligned16(key, value, key_caches, value_caches))
    fn = kernel_function("conch_reshape_and_cache_stacked", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ))
    layer_offset = layer_idx * num_pages * num_kv_heads * page_size * head_size
    code = fn(
        key.data_ptr(), value.data_ptr(), key_caches.data_ptr(), value_caches.data_ptr(),
        slot_mapping.data_ptr(), num_tokens, key.stride(0), value.stride(0), layer_offset,
        num_kv_heads, page_size, head_size, k_scale, v_scale, dtype_code(key, FLOAT_DTYPES), storage_code(key_caches),
        plan.path, plan.threads_per_row, plan.rows_per_block, plan.grid,
        int(reshape_and_cache_stacked_launcher.pdl), stream_of(key),
    )
    check_launch("conch_reshape_and_cache_stacked", code)
    if num_tokens:
        reshape_and_cache_stacked_launcher.launches += 1
        if key.dtype == torch.float16:
            reshape_and_cache_stacked_launcher.f16_launches += 1


def reshape_and_cache_stacked_launcher(
    key: torch.Tensor,  # (T, KH, D)
    value: torch.Tensor,
    key_caches: torch.Tensor,  # (L, P, KH, ps, D), updated in place
    value_caches: torch.Tensor,
    slot_mapping: torch.Tensor,  # (T,) int32, negative = skip
    layer_idx: int,
    k_scale: float = 1.0,  # quantization scales, read for int8 / float8_e4m3fn caches
    v_scale: float = 1.0,
) -> None:
    """In-place write of each token into layer ``layer_idx`` of the pool,
    quantized on store into int8 / float8_e4m3fn caches.

    ``launches`` counts kernel launches (``f16_launches`` those of f16
    keys); ``pdl`` launches the kernel as a programmatic dependent.
    """
    if not 0 <= layer_idx < key_caches.shape[0]:
        msg = f"layer_idx {layer_idx} outside the {key_caches.shape[0]}-layer pool"
        raise IndexError(msg)
    args = (key, value, key_caches, value_caches, slot_mapping, layer_idx, k_scale, v_scale)
    if key.device.type == "cpu":
        reshape_and_cache_stacked_plain(*args)
        return
    _stacked_write_cuda(*args)


reshape_and_cache_stacked_launcher.launches = 0
reshape_and_cache_stacked_launcher.f16_launches = 0  # the launches of f16 keys
reshape_and_cache_stacked_launcher.pdl = True
