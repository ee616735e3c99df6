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
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from conch_tpu_torch.kernels.common import (
    QUANTIZED_CACHE_DTYPES,
    check_launch,
    dtype_code,
    kernel_function,
    require_cuda,
    storage_code,
    stream_of,
)

FP8_MAX = 448.0  # largest finite float8_e4m3fn


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
    cache_ok = key_caches.dtype in (torch.bfloat16, *QUANTIZED_CACHE_DTYPES) or key_caches.dtype == key.dtype
    if key.dtype not in (torch.float32, torch.bfloat16) or value.dtype != key.dtype or not cache_ok or (
        value_caches.dtype != key_caches.dtype
    ):
        msg = (
            f"reshape_and_cache_stacked kernel: f32 or bf16 keys into bf16, int8 or float8_e4m3fn caches (or f32 "
            f"caches for f32 keys), got k {key.dtype}, v {value.dtype}, caches {key_caches.dtype}/"
            f"{value_caches.dtype}"
        )
        raise NotImplementedError(msg)
    if not (key_caches.is_contiguous() and value_caches.is_contiguous() and slot_mapping.is_contiguous()):
        msg = "reshape_and_cache_stacked kernel: caches and slot_mapping must be contiguous"
        raise ValueError(msg)
    if key.stride(2) != 1 or value.stride(2) != 1 or key.stride(1) != head_size or value.stride(1) != head_size:
        msg = "reshape_and_cache_stacked kernel: each token's (KH, D) row must be contiguous"
        raise ValueError(msg)
    if slot_mapping.dtype != torch.int32:
        msg = "reshape_and_cache_stacked kernel: slot_mapping must be int32"
        raise ValueError(msg)
    fn = kernel_function("conch_reshape_and_cache_stacked", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ))
    layer_offset = layer_idx * num_pages * num_kv_heads * page_size * head_size
    code = fn(
        key.data_ptr(), value.data_ptr(), key_caches.data_ptr(), value_caches.data_ptr(),
        slot_mapping.data_ptr(), key.shape[0], key.stride(0), value.stride(0), layer_offset,
        num_kv_heads, page_size, head_size, k_scale, v_scale, dtype_code(key), storage_code(key_caches),
        stream_of(key),
    )
    check_launch("conch_reshape_and_cache_stacked", code)
    reshape_and_cache_stacked_launcher.launches += 1


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

    ``launches`` counts kernel launches.
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
