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
tokens whose slot is negative.
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


def reshape_and_cache_launcher(
    key: torch.Tensor,  # (T, KH, D)
    value: torch.Tensor,
    key_cache: torch.Tensor,  # (P, KH, ps, D), updated in place
    value_cache: torch.Tensor,
    slot_mapping: torch.Tensor,  # (T,), negative = skip
) -> None:
    """Write token t to ``cache[slot // ps, :, slot % ps, :]`` in place."""
    page_size = key_cache.shape[2]
    rows = torch.nonzero(slot_mapping >= 0).squeeze(1)
    slots = slot_mapping[rows].long()
    pages, entries = slots // page_size, slots % page_size
    key_cache[pages, :, entries] = key[rows].to(key_cache.dtype)
    value_cache[pages, :, entries] = value[rows].to(value_cache.dtype)


def reshape_and_cache_stacked_plain(
    key: torch.Tensor,
    value: torch.Tensor,
    key_caches: torch.Tensor,  # (L, P, KH, ps, D), updated in place
    value_caches: torch.Tensor,
    slot_mapping: torch.Tensor,
    layer_idx: int,
) -> None:
    """Plain PyTorch version of K2, on any device."""
    reshape_and_cache_launcher(key, value, key_caches[layer_idx], value_caches[layer_idx], slot_mapping)


def _stacked_write_cuda(key, value, key_caches, value_caches, slot_mapping, layer_idx: int) -> None:
    require_cuda(key, value, key_caches, value_caches, slot_mapping)
    num_layers, num_pages, num_kv_heads, page_size, head_size = key_caches.shape
    if key.dtype != key_caches.dtype or value.dtype != key_caches.dtype or value_caches.dtype != key_caches.dtype:
        msg = (
            f"reshape_and_cache_stacked kernel: bf16/f32 caches store their own dtype, got k {key.dtype}, "
            f"v {value.dtype}, caches {key_caches.dtype}; quantized caches are not ported yet"
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
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ))
    layer_offset = layer_idx * num_pages * num_kv_heads * page_size * head_size
    code = fn(
        key.data_ptr(), value.data_ptr(), key_caches.data_ptr(), value_caches.data_ptr(),
        slot_mapping.data_ptr(), key.shape[0], key.stride(0), value.stride(0), layer_offset,
        num_kv_heads, page_size, head_size, dtype_code(key_caches), stream_of(key),
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
) -> None:
    """In-place write of each token into layer ``layer_idx`` of the pool.

    ``launches`` counts kernel launches.
    """
    if not 0 <= layer_idx < key_caches.shape[0]:
        msg = f"layer_idx {layer_idx} outside the {key_caches.shape[0]}-layer pool"
        raise IndexError(msg)
    if key.device.type == "cpu":
        reshape_and_cache_stacked_plain(key, value, key_caches, value_caches, slot_mapping, layer_idx)
        return
    _stacked_write_cuda(key, value, key_caches, value_caches, slot_mapping, layer_idx)


reshape_and_cache_stacked_launcher.launches = 0
