# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""reshape_and_cache public ops (counterpart of ``conch_tpu/ops/cache/reshape_and_cache.py``).

The caches are updated in place, and returned so call sites read like the
JAX package's (which donates them and returns the new buffers).
``kv_cache_dtype`` takes the JAX set: ``"auto"`` stores the caches' own
dtype; ``"int8"``, ``"fp8"`` and ``"fp8_e4m3"`` quantize on store into
int8 / float8_e4m3fn caches with ``k_scale`` / ``v_scale`` (None means 1).
An unknown string, or one that does not name the caches' dtype, raises
ValueError (``ops/kv_quant.py``).
"""

from __future__ import annotations

import torch

from conch_tpu_torch.kernels.cache.reshape_and_cache import (
    reshape_and_cache_launcher,
    reshape_and_cache_stacked_launcher,
)
from conch_tpu_torch.ops.kv_quant import SCALED_KV_DTYPES, check_kv_cache_dtype, scale_value


def _validate_sizes_strict(key, value, key_cache, value_cache, slot_mapping) -> None:
    """The JAX op's ``strict`` checks, with its messages."""
    if key.shape != value.shape:
        msg = f"key.shape ({tuple(key.shape)}) does not match value.shape ({tuple(value.shape)})"
        raise ValueError(msg)
    if key.dim() != 3:
        msg = f"Number of dimensions in key ({key.dim()}) did not match expected (3)"
        raise ValueError(msg)
    if key_cache.shape != value_cache.shape:
        msg = f"key_cache.shape ({tuple(key_cache.shape)}) does not match value_cache.shape ({tuple(value_cache.shape)})"
        raise ValueError(msg)
    if key_cache.dim() != 4:
        msg = f"Number of dimensions in key cache ({key_cache.dim()}) did not match expected (4)"
        raise ValueError(msg)
    _, num_kv_heads, head_size = key.shape
    _, num_kv_heads_c, _, head_size_c = key_cache.shape
    if num_kv_heads != num_kv_heads_c:
        msg = f"Number of kv heads in key/value ({num_kv_heads}) does not match cache ({num_kv_heads_c})"
        raise ValueError(msg)
    if head_size != head_size_c:
        msg = f"Head size in key/value ({head_size}) does not match cache ({head_size_c})"
        raise ValueError(msg)
    if slot_mapping.dim() != 1:
        msg = f"Number of dimensions in slot mapping ({slot_mapping.dim()}) did not match expected (1)"
        raise ValueError(msg)


def _validate_sizes(key, value, key_cache, value_cache, slot_mapping) -> None:
    if key.shape != value.shape or key.dim() != 3:
        msg = f"key {tuple(key.shape)} and value {tuple(value.shape)} must be equal (T, KH, D)"
        raise ValueError(msg)
    if key_cache.shape != value_cache.shape:
        msg = f"key_cache {tuple(key_cache.shape)} does not match value_cache {tuple(value_cache.shape)}"
        raise ValueError(msg)
    if key_cache.shape[-3] != key.shape[1] or key_cache.shape[-1] != key.shape[2]:
        msg = f"key (T, KH, D) = {tuple(key.shape)} does not fit cache {tuple(key_cache.shape)}"
        raise ValueError(msg)
    if slot_mapping.dim() != 1 or slot_mapping.shape[0] != key.shape[0]:
        msg = f"slot_mapping {tuple(slot_mapping.shape)} must be ({key.shape[0]},)"
        raise ValueError(msg)


def reshape_and_cache(
    key: torch.Tensor,
    value: torch.Tensor,
    key_cache: torch.Tensor,
    value_cache: torch.Tensor,
    slot_mapping: torch.Tensor,
    kv_cache_dtype: str = "auto",
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    strict: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write key/value (T, KH, D) into (P, KH, ps, D) caches at the mapped
    slots, in place; negative slots are skipped. ``strict`` runs the JAX
    op's checks first, with its messages."""
    if strict:
        _validate_sizes_strict(key, value, key_cache, value_cache, slot_mapping)
        if kv_cache_dtype != "auto" and kv_cache_dtype not in SCALED_KV_DTYPES:
            msg = f"Unsupported kv_cache_dtype: '{kv_cache_dtype}'"
            raise ValueError(msg)
    check_kv_cache_dtype(kv_cache_dtype, key_cache.dtype)
    _validate_sizes(key, value, key_cache, value_cache, slot_mapping)
    reshape_and_cache_launcher(
        key, value, key_cache, value_cache, slot_mapping, scale_value(k_scale), scale_value(v_scale)
    )
    return key_cache, value_cache


def reshape_and_cache_stacked(
    key: torch.Tensor,
    value: torch.Tensor,
    key_caches: torch.Tensor,
    value_caches: torch.Tensor,
    slot_mapping: torch.Tensor,
    layer_idx: int,
    kv_cache_dtype: str = "auto",
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write key/value into layer ``layer_idx`` of the stacked
    (L, P, KH, ps, D) caches, in place (K2 on CUDA)."""
    check_kv_cache_dtype(kv_cache_dtype, key_caches.dtype)
    _validate_sizes(key, value, key_caches, value_caches, slot_mapping)
    reshape_and_cache_stacked_launcher(
        key, value, key_caches, value_caches, slot_mapping, int(layer_idx), scale_value(k_scale), scale_value(v_scale)
    )
    return key_caches, value_caches
