# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""The ``kv_cache_dtype`` strings and dequantization scales of the KV-cache
ops, as ``conch_tpu/ops/cache/reshape_and_cache.py`` and
``conch_tpu/ops/attention/*`` read them.

``"auto"`` stores K/V in the cache's own dtype; ``"int8"``, ``"fp8"`` and
``"fp8_e4m3"`` quantize on store with a static per-tensor scale (stored =
x * (1 / scale), rounded and clipped) and dequantize in attention by
folding the scales into the attention scalars. A scale is a one-element
tensor, a Python number, or None, which means 1.
"""

from __future__ import annotations

import torch

from conch_tpu_torch.kernels.common import QUANTIZED_CACHE_DTYPES

# kv_cache_dtype string -> the cache element type it names.
SCALED_KV_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn, "fp8_e4m3": torch.float8_e4m3fn}


def scale_value(scale: torch.Tensor | float | None) -> float:
    """A scale as an f32 value (None: 1). A tensor must hold one element;
    reading one that lies on the card waits for it."""
    if scale is None:
        return 1.0
    if isinstance(scale, torch.Tensor):
        if scale.numel() != 1:
            msg = f"a KV-cache scale holds one element, got shape {tuple(scale.shape)}"
            raise ValueError(msg)
        return scale.reshape(()).float().item()
    return float(torch.tensor(scale, dtype=torch.float32))


def check_kv_cache_dtype(kv_cache_dtype: str, cache_dtype: torch.dtype) -> None:
    """Raise ValueError for an unknown string, or one that does not name the
    caches' dtype: ``"int8"`` needs int8 caches, ``"fp8"``/``"fp8_e4m3"``
    float8_e4m3fn ones, and ``"auto"`` caches that are not quantized."""
    if kv_cache_dtype == "auto":
        if cache_dtype in QUANTIZED_CACHE_DTYPES or cache_dtype == torch.uint8:
            msg = f"kv_cache_dtype 'auto' stores the caches' own dtype, got {cache_dtype} caches: name 'int8' or 'fp8'"
            raise ValueError(msg)
        return
    want = SCALED_KV_DTYPES.get(kv_cache_dtype)
    if want is None:
        msg = f"Unsupported kv_cache_dtype: '{kv_cache_dtype}'"
        raise ValueError(msg)
    if cache_dtype != want:
        msg = f"kv_cache_dtype {kv_cache_dtype!r} needs {want} caches, got {cache_dtype}"
        raise ValueError(msg)
