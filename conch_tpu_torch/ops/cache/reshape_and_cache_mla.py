# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""MLA latent-cache token insertion (counterpart of
``conch_tpu/ops/cache/reshape_and_cache_mla.py``, vLLM
``concat_and_cache_mla``): one packed ``[c_kv | k_pe | pad]`` row per token
into the unified (num_pages, page_size, packed) cache.

The JAX package writes these rows with an XLA scatter outside any Pallas
kernel (``reshape_and_cache_mla_launcher``), so the port's write is plain
PyTorch too: one indexed assignment, in place.
"""

from __future__ import annotations

import torch


def reshape_and_cache_mla(
    kv: torch.Tensor,
    kv_cache: torch.Tensor,
    slot_mapping: torch.Tensor,
    scale: float | None = None,
) -> torch.Tensor:
    """Insert packed MLA rows in place; negative slots are dropped (padding).

    Args:
        kv: (num_tokens, packed) latent rows.
        kv_cache: (num_pages, page_size, packed), updated in place.
        slot_mapping: (num_tokens,) int32.
        scale: quantize-on-store scale for int8/fp8 caches
            (stored = round(x/scale), saturating); None stores as-is.

    Returns:
        The cache (the argument, updated).
    """
    if kv.dim() != 2 or kv_cache.dim() != 3 or kv.shape[-1] != kv_cache.shape[-1]:
        msg = f"shape mismatch: kv {tuple(kv.shape)} vs cache {tuple(kv_cache.shape)}"
        raise ValueError(msg)
    if slot_mapping.shape[0] != kv.shape[0]:
        msg = f"slot_mapping covers {slot_mapping.shape[0]} tokens, kv has {kv.shape[0]}"
        raise ValueError(msg)
    if kv.shape[0] == 0:
        return kv_cache
    if scale is not None:
        scaled = kv.float() * (1.0 / scale)
        if kv_cache.dtype.is_floating_point:
            # fp8 e4m3 has no inf: an unclamped overflow casts to NaN. Saturate.
            fmax = torch.finfo(kv_cache.dtype).max
            kv = scaled.clamp(-fmax, fmax)
        else:
            info = torch.iinfo(kv_cache.dtype)
            kv = torch.round(scaled).clamp(info.min, info.max)
    rows = kv_cache.view(-1, kv_cache.shape[-1])
    # A dropped row is written to the slot of the first kept row with that
    # row's own value, so the write needs no host sync to filter the rows
    # and duplicate indices always carry one value. With no kept row at all
    # every write puts back the current value of slot 0.
    keep = slot_mapping >= 0
    src = torch.where(keep, torch.arange(kv.shape[0], device=kv.device), torch.argmax(keep.to(torch.int8)))
    dst = slot_mapping[src].long().clamp(min=0)
    values = torch.where(keep[src][:, None], kv[src].to(kv_cache.dtype), rows[dst])
    rows[dst] = values
    return kv_cache
