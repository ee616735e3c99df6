# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Paged decode attention public op (counterpart of ``conch_tpu/ops/attention/paged_attention.py``)."""

from __future__ import annotations

import math

import torch

from conch_tpu_torch.kernels.attention.paged_attention import paged_attention_launcher


def check_unported_options(kv_cache_dtype: str, ring_pages: int) -> None:
    """Raise for attention options that later slices port."""
    if kv_cache_dtype != "auto":
        msg = f"kv_cache_dtype {kv_cache_dtype!r}: int8/fp8 caches are not ported yet"
        raise NotImplementedError(msg)
    if ring_pages != 0:
        msg = "ring pages (rolling KV) are not ported yet"
        raise NotImplementedError(msg)


def stacked_view(key_cache: torch.Tensor, value_cache: torch.Tensor, layer_idx) -> tuple:
    """(L, P, KH, ps, D) views of the caches and the layer to read."""
    if layer_idx is None:
        if key_cache.dim() != 4:
            msg = "a stacked (L, P, KH, ps, D) cache needs layer_idx"
            raise ValueError(msg)
        return key_cache[None], value_cache[None], 0
    if key_cache.dim() != 5:
        msg = "layer_idx needs a stacked (L, P, KH, ps, D) cache"
        raise ValueError(msg)
    return key_cache, value_cache, int(layer_idx)


def paged_attention(
    query: torch.Tensor,
    key_cache: torch.Tensor,
    value_cache: torch.Tensor,
    block_table: torch.Tensor,
    seq_lens: torch.Tensor,
    scale: float | None = None,
    softcap: float = 0.0,
    kv_cache_dtype: str = "auto",
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    window_size: int = 0,
    ring_pages: int = 0,
    layer_idx: int | None = None,
) -> torch.Tensor:
    """Decode-only paged attention.

    Args:
        query: (batch, num_q_heads, head_size), one token per sequence.
        key_cache/value_cache: (num_pages, num_kv_heads, page_size, head_size),
            or the stacked (L, ...) pool with ``layer_idx``.
        block_table: (batch, max_pages_per_seq) int32 physical page ids.
        seq_lens: (batch,) int32 lengths; 0 marks an idle row (zeros out).
        scale: softmax scale; defaults to 1/sqrt(head_size).
        softcap: > 0 caps each scaled logit s at ``softcap * tanh(s / softcap)``.
        window_size: > 0 limits each sequence to its last ``window_size``
            cached tokens (Gemma-2's local layers).

    Returns:
        (batch, num_q_heads, head_size) in the query's dtype.
    """
    check_unported_options(kv_cache_dtype, ring_pages)
    key_caches, value_caches, layer = stacked_view(key_cache, value_cache, layer_idx)
    if query.dim() != 3 or key_caches.shape != value_caches.shape:
        msg = f"query {tuple(query.shape)} must be (B, QH, D) and the caches equal"
        raise ValueError(msg)
    if key_caches.shape[-1] != query.shape[-1] or query.shape[1] % key_caches.shape[2]:
        msg = f"query {tuple(query.shape)} does not fit caches {tuple(key_caches.shape)}"
        raise ValueError(msg)
    if block_table.shape[0] != query.shape[0] or seq_lens.shape != (query.shape[0],):
        msg = "block_table and seq_lens must have one row per query"
        raise ValueError(msg)
    if scale is None:
        scale = 1.0 / math.sqrt(query.shape[-1])
    return paged_attention_launcher(
        query, key_caches, value_caches, block_table, seq_lens, scale, layer, float(softcap), int(window_size)
    )
