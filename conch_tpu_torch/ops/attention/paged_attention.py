# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Paged decode attention public op (counterpart of ``conch_tpu/ops/attention/paged_attention.py``)."""

from __future__ import annotations

import math

import torch

from conch_tpu_torch.kernels.attention.paged_attention import paged_attention_launcher
from conch_tpu_torch.ops.kv_quant import check_kv_cache_dtype, scale_value


def resolve_kv_caches(kv_cache_dtype: str, key_cache: torch.Tensor, value_cache: torch.Tensor) -> tuple:
    """The caches as the kernels read them, as the JAX ops resolve
    ``kv_cache_dtype``: ``"auto"`` reads any cache dtype; ``"int8"`` needs
    int8 caches; ``"fp8"``/``"fp8_e4m3"`` float8_e4m3fn ones, uint8 caches
    being viewed as float8_e4m3fn. An unknown or mismatched string raises
    ValueError. The scales apply whatever the string."""
    if kv_cache_dtype in ("fp8", "fp8_e4m3") and key_cache.dtype == torch.uint8:
        key_cache, value_cache = key_cache.view(torch.float8_e4m3fn), value_cache.view(torch.float8_e4m3fn)
    if kv_cache_dtype != "auto":
        check_kv_cache_dtype(kv_cache_dtype, key_cache.dtype)
    return key_cache, value_cache


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
        kv_cache_dtype: "auto", "int8", "fp8" or "fp8_e4m3" (uint8 caches
            are viewed as float8_e4m3fn); see ``resolve_kv_caches``.
        k_scale/v_scale: dequantization scales (one element; None = 1),
            applied for every ``kv_cache_dtype``: ``k_scale`` multiplies the
            softmax scale, ``v_scale`` the f32 output.
        window_size: > 0 limits each sequence to its last ``window_size``
            cached tokens (Gemma-2's local layers, Mistral's every layer).
        ring_pages: > 0 (rolling KV): each block-table row's first
            ``ring_pages`` entries form a ring holding position ``p`` at
            slot ``p % (ring_pages * page_size)``; needs ``window_size > 0``
            (ValueError otherwise) and a ring covering the window.
        layer_idx: the layer of a stacked (L, ...) cache pool.

    Returns:
        (batch, num_q_heads, head_size) in the query's dtype.
    """
    key_cache, value_cache = resolve_kv_caches(kv_cache_dtype, key_cache, value_cache)
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
        query, key_caches, value_caches, block_table, seq_lens, scale, layer, float(softcap), int(window_size),
        scale_value(k_scale), scale_value(v_scale), int(ring_pages),
    )
