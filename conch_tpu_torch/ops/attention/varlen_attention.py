# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Varlen attention public op (counterpart of ``conch_tpu/ops/attention/varlen_attention.py``)."""

from __future__ import annotations

import math

import torch

from conch_tpu_torch.kernels.attention.varlen_attention import varlen_attention_launcher
from conch_tpu_torch.ops.attention.paged_attention import resolve_kv_caches, stacked_view
from conch_tpu_torch.ops.kv_quant import scale_value


def _check_size_compatibility(
    query: torch.Tensor,
    key_cache: torch.Tensor,
    value_cache: torch.Tensor,
    cu_seqlens_q: torch.Tensor,
    seq_lens: torch.Tensor,
    block_table: torch.Tensor,
) -> None:
    """The JAX op's ``strict`` checks, with its messages."""
    if query.dim() != 3:
        msg = f"Query tensor has unexpected shape (query.shape = {tuple(query.shape)}), expected 3-D tensor"
        raise ValueError(msg)
    if key_cache.dim() != 4:
        msg = f"key_cache tensor has unexpected shape (key_cache.shape = {tuple(key_cache.shape)}), expected 4-D tensor"
        raise ValueError(msg)
    if key_cache.shape != value_cache.shape:
        msg = (
            "Shape of key_cache and value_cache tensors does not match "
            f"(key_cache.shape = {tuple(key_cache.shape)}, value_cache.shape = {tuple(value_cache.shape)})"
        )
        raise ValueError(msg)
    _, num_query_heads, head_size = query.shape
    _, num_kv_heads, _, head_size_kv = key_cache.shape
    if head_size_kv != head_size:
        msg = f"Head size of key/value cache ({head_size_kv}) does not match query ({head_size})"
        raise ValueError(msg)
    if num_kv_heads > num_query_heads:
        msg = f"Number of key/value heads ({num_kv_heads}) is greater than number of query heads ({num_query_heads})"
        raise ValueError(msg)
    batch_size = cu_seqlens_q.shape[0] - 1
    if block_table.shape[0] != batch_size:
        msg = f"Batch size from block_table tensor ({block_table.shape[0]}) does not match batch_size ({batch_size})"
        raise ValueError(msg)
    if seq_lens.shape[0] != batch_size:
        msg = f"Shape of sequence lengths tensor does not match batch size ({seq_lens.shape[0]} vs {batch_size})"
        raise ValueError(msg)


def varlen_attention(
    query: torch.Tensor,
    key_cache: torch.Tensor,
    value_cache: torch.Tensor,
    cu_seqlens_q: torch.Tensor,
    max_seqlen_q: int,
    seq_lens: torch.Tensor,
    max_seqlen_k: int,
    block_table: torch.Tensor,
    causal: bool = False,
    scale: float | None = None,
    softcap: float = 0.0,
    kv_cache_dtype: str = "auto",
    q_scale: torch.Tensor | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    window_size: int = 0,
    ring_pages: int = 0,
    layer_idx: int | None = None,
    strict: bool = False,
) -> torch.Tensor:
    """Variable-length (prefill) attention over a paged KV cache.

    Args:
        query: (total_num_q, num_q_heads, head_size) ragged queries; rows
            past cu_seqlens_q[-1] are padding (zeros out).
        key_cache/value_cache: (num_pages, num_kv_heads, page_size, head),
            or the stacked (L, ...) pool with ``layer_idx``.
        cu_seqlens_q: (batch+1,) int32 cumulative query counts; trailing
            zero-length sequences are padding.
        max_seqlen_q / max_seqlen_k: informational (kept for the JAX
            signature; the kernel needs no static bound).
        seq_lens: (batch,) int32 KV lengths, the queries included.
        block_table: (batch, max_pages) int32.
        causal: apply causal masking.
        scale: softmax scale; defaults to 1/sqrt(head_size).
        softcap: > 0 caps each scaled logit s at ``softcap * tanh(s / softcap)``.
        kv_cache_dtype: "auto", "int8", "fp8" or "fp8_e4m3", as in
            ``paged_attention``.
        q_scale/k_scale/v_scale: dequantization scales (one element; None
            = 1), applied for every ``kv_cache_dtype``: ``q_scale * k_scale``
            multiplies the softmax scale, ``v_scale`` the f32 output.
        window_size: > 0: the query at position p sees keys from
            ``p - window_size + 1`` on (Gemma-2's local layers).
        ring_pages: > 0 (rolling KV): each block-table row's first
            ``ring_pages`` entries form a ring holding position ``p`` at
            slot ``p % (ring_pages * page_size)``; needs ``window_size > 0``
            (ValueError otherwise) and a ring covering the window and the
            step's writes.
        layer_idx: the layer of a stacked (L, ...) cache pool.
        strict: the JAX op's size checks first, with its messages (on one
            layer of a stacked pool).

    Returns:
        (total_num_q, num_q_heads, head_size) in the query's dtype.
    """
    if strict:
        stacked = layer_idx is not None
        _check_size_compatibility(
            query, key_cache[0] if stacked and key_cache.dim() == 5 else key_cache,
            value_cache[0] if stacked and value_cache.dim() == 5 else value_cache, cu_seqlens_q, seq_lens, block_table,
        )
    key_cache, value_cache = resolve_kv_caches(kv_cache_dtype, key_cache, value_cache)
    key_caches, value_caches, layer = stacked_view(key_cache, value_cache, layer_idx)
    batch = cu_seqlens_q.shape[0] - 1
    if block_table.shape[0] != batch or seq_lens.shape != (batch,):
        msg = f"block_table and seq_lens must have {batch} rows (len(cu_seqlens_q) - 1)"
        raise ValueError(msg)
    if query.dim() != 3 or key_caches.shape[-1] != query.shape[-1] or query.shape[1] % key_caches.shape[2]:
        msg = f"query {tuple(query.shape)} does not fit caches {tuple(key_caches.shape)}"
        raise ValueError(msg)
    if scale is None:
        scale = 1.0 / math.sqrt(query.shape[-1])
    return varlen_attention_launcher(
        query, key_caches, value_caches, cu_seqlens_q, seq_lens, block_table, scale, causal, layer, float(softcap),
        int(window_size), scale_value(q_scale), scale_value(k_scale), scale_value(v_scale), int(ring_pages),
    )
