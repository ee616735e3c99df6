# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Varlen attention public op (counterpart of ``conch_tpu/ops/attention/varlen_attention.py``)."""

from __future__ import annotations

import math

import torch

from conch_tpu_torch.kernels.attention.varlen_attention import varlen_attention_launcher
from conch_tpu_torch.ops.attention.paged_attention import check_unported_options, resolve_kv_caches, stacked_view
from conch_tpu_torch.ops.kv_quant import scale_value


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

    Returns:
        (total_num_q, num_q_heads, head_size) in the query's dtype.
    """
    check_unported_options(ring_pages)
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
        int(window_size), scale_value(q_scale), scale_value(k_scale), scale_value(v_scale),
    )
