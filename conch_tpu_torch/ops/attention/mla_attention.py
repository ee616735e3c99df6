# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Multi-head latent attention public op (counterpart of
``conch_tpu/ops/attention/mla_attention.py``, DeepSeek-V2 family).

Shape validation up front, as in the JAX package; K11
(``kernels/attention/mla_attention.py``) does the work.
"""

from __future__ import annotations

import torch

from conch_tpu_torch.kernels.attention.mla_attention import mla_attention_launcher


def mla_attention(
    query: torch.Tensor,
    kv_cache: torch.Tensor,
    cu_seqlens_q: torch.Tensor,
    max_seqlen_q: int,
    seq_lens: torch.Tensor,
    block_table: torch.Tensor,
    *,
    scale: float,
    latent: int,
    causal: bool = True,
    kv_scale: float = 1.0,
) -> torch.Tensor:
    """Varlen MLA over the unified latent cache (prefill and decode).

    Args:
        query: (total_q, num_heads, packed) absorbed queries
            ``[q_nope @ W_uk | q_pe | zero-pad]``; ``packed`` must be a
            multiple of 128.
        kv_cache: (num_pages, page_size, packed) rows ``[c_kv | k_pe | pad]``.
        cu_seqlens_q: (batch+1,) cumulative query counts.
        max_seqlen_q: max per-sequence query count.
        seq_lens: (batch,) KV lengths.
        block_table: (batch, max_pages) page ids.
        scale: softmax scale — 1/sqrt(qk_nope + qk_rope), NOT the packed dim.
        latent: kv_lora_rank (the value width = the cache row's prefix).
        kv_scale: dequantization scale for int8/fp8 latent caches (folded
            into the attention scalars; 1.0 for bf16/f32 caches).

    Returns:
        (total_q, num_heads, latent) latent-space attention output.
    """
    if query.dim() != 3:
        msg = f"query must be (total_q, heads, packed), got {tuple(query.shape)}"
        raise ValueError(msg)
    if kv_cache.dim() != 3:
        msg = f"kv_cache must be (pages, page_size, packed), got {tuple(kv_cache.shape)}"
        raise ValueError(msg)
    if query.shape[-1] != kv_cache.shape[-1]:
        msg = f"packed dims differ: query {query.shape[-1]} vs cache {kv_cache.shape[-1]}"
        raise ValueError(msg)
    if not 0 < latent <= query.shape[-1]:
        msg = f"latent {latent} out of range for packed dim {query.shape[-1]}"
        raise ValueError(msg)
    if block_table.shape[0] != cu_seqlens_q.shape[0] - 1 or seq_lens.shape[0] != block_table.shape[0]:
        msg = (
            f"batch mismatch: block_table {block_table.shape[0]}, "
            f"cu_seqlens {cu_seqlens_q.shape[0] - 1}, seq_lens {seq_lens.shape[0]}"
        )
        raise ValueError(msg)
    return mla_attention_launcher(
        query, kv_cache, cu_seqlens_q, max_seqlen_q, seq_lens, block_table,
        scale=scale, latent=latent, causal=causal, kv_scale=kv_scale,
    )
