# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Golden attention over paged KV caches.

Counterpart of ``conch_tpu/reference/attention/attention.py``: gather one
sequence's pages back into contiguous K/V, then a plain masked softmax in
f32 (no online softmax), one sequence at a time. Cache layout
(num_pages, num_kv_heads, page_size, head_size). A sequence with no
cached tokens, and a query row that belongs to no sequence, yield zeros.

Options, as in the JAX reference: ``softcap > 0`` maps each scaled
logit s to ``softcap * tanh(s / softcap)`` before the mask; a sliding
``window_size > 0`` lets query position p see keys ``k > p - window_size``
(decode: the last ``window_size`` cached tokens). ``ring_pages > 0``
(rolling KV) makes each block-table row a ring: a sequence's true page
``i`` lives at table entry ``i % ring_pages``, so positions before the
window may have been overwritten by later ones; the window masks them, as
the TPU kernels' band walk skips them. Caches may be int8 or
float8_e4m3fn, quantized on store: their values convert exactly to f32,
and the dequantization scales fold as the TPU kernels fold them, ``q_scale
* k_scale`` into the softmax scale and ``v_scale`` onto the f32 output.
"""

from __future__ import annotations

import torch


def gather_cache_for_sequence(
    cache: torch.Tensor, block_table_row: torch.Tensor, seq_len: int, ring_pages: int = 0
) -> torch.Tensor:
    """One sequence's (seq_len, num_kv_heads, head_size) rows; under a ring
    true page ``i`` reads table entry ``i % ring_pages``."""
    _, num_kv_heads, page_size, head_size = cache.shape
    num_needed = -(-seq_len // page_size)
    entries = torch.arange(num_needed, device=block_table_row.device)
    if ring_pages > 0:
        entries = entries % ring_pages
    pages = cache[block_table_row[entries].long()]  # (n, KH, ps, D)
    contiguous = pages.transpose(1, 2).reshape(num_needed * page_size, num_kv_heads, head_size)
    return contiguous[:seq_len]


def masked_attention(
    q: torch.Tensor,  # (q_len, QH, D)
    k: torch.Tensor,  # (k_len, KH, D)
    v: torch.Tensor,
    scale: float,
    causal: bool,
    softcap: float = 0.0,
    window_size: int = 0,
) -> torch.Tensor:
    """Plain f32 softmax attention for one sequence (GQA-aware). Query row
    j sits at position ``k_len - q_len + j``."""
    q_len, num_q_heads, head_size = q.shape
    k_len, num_kv_heads, _ = k.shape
    if k_len == 0:
        return torch.zeros(q_len, num_q_heads, head_size, dtype=torch.float32, device=q.device)
    group = num_q_heads // num_kv_heads
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("qhd,khd->hqk", qf, kf) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = k_len - q_len + torch.arange(q_len, device=q.device)
    k_pos = torch.arange(k_len, device=q.device)
    mask = torch.ones((q_len, k_len), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window_size > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window_size
    if causal or window_size > 0:
        s = s.masked_fill(~mask[None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,khd->qhd", p, vf)


def paged_attention(
    query: torch.Tensor,  # (B, QH, D)
    key_cache: torch.Tensor,
    value_cache: torch.Tensor,
    block_table: torch.Tensor,
    seq_lens: torch.Tensor,
    scale: float,
    softcap: float = 0.0,
    window_size: int = 0,
    k_scale: float = 1.0,
    v_scale: float = 1.0,
    ring_pages: int = 0,
) -> torch.Tensor:
    """Golden decode attention: one query token per sequence. f32 output."""
    outs = []
    for b, seq_len in enumerate(seq_lens.tolist()):
        k = gather_cache_for_sequence(key_cache, block_table[b], seq_len, ring_pages)
        v = gather_cache_for_sequence(value_cache, block_table[b], seq_len, ring_pages)
        outs.append(masked_attention(query[b : b + 1], k, v, scale * k_scale, False, softcap, window_size)[0])
    return torch.stack(outs) * v_scale


def varlen_attention(
    query: torch.Tensor,  # (total_q, QH, D), rows past cu_seqlens_q[-1] are padding
    key_cache: torch.Tensor,
    value_cache: torch.Tensor,
    cu_seqlens_q: torch.Tensor,
    seq_lens: torch.Tensor,
    block_table: torch.Tensor,
    scale: float,
    causal: bool,
    softcap: float = 0.0,
    window_size: int = 0,
    q_scale: float = 1.0,
    k_scale: float = 1.0,
    v_scale: float = 1.0,
    ring_pages: int = 0,
) -> torch.Tensor:
    """Golden varlen attention over ragged queries. f32 output."""
    out = torch.zeros(query.shape, dtype=torch.float32, device=query.device)
    cu = cu_seqlens_q.tolist()
    for b, seq_len in enumerate(seq_lens.tolist()):
        if cu[b + 1] == cu[b]:
            continue
        k = gather_cache_for_sequence(key_cache, block_table[b], seq_len, ring_pages)
        v = gather_cache_for_sequence(value_cache, block_table[b], seq_len, ring_pages)
        out[cu[b] : cu[b + 1]] = masked_attention(
            query[cu[b] : cu[b + 1]], k, v, scale * q_scale * k_scale, causal, softcap, window_size
        )
    return out * v_scale
