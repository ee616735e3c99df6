# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Golden multi-head latent attention over the packed latent cache.

The plain PyTorch version of K11 (``conch_tpu/kernels/attention/mla_attention.py``),
on any device. Per sequence: gather its packed rows ``[c_kv | k_pe | pad]``
through the block table, take the scores of every head against the
whole row at ``scale * kv_scale``, mask causally at offset
``seq_k - seq_q``, softmax in f32, take the values from the rows'
``[:latent]`` prefix, and multiply by ``kv_scale``. It rounds where the
TPU kernel does, in the kernel's matrix-unit type for the cache
(``kv_mxu_dtype`` there): bf16 for bf16 and float8_e4m3fn caches, f32 for
f32 and int8 ones. The query is rounded to that type, and so are the
unnormalized probabilities before the value product (the sum stays f32).
int8 and e4m3 rows convert exactly. (K11 on the card runs bf16 for every
cache but f32, so on an int8 cache it also rounds the probabilities to
bf16: a difference far inside the bf16 tolerance.)

Rows past ``cu_seqlens_q[batch]`` are padding and come out as the JAX
launcher's clamped gather leaves them: row t takes the output of token
``min(t - cu_seqlens_q[batch], max_seqlen_q - 1)`` of the last sequence,
or zeros where that sequence has no such token.
"""

from __future__ import annotations

import torch

# The TPU kernel's matrix-unit type for a cache type (kv_mxu_dtype): the
# cache's own for bf16 and f32, bf16 for e4m3, f32 for any other.
MXU_DTYPES = {torch.bfloat16: torch.bfloat16, torch.float8_e4m3fn: torch.bfloat16}


def gather_latent_rows(kv_cache: torch.Tensor, block_table_row: torch.Tensor, seq_len: int) -> torch.Tensor:
    """One sequence's (seq_len, packed) cache rows, in order."""
    _, page_size, packed = kv_cache.shape
    pages = kv_cache[block_table_row[: -(-seq_len // page_size)].long()]
    return pages.reshape(-1, packed)[:seq_len]


def mla_attention(
    query: torch.Tensor,  # (total_q, heads, packed)
    kv_cache: torch.Tensor,  # (pages, page_size, packed)
    cu_seqlens_q: torch.Tensor,  # (batch+1,)
    max_seqlen_q: int,
    seq_lens: torch.Tensor,  # (batch,)
    block_table: torch.Tensor,  # (batch, max_pages)
    scale: float,
    latent: int,
    causal: bool = True,
    kv_scale: float = 1.0,
) -> torch.Tensor:
    """Varlen paged MLA; (total_q, heads, latent) in f32."""
    total_q, heads, _ = query.shape
    out = torch.zeros((total_q, heads, latent), dtype=torch.float32, device=query.device)
    cu = cu_seqlens_q.tolist()
    batch = len(cu) - 1
    mxu = MXU_DTYPES.get(kv_cache.dtype, torch.float32)
    for b, seq_k in enumerate(seq_lens.tolist()):
        q_len = cu[b + 1] - cu[b]
        if q_len == 0 or seq_k == 0:
            continue
        rows = gather_latent_rows(kv_cache, block_table[b], seq_k).float()
        q = query[cu[b] : cu[b + 1]].to(mxu).float()
        s = torch.einsum("qhd,kd->hqk", q, rows) * (scale * kv_scale)
        if causal:
            q_pos = seq_k - q_len + torch.arange(q_len, device=q.device)
            visible = torch.arange(seq_k, device=q.device)[None, :] <= q_pos[:, None]
            s = s.masked_fill(~visible[None], float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
        l = p.sum(dim=-1)  # (heads, q_len)
        p = p.to(mxu).float()
        acc = torch.einsum("hqk,kl->qhl", p, rows[:, :latent])
        l = l.transpose(0, 1)[..., None]
        out[cu[b] : cu[b + 1]] = acc / torch.where(l > 0, l, torch.ones_like(l)) * kv_scale
    total = cu[batch]
    if batch > 0 and total < total_q:
        pos = torch.arange(total_q - total, device=out.device).clamp(max=max_seqlen_q - 1)
        src = cu[batch - 1] + pos
        has_token = (src < total)[:, None, None]
        out[total:] = torch.where(has_token, out[src.clamp(max=max(total - 1, 0))], torch.zeros_like(out[total:]))
    return out
