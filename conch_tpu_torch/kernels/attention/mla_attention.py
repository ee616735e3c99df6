# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Multi-head latent attention: the CUDA kernel (K11) and its plain version.

The kernel is ``csrc/mla_attention.cu``; it replaces
``conch_tpu/kernels/attention/mla_attention.py:_mla_dma_kernel`` and its
launcher. It is bound by bytes at decode and by operations at prefill;
one block per (sequence, tile of packed (token, head) rows) reads each
cached row once for every head, and the KV range is split across blocks
(merged by log-sum-exp) when those blocks would not fill the card. int8
and float8_e4m3fn latent caches (quantized on store, ``kv_scale`` folded
into the score scale and the output) take bf16 queries on the card: their
rows widen to bf16 exactly as they enter shared memory.
``mla_attention_launcher`` takes the plain version for CPU tensors only;
on CUDA it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from conch_tpu_torch.kernels.common import (
    QUANTIZED_CACHE_DTYPES,
    cdiv,
    check_launch,
    dtype_code,
    kernel_function,
    require_cuda,
    round_up,
    sm_count,
    storage_code,
    stream_of,
)
from conch_tpu_torch.reference.attention.mla_attention import mla_attention as _mla_reference

# Limits and tiles of csrc/mla_attention.cu.
MAX_LATENT = 512
KV_TILE = 64  # cached rows per shared-memory tile (bf16)
MIN_SPLIT = 256  # fewest cached rows a KV split walks
MAX_SPLITS = 256
NO_SPLIT = 1 << 30


def mla_attention_plain(
    query: torch.Tensor,
    kv_cache: torch.Tensor,
    cu_seqlens_q: torch.Tensor,
    max_seqlen_q: int,
    seq_lens: torch.Tensor,
    block_table: torch.Tensor,
    scale: float,
    latent: int,
    causal: bool = True,
    kv_scale: float = 1.0,
) -> torch.Tensor:
    """Plain PyTorch version of K11 on any device; output in the query's dtype."""
    out = _mla_reference(
        query, kv_cache, cu_seqlens_q, max_seqlen_q, seq_lens, block_table, scale, latent, causal, kv_scale
    )
    return out.to(query.dtype)


def kv_splits(blocks: int, max_kv: int, sms: int) -> tuple[int, int]:
    """(number of KV splits, rows each) for ``blocks`` (sequence, row tile)
    blocks over at most ``max_kv`` cached rows: none when the blocks fill
    two waves of ``sms``, else enough splits of at least MIN_SPLIT rows to."""
    if blocks >= 2 * sms:
        return 1, NO_SPLIT
    n = min(cdiv(2 * sms, blocks), cdiv(max_kv, MIN_SPLIT), MAX_SPLITS)
    if n <= 1:
        return 1, NO_SPLIT
    split_len = round_up(cdiv(max_kv, n), KV_TILE)
    return cdiv(max_kv, split_len), split_len


def _mla_cuda(query, kv_cache, cu_seqlens_q, max_seqlen_q, seq_lens, block_table, scale, latent, causal, kv_scale):
    require_cuda(query, kv_cache, cu_seqlens_q, seq_lens, block_table)
    if kv_cache.dtype in QUANTIZED_CACHE_DTYPES:
        if query.dtype != torch.bfloat16:
            msg = f"mla_attention kernel: {kv_cache.dtype} latent caches take bf16 queries, got {query.dtype}"
            raise NotImplementedError(msg)
    elif query.dtype != kv_cache.dtype:
        msg = f"mla_attention kernel: query {query.dtype} and cache {kv_cache.dtype} must share a dtype"
        raise ValueError(msg)
    if latent % 128 or latent > MAX_LATENT:
        msg = f"mla_attention kernel: latent must be a multiple of 128 up to {MAX_LATENT}, got {latent}"
        raise ValueError(msg)
    if any(t.dtype != torch.int32 for t in (cu_seqlens_q, seq_lens, block_table)):
        msg = "mla_attention kernel: cu_seqlens_q, seq_lens and block_table must be int32"
        raise ValueError(msg)
    if not kv_cache.is_contiguous():
        msg = "mla_attention kernel: the cache layer must be contiguous"
        raise ValueError(msg)
    query = query.contiguous()
    if query.data_ptr() % 16 or kv_cache.data_ptr() % 16:
        msg = "mla_attention kernel: query and cache must be 16-byte aligned"
        raise ValueError(msg)
    cu_seqlens_q, seq_lens, block_table = (t.contiguous() for t in (cu_seqlens_q, seq_lens, block_table))
    total_q, heads, packed = query.shape
    _, page_size, _ = kv_cache.shape
    batch, max_pages = block_table.shape
    out = torch.empty((total_q, heads, latent), dtype=query.dtype, device=query.device)
    m_tiles = 4 if query.dtype == torch.bfloat16 and max_seqlen_q * heads > 16 else 1
    blocks = batch * cdiv(max_seqlen_q * heads, 16 * m_tiles)
    nsplit, split_len = kv_splits(blocks, max_pages * page_size, sm_count(query.device.index))
    part_acc = part_ml = None
    if nsplit > 1:
        part_acc = torch.empty((nsplit, total_q, heads, latent), dtype=torch.float32, device=query.device)
        part_ml = torch.empty((nsplit, total_q, heads, 2), dtype=torch.float32, device=query.device)
    fn = kernel_function("conch_mla_attention", (
        *(ctypes.c_void_p,) * 8, *(ctypes.c_int,) * 12, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ))
    code = fn(
        query.data_ptr(), out.data_ptr(), kv_cache.data_ptr(), cu_seqlens_q.data_ptr(), seq_lens.data_ptr(),
        block_table.data_ptr(), None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), total_q, batch, max_pages, heads, page_size, packed,
        latent, max_seqlen_q, int(causal), split_len, nsplit, m_tiles, scale * kv_scale, kv_scale,
        dtype_code(query), storage_code(kv_cache), stream_of(query),
    )
    check_launch("conch_mla_attention", code)
    mla_attention_launcher.launches += 1
    return out


def mla_attention_launcher(
    query: torch.Tensor,  # (total_q, heads, packed) [q_nope @ W_uk | q_pe | 0-pad]
    kv_cache: torch.Tensor,  # (pages, page_size, packed) rows [c_kv | k_pe | 0-pad]
    cu_seqlens_q: torch.Tensor,  # (batch+1,) int32
    max_seqlen_q: int,
    seq_lens: torch.Tensor,  # (batch,) int32
    block_table: torch.Tensor,  # (batch, max_pages) int32
    *,
    scale: float,
    latent: int,
    causal: bool = True,
    kv_scale: float = 1.0,
) -> torch.Tensor:
    """Varlen multi-head latent attention (prefill and decode: decode is
    one query token per sequence); (total_q, heads, latent) in the
    query's dtype. ``max_seqlen_q`` bounds every sequence's query count.
    ``launches`` counts kernel launches."""
    packed = query.shape[-1]
    if packed != kv_cache.shape[-1]:
        msg = f"query packed dim {packed} != cache packed dim {kv_cache.shape[-1]}"
        raise ValueError(msg)
    if packed % 128 != 0:
        msg = f"packed MLA dim must be a lane multiple (128), got {packed}: pad [c_kv|k_pe]"
        raise ValueError(msg)
    if kv_cache.dtype not in (torch.float32, torch.bfloat16, *QUANTIZED_CACHE_DTYPES):
        msg = f"latent caches are f32, bf16, int8 or float8_e4m3fn, got {kv_cache.dtype}"
        raise NotImplementedError(msg)
    args = (query, kv_cache, cu_seqlens_q, max_seqlen_q, seq_lens, block_table, scale, latent, causal, kv_scale)
    if query.device.type == "cpu":
        return mla_attention_plain(*args)
    return _mla_cuda(*args)


mla_attention_launcher.launches = 0
