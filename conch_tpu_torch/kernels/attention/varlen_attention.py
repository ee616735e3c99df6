# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Varlen paged prefill attention: the CUDA kernel (K7) and its plain version.

The kernel is ``csrc/varlen_attention.cu``; it replaces
``conch_tpu/kernels/attention/varlen_attention.py:_varlen_dma_allheads_kernel``
(and ``_varlen_dma_kernel`` / ``_varlen_attention_kernel``, same
function). Quantized caches and the q/k/v scales go as in K3
(``paged_attention.py``), with ``q_scale * k_scale`` folded into the
softmax scale. ``varlen_attention_launcher`` takes the plain version for
CPU tensors only; on CUDA it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from conch_tpu_torch.kernels.attention.paged_attention import check_kernel_shapes, layer_pointers
from conch_tpu_torch.kernels.common import (
    check_launch,
    dtype_code,
    kernel_function,
    require_cuda,
    storage_code,
    stream_of,
)
from conch_tpu_torch.reference.attention.attention import varlen_attention as _varlen_reference


def varlen_attention_plain(
    query: torch.Tensor,
    key_caches: torch.Tensor,
    value_caches: torch.Tensor,
    cu_seqlens_q: torch.Tensor,
    seq_lens: torch.Tensor,
    block_table: torch.Tensor,
    scale: float,
    causal: bool,
    layer_idx: int,
    softcap: float = 0.0,
    window_size: int = 0,
    q_scale: float = 1.0,
    k_scale: float = 1.0,
    v_scale: float = 1.0,
) -> torch.Tensor:
    """Plain PyTorch version of K7 on any device. Padding rows are zeros."""
    out = _varlen_reference(
        query, key_caches[layer_idx], value_caches[layer_idx], cu_seqlens_q, seq_lens, block_table, scale, causal,
        softcap, window_size, q_scale, k_scale, v_scale,
    )
    return out.to(query.dtype)


def _varlen_cuda(
    query, key_caches, value_caches, cu_seqlens_q, seq_lens, block_table, scale, causal, layer_idx, softcap,
    window_size, q_scale, k_scale, v_scale,
):
    require_cuda(query, key_caches, value_caches, cu_seqlens_q, seq_lens, block_table)
    check_kernel_shapes(query, key_caches, value_caches)
    if any(t.dtype != torch.int32 for t in (cu_seqlens_q, seq_lens, block_table)):
        msg = "varlen_attention kernel: cu_seqlens_q, seq_lens and block_table must be int32"
        raise ValueError(msg)
    cu_seqlens_q = cu_seqlens_q.contiguous()
    seq_lens = seq_lens.contiguous()
    block_table = block_table.contiguous()
    total_q, num_q_heads, head_size = query.shape
    _, _, num_kv_heads, page_size, _ = key_caches.shape
    k_layer, v_layer = layer_pointers(key_caches, value_caches, layer_idx)
    out = torch.empty_like(query)
    fn = kernel_function("conch_varlen_attention", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ))
    code = fn(
        query.data_ptr(), out.data_ptr(), k_layer, v_layer, cu_seqlens_q.data_ptr(), seq_lens.data_ptr(),
        block_table.data_ptr(), total_q, seq_lens.shape[0], block_table.shape[1], num_q_heads, num_kv_heads,
        page_size, head_size, scale * q_scale * k_scale, softcap, window_size, int(causal), v_scale,
        dtype_code(query), storage_code(key_caches), stream_of(query),
    )
    check_launch("conch_varlen_attention", code)
    varlen_attention_launcher.launches += 1
    return out


def varlen_attention_launcher(
    query: torch.Tensor,  # (total_q, QH, D)
    key_caches: torch.Tensor,  # (L, P, KH, ps, D)
    value_caches: torch.Tensor,
    cu_seqlens_q: torch.Tensor,  # (B+1,) int32
    seq_lens: torch.Tensor,  # (B,) int32
    block_table: torch.Tensor,  # (B, max_pages) int32
    scale: float,
    causal: bool,
    layer_idx: int,
    softcap: float = 0.0,  # > 0: logits capped at softcap * tanh(s / softcap)
    window_size: int = 0,  # > 0: row at position p sees keys from p - window_size + 1
    q_scale: float = 1.0,  # dequantization scales: q_scale * k_scale fold into the logits,
    k_scale: float = 1.0,  # v_scale multiplies the output
    v_scale: float = 1.0,
) -> torch.Tensor:
    """Attention of ragged queries over layer ``layer_idx`` of the pool.

    The queries of sequence b are rows ``cu_seqlens_q[b]:cu_seqlens_q[b+1]``
    and are its trailing tokens: row j sits at KV position
    ``seq_lens[b] - q_len[b] + j``. Rows past ``cu_seqlens_q[B]`` are
    padding and come out zero. ``launches`` counts kernel launches.
    """
    args = (
        query, key_caches, value_caches, cu_seqlens_q, seq_lens, block_table, scale, causal, layer_idx, softcap,
        window_size, q_scale, k_scale, v_scale,
    )
    if query.device.type == "cpu":
        return varlen_attention_plain(*args)
    return _varlen_cuda(*args)


varlen_attention_launcher.launches = 0
