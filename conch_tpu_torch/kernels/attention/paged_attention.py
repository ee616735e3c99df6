# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Paged decode attention: the CUDA kernel (K3) and its plain version.

The kernel is ``csrc/paged_attention.cu``; it replaces
``conch_tpu/kernels/attention/paged_attention.py:_paged_allheads_kernel``
(and the per-head ``_paged_attention_kernel``, same function). It reads
one layer of the stacked (L, P, KH, ps, D) pool through a pointer offset.
Softcap and a sliding window are run-time arguments (0 disables each), so
one build serves Llama and Gemma-2's local and global layers. The caches
may be int8 or float8_e4m3fn (quantized on store by K2): the kernel reads
them in their own type, folds ``k_scale`` into the softmax scale and
multiplies the f32 output by ``v_scale``, as the TPU kernel does.
``paged_attention_launcher`` takes the plain version for CPU tensors
only; on CUDA it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from conch_tpu_torch.kernels.common import (
    QUANTIZED_CACHE_DTYPES,
    check_launch,
    dtype_code,
    kernel_function,
    require_cuda,
    storage_code,
    stream_of,
)
from conch_tpu_torch.reference.attention.attention import paged_attention as _paged_reference

# Limits of csrc/attention_common.cuh (kMaxGroup, kMaxHeadSize).
MAX_GROUP = 8
MAX_HEAD_SIZE = 256


def paged_attention_plain(
    query: torch.Tensor,
    key_caches: torch.Tensor,
    value_caches: torch.Tensor,
    block_table: torch.Tensor,
    seq_lens: torch.Tensor,
    scale: float,
    layer_idx: int,
    softcap: float = 0.0,
    window_size: int = 0,
    k_scale: float = 1.0,
    v_scale: float = 1.0,
) -> torch.Tensor:
    """Plain PyTorch version of K3 on any device: gather each sequence's
    pages and take an f32 softmax. Output in the query's dtype."""
    out = _paged_reference(
        query, key_caches[layer_idx], value_caches[layer_idx], block_table, seq_lens, scale, softcap, window_size,
        k_scale, v_scale,
    )
    return out.to(query.dtype)


def check_kernel_shapes(query: torch.Tensor, key_caches: torch.Tensor, value_caches: torch.Tensor) -> None:
    """Raise on inputs the attention kernels (K3, K7) do not take."""
    num_q_heads, head_size = query.shape[1], query.shape[2]
    num_kv_heads = key_caches.shape[2]
    cache_ok = key_caches.dtype in (torch.bfloat16, *QUANTIZED_CACHE_DTYPES) or key_caches.dtype == query.dtype
    if query.dtype not in (torch.float32, torch.bfloat16) or not cache_ok or value_caches.dtype != key_caches.dtype:
        msg = (
            f"attention kernels take f32 or bf16 queries over bf16, int8 or float8_e4m3fn caches (or f32 "
            f"caches under f32 queries), got q {query.dtype}, caches {key_caches.dtype}/{value_caches.dtype}"
        )
        raise NotImplementedError(msg)
    if num_q_heads % num_kv_heads or num_q_heads // num_kv_heads > MAX_GROUP or head_size > MAX_HEAD_SIZE:
        msg = (
            f"attention kernels take GQA groups up to {MAX_GROUP} and head sizes up to {MAX_HEAD_SIZE}, "
            f"got {num_q_heads}/{num_kv_heads} heads of {head_size}"
        )
        raise NotImplementedError(msg)
    if not (query.is_contiguous() and key_caches.is_contiguous() and value_caches.is_contiguous()):
        msg = "attention kernels: query and caches must be contiguous"
        raise ValueError(msg)


def layer_pointers(key_caches: torch.Tensor, value_caches: torch.Tensor, layer_idx: int) -> tuple[int, int]:
    """Device addresses of layer ``layer_idx`` in the stacked pools."""
    if not 0 <= layer_idx < key_caches.shape[0]:
        msg = f"layer_idx {layer_idx} outside the {key_caches.shape[0]}-layer pool"
        raise IndexError(msg)
    return key_caches[layer_idx].data_ptr(), value_caches[layer_idx].data_ptr()


def _paged_cuda(
    query, key_caches, value_caches, block_table, seq_lens, scale, layer_idx, softcap, window_size, k_scale, v_scale
):
    require_cuda(query, key_caches, value_caches, block_table, seq_lens)
    check_kernel_shapes(query, key_caches, value_caches)
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        msg = "paged_attention kernel: block_table and seq_lens must be int32"
        raise ValueError(msg)
    block_table = block_table.contiguous()
    seq_lens = seq_lens.contiguous()
    batch, num_q_heads, head_size = query.shape
    _, _, num_kv_heads, page_size, _ = key_caches.shape
    k_layer, v_layer = layer_pointers(key_caches, value_caches, layer_idx)
    out = torch.empty_like(query)
    fn = kernel_function("conch_paged_attention", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ))
    code = fn(
        query.data_ptr(), out.data_ptr(), k_layer, v_layer, block_table.data_ptr(), seq_lens.data_ptr(),
        batch, block_table.shape[1], num_q_heads, num_kv_heads, page_size, head_size, scale * k_scale, softcap,
        window_size, v_scale, dtype_code(query), storage_code(key_caches), stream_of(query),
    )
    check_launch("conch_paged_attention", code)
    paged_attention_launcher.launches += 1
    return out


def paged_attention_launcher(
    query: torch.Tensor,  # (B, QH, D)
    key_caches: torch.Tensor,  # (L, P, KH, ps, D)
    value_caches: torch.Tensor,
    block_table: torch.Tensor,  # (B, max_pages) int32
    seq_lens: torch.Tensor,  # (B,) int32; 0 = idle row, output zeros
    scale: float,
    layer_idx: int,
    softcap: float = 0.0,  # > 0: logits capped at softcap * tanh(s / softcap)
    window_size: int = 0,  # > 0: only the last window_size cached tokens are seen
    k_scale: float = 1.0,  # dequantization scales of the caches
    v_scale: float = 1.0,
) -> torch.Tensor:
    """Decode attention of one query token per sequence over layer
    ``layer_idx``. Only the first ``seq_lens[b]`` cached tokens are read
    (with a window, only the last ``window_size`` of them); block-table
    entries past them are never touched. The logits are
    ``q . k * scale * k_scale`` and the output is multiplied by
    ``v_scale``. ``launches`` counts kernel launches."""
    args = (
        query, key_caches, value_caches, block_table, seq_lens, scale, layer_idx, softcap, window_size, k_scale,
        v_scale,
    )
    if query.device.type == "cpu":
        return paged_attention_plain(*args)
    return _paged_cuda(*args)


paged_attention_launcher.launches = 0
