# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Paged decode attention: the CUDA kernel (K3) and its plain version.

The kernel is ``csrc/paged_attention.cuh`` (entry point ``csrc/paged_attention.cu``); it replaces
``conch_tpu/kernels/attention/paged_attention.py:_paged_allheads_kernel``
(and the per-head ``_paged_attention_kernel``, same function). It reads
one layer of the stacked (L, P, KH, ps, D) pool through a pointer offset.
Softcap and a sliding window are run-time arguments (0 disables each), so
one build serves Llama and Gemma-2's local and global layers. Queries are
f32, bf16 or f16 (a template parameter), over a cache of their own type
(or bf16 under f32 queries) or a 1-byte one (``KV_DTYPE_PAIRS``). The caches
may be int8 or float8_e4m3fn (quantized on store by K2): the kernel reads
them in their own type, folds ``k_scale`` into the softmax scale and
multiplies the f32 output by ``v_scale``, as the TPU kernel does.
Rolling KV (``ring_pages > 0``, a run-time argument too) makes each
block-table row a ring: the kernel reads true page ``i`` at table entry
``i % ring_pages``, as the TPU kernel's ``jax.lax.rem`` does (:127-130).

The kernel splits each sequence's visible tokens over blocks and merges
the splits by log-sum-exp (a second kernel). ``paged_split_plan`` sets
the split count and length from shapes alone (the block table's width,
the page size, the window and the SM count), never from ``seq_lens``'
values, so the wrapper reads no tensor value on the host and a call can
be captured in a CUDA graph. ``paged_attention_launcher`` takes the plain
version for CPU tensors only; on CUDA it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from conch_tpu_torch.kernels.common import (
    FLOAT_DTYPES,
    cdiv,
    check_kv_dtypes,
    check_launch,
    dtype_code,
    kernel_function,
    require_cuda,
    round_up,
    sm_count,
    storage_code,
    stream_of,
)
from conch_tpu_torch.reference.attention.attention import paged_attention as _paged_reference

# Limits of csrc/attention_common.cuh and csrc/paged_attention.cuh (kMaxGroup, kMaxHeadSize).
MAX_GROUP = 8
MAX_HEAD_SIZE = 256
# K3's splits of the KV walk (csrc/paged_attention.cuh: kTile, kMaxSplits).
SPLIT_TILE = 32  # tokens a stage of the kernel's ring; a split is a whole number of them
SPLIT_TOKENS = 256  # tokens a split walks at most (128 KiB of bf16 K and V at head 128)
MIN_SPLIT_TOKENS = 64
MAX_SPLITS = 256


@dataclasses.dataclass(frozen=True)
class PagedSplitPlan:
    """K3's grid (B, KH, ``splits``): split z of a sequence walks its visible
    tokens ``kv_start + z * split_len`` .. ``+ split_len - 1``, with
    ``kv_start = max(seq_len - window, 0)`` under a window, else 0 (the
    kernel's ``visible_start``)."""

    splits: int
    split_len: int

    def split_range(self, seq_len: int, window: int, split: int) -> tuple[int, int]:
        """Tokens [start, end) that split ``split`` walks for one sequence;
        empty (start >= end) when the split lies past ``seq_len``."""
        kv_start = max(seq_len - window, 0) if window > 0 else 0
        start = kv_start + split * self.split_len
        return start, min(start + self.split_len, seq_len)

    def workspace_shapes(self, batch: int, num_q_heads: int, head_size: int) -> tuple[tuple, tuple] | None:
        """The splits' f32 accumulators and (max, sum) pairs; none with one split."""
        if self.splits == 1:
            return None
        return (self.splits, batch, num_q_heads, head_size), (self.splits, batch, num_q_heads, 2)


def paged_split_plan(
    seq_lens: torch.Tensor, block_table: torch.Tensor, page_size: int, num_kv_heads: int, window: int, num_sms: int
) -> PagedSplitPlan:
    """K3's splits from shapes only: a row holds at most ``max_pages *
    page_size`` tokens and sees at most ``window`` of them. A rolling-KV
    ring covers the window, so under a ring the window bounds the walk and
    a rolling engine and an unbounded one with the same window run the same
    plan. Splits walk
    SPLIT_TOKENS, fewer (down to MIN_SPLIT_TOKENS) when even full rows
    would give the (B, KH) grid under two waves of ``num_sms``, and more
    when MAX_SPLITS would not cover a row; a split is a whole number of
    SPLIT_TILE tokens. One split (a short table) walks the whole visible
    capacity. Reads no value of either tensor."""
    batch, max_pages = block_table.shape
    if seq_lens.shape != (batch,):
        msg = f"paged_attention kernel: seq_lens {tuple(seq_lens.shape)} for a block table of {batch} rows"
        raise ValueError(msg)
    visible = max_pages * page_size
    if window > 0:
        visible = min(visible, window)
    fill = cdiv(max(batch * num_kv_heads * visible, 1), 2 * num_sms)
    split_len = round_up(min(SPLIT_TOKENS, max(MIN_SPLIT_TOKENS, fill)), SPLIT_TILE)
    split_len = max(split_len, round_up(cdiv(visible, MAX_SPLITS), SPLIT_TILE))
    splits = cdiv(visible, split_len)
    return PagedSplitPlan(max(splits, 1), split_len)


def copy_bytes(row_bytes: int, *pointers: int) -> int:
    """The kernel's cp.async size for rows of ``row_bytes``: 16 or 4 bytes
    when the rows and the pointers allow, else 0 (element by element)."""
    for size in (16, 4):
        if row_bytes % size == 0 and all(ptr % size == 0 for ptr in pointers):
            return size
    return 0


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
    ring_pages: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of K3 on any device: gather each sequence's
    pages (through the ring with ``ring_pages``) and take an f32 softmax.
    Output in the query's dtype."""
    out = _paged_reference(
        query, key_caches[layer_idx], value_caches[layer_idx], block_table, seq_lens, scale, softcap, window_size,
        k_scale, v_scale, ring_pages,
    )
    return out.to(query.dtype)


def check_kernel_shapes(query: torch.Tensor, key_caches: torch.Tensor, value_caches: torch.Tensor) -> None:
    """Raise on inputs the attention kernels (K3, K7) do not take."""
    num_q_heads, head_size = query.shape[1], query.shape[2]
    num_kv_heads = key_caches.shape[2]
    check_kv_dtypes("attention", query, key_caches, value_caches)
    if num_q_heads % num_kv_heads or num_q_heads // num_kv_heads > MAX_GROUP or head_size > MAX_HEAD_SIZE:
        msg = (
            f"attention kernels take GQA groups up to {MAX_GROUP} and head sizes up to {MAX_HEAD_SIZE}, "
            f"got {num_q_heads}/{num_kv_heads} heads of {head_size}"
        )
        raise NotImplementedError(msg)
    if not (query.is_contiguous() and key_caches.is_contiguous() and value_caches.is_contiguous()):
        msg = "attention kernels: query and caches must be contiguous"
        raise ValueError(msg)


def check_ring(ring_pages: int, window_size: int, table_width: int, page_size: int) -> None:
    """Raise on a ring the attention kernels (K3, K7) cannot read: one
    without a window (the JAX launchers' message), one wider than the
    block table, or one whose tokens do not cover the window (K3 wraps a
    tile's rows at the ring once)."""
    if ring_pages > 0 and window_size <= 0:
        msg = "ring_pages (rolling KV) requires window_size > 0"
        raise ValueError(msg)
    if not 0 <= ring_pages <= table_width:
        msg = f"ring_pages {ring_pages} outside the block table's {table_width} entries"
        raise ValueError(msg)
    if 0 < ring_pages * page_size < window_size:
        msg = f"a ring of {ring_pages} pages of {page_size} does not cover the window of {window_size} tokens"
        raise ValueError(msg)


def layer_pointers(key_caches: torch.Tensor, value_caches: torch.Tensor, layer_idx: int) -> tuple[int, int]:
    """Device addresses of layer ``layer_idx`` in the stacked pools."""
    if not 0 <= layer_idx < key_caches.shape[0]:
        msg = f"layer_idx {layer_idx} outside the {key_caches.shape[0]}-layer pool"
        raise IndexError(msg)
    return key_caches[layer_idx].data_ptr(), value_caches[layer_idx].data_ptr()


def _paged_cuda(
    query, key_caches, value_caches, block_table, seq_lens, scale, layer_idx, softcap, window_size, k_scale, v_scale,
    ring_pages,
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
    plan = paged_split_plan(seq_lens, block_table, page_size, num_kv_heads, window_size, sm_count(query.device.index))
    shapes = plan.workspace_shapes(batch, num_q_heads, head_size)
    part_acc, part_ml = (None, None) if shapes is None else (
        torch.empty(shape, dtype=torch.float32, device=query.device) for shape in shapes
    )
    out = torch.empty_like(query)
    fn = kernel_function("conch_paged_attention", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ))
    code = fn(
        query.data_ptr(), out.data_ptr(), k_layer, v_layer, block_table.data_ptr(), seq_lens.data_ptr(),
        batch, block_table.shape[1], num_q_heads, num_kv_heads, page_size, head_size, scale * k_scale, softcap,
        window_size, ring_pages, v_scale, dtype_code(query, FLOAT_DTYPES), storage_code(key_caches), plan.split_len,
        plan.splits,
        None if part_acc is None else part_acc.data_ptr(), None if part_ml is None else part_ml.data_ptr(),
        copy_bytes(head_size * key_caches.element_size(), k_layer, v_layer), stream_of(query),
    )
    check_launch("conch_paged_attention", code)
    paged_attention_launcher.launches += 1
    if ring_pages > 0:
        paged_attention_launcher.ring_launches += 1
    if query.dtype == torch.float16:
        paged_attention_launcher.f16_launches += 1
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
    ring_pages: int = 0,  # > 0: rolling KV, true page i at table entry i % ring_pages (needs a window)
) -> torch.Tensor:
    """Decode attention of one query token per sequence over layer
    ``layer_idx``. Only the first ``seq_lens[b]`` cached tokens are read
    (with a window, only the last ``window_size`` of them); block-table
    entries past them are never touched. Under a ring the table's first
    ``ring_pages`` entries hold position ``p`` at slot ``p % (ring_pages *
    page_size)``; the ring must cover the window. The logits are
    ``q . k * scale * k_scale`` and the output is multiplied by
    ``v_scale``. ``launches`` counts kernel launches (``ring_launches`` those over a ring,
    ``f16_launches`` those of f16 queries)."""
    check_ring(ring_pages, window_size, block_table.shape[1], key_caches.shape[3])
    args = (
        query, key_caches, value_caches, block_table, seq_lens, scale, layer_idx, softcap, window_size, k_scale,
        v_scale, ring_pages,
    )
    if query.device.type == "cpu":
        return paged_attention_plain(*args)
    return _paged_cuda(*args)


paged_attention_launcher.launches = 0
paged_attention_launcher.ring_launches = 0  # the launches over a rolling-KV ring
paged_attention_launcher.f16_launches = 0  # the launches of f16 queries
