# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Varlen paged prefill attention: the CUDA kernel (K7) and its plain version.

The kernel is ``csrc/varlen_attention.cu``; it replaces
``conch_tpu/kernels/attention/varlen_attention.py:_varlen_dma_allheads_kernel``
(and ``_varlen_dma_kernel`` / ``_varlen_attention_kernel``, same
function). Quantized caches and the q/k/v scales go as in K3
(``paged_attention.py``), with ``q_scale * k_scale`` folded into the
softmax scale. Rolling KV (``ring_pages > 0``) reads true page ``i`` at
table entry ``i % ring_pages`` (the TPU kernel's ``jax.lax.rem``,
:159-163); the walk starts at the window's low bound, as the TPU kernel's
band addressing does (:510-516), so a row's true pages may outnumber both
the table and the ring. ``varlen_attention_launcher`` takes the plain
version for CPU tensors only; on CUDA it launches the kernel or raises.

bf16 and f16 queries run a tiled tensor-core kernel (the 16-bit type a
template parameter; 1-byte caches widened to it): a block owns one (sequence,
tile of query rows) pair, one KV head and one split of the tile's keys.
``varlen_tile_plan`` sets the tile, the grid's tile slots and the splits
from shapes alone, never from the values of ``cu_seqlens_q`` or
``seq_lens``, so the wrapper reads no tensor value on the host and a call
can be captured in a CUDA graph; the kernel finds each block's pair on the
device. f32 queries run a per-row CUDA-core kernel, f32 throughout.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from conch_tpu_torch.kernels.attention.paged_attention import (
    check_kernel_shapes,
    check_ring,
    copy_bytes,
    layer_pointers,
)
from conch_tpu_torch.kernels.common import (
    FLOAT_DTYPES,
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
from conch_tpu_torch.reference.attention.attention import varlen_attention as _varlen_reference

# The tile kernel's constants (csrc/varlen_attention.cu: kRows, kBlocksPerSm, kMaxSplits, Smem::KT).
TILE_MMA_ROWS = 64  # MMA rows a block: the tile's query rows times the GQA group
BLOCKS_PER_SM = 2
MAX_SPLITS = 64
MIN_SPLIT_TOKENS = 128  # a split walks at least this many keys (2 to 4 K/V tiles)


def head_tile(head_size: int) -> int:
    """The kernel's padded head (its template): 64, 128 or 256."""
    return 64 if head_size <= 64 else 128 if head_size <= 128 else 256


def kv_tile(head_size: int) -> int:
    """Tokens of a staged K/V tile: 32 at a padded head of 256, else 64."""
    return 32 if head_tile(head_size) == 256 else 64


@dataclasses.dataclass(frozen=True)
class VarlenTilePlan:
    """K7's grid (``tile_slots``, KH, ``splits``) for bf16 queries.

    A tile is ``block_rows`` query rows of one sequence (``TILE_MMA_ROWS //
    G``, so that its rows times the G heads of a group fill the block's MMA
    rows); sequence b owns ``cdiv(q_len[b], block_rows)`` tiles, in order,
    and slot x of the grid takes the x-th tile of the step (slots past the
    last exit). Split z of a tile walks its keys ``lo + z * split_len`` ..
    ``+ split_len - 1`` (``tile_range``), a whole number of ``kv_tile``
    tokens."""

    block_rows: int
    tile_slots: int
    kv_tile: int
    split_len: int
    splits: int

    def tiles(self, cu_seqlens_q: list[int]) -> list[tuple[int, int]]:
        """The step's (sequence, tile) pairs in slot order, as the kernel
        finds them (``find_tile``)."""
        return [(b, i) for b in range(len(cu_seqlens_q) - 1)
                for i in range(cdiv(cu_seqlens_q[b + 1] - cu_seqlens_q[b], self.block_rows))]

    def tile_range(self, q_len: int, seq_len: int, tile: int, causal: bool, window: int) -> tuple[int, int, int]:
        """(query rows, lo, hi) of one tile: its rows and the keys [lo, hi)
        they see (``tile_of``): from the first row's window start (0 without
        a window) to the last row's position (causal) or ``seq_len``."""
        rows = min(self.block_rows, q_len - tile * self.block_rows)
        first = seq_len - q_len + tile * self.block_rows
        hi = max(min(first + rows if causal else seq_len, seq_len), 0)
        lo = max(first - window + 1, 0) if window > 0 else 0
        return rows, lo, hi

    def split_range(self, lo: int, hi: int, split: int) -> tuple[int, int]:
        """Keys [start, end) that split ``split`` of a tile walks; empty
        (start >= end) past the tile's keys."""
        start = lo + split * self.split_len
        return start, min(start + self.split_len, hi)

    def workspace_shapes(self, total_q: int, num_q_heads: int, head_size: int) -> tuple[tuple, tuple] | None:
        """The splits' f32 accumulators and (max, sum) pairs; none with one split."""
        if self.splits == 1:
            return None
        return (self.splits, total_q, num_q_heads, head_size), (self.splits, total_q, num_q_heads, 2)


def varlen_tile_plan(
    total_q: int, batch: int, max_pages: int, page_size: int, num_q_heads: int, num_kv_heads: int, head_size: int,
    causal: bool, window: int, num_sms: int, ring_pages: int = 0,
) -> VarlenTilePlan:
    """K7's tiles and splits from shapes only. A step has at most
    ``cdiv(total_q, block_rows) + batch`` (sequence, tile) pairs. A tile's
    keys span at most the block table's ``max_pages * page_size`` tokens,
    and under a causal window ``window + block_rows - 1``. Under a ring
    (``ring_pages > 0``) the window alone bounds the span (a tile's true
    pages may outnumber the table): ``window + block_rows - 1`` causal,
    ``window + total_q - 1`` otherwise, so a rolling engine and an
    unbounded one with the same window run the same plan. The splits aim at
    two waves of ``BLOCKS_PER_SM`` blocks on each of ``num_sms`` SMs when
    every row belongs to a full tile, walk at least ``MIN_SPLIT_TOKENS``
    keys (fewer splits when the span is short) and are at most
    ``MAX_SPLITS``."""
    group = num_q_heads // num_kv_heads
    block_rows = TILE_MMA_ROWS // group
    tile = kv_tile(head_size)
    span = max_pages * page_size
    if ring_pages > 0:
        span = window + (block_rows if causal else total_q) - 1
    elif causal and window > 0:
        span = min(span, window + block_rows - 1)
    live = max(cdiv(total_q, block_rows) * num_kv_heads, 1)
    split_len = round_up(max(cdiv(span, cdiv(2 * BLOCKS_PER_SM * num_sms, live)), MIN_SPLIT_TOKENS), tile)
    split_len = max(split_len, round_up(cdiv(span, MAX_SPLITS), tile))
    return VarlenTilePlan(block_rows=block_rows, tile_slots=cdiv(total_q, block_rows) + batch, kv_tile=tile,
                          split_len=split_len, splits=max(cdiv(span, split_len), 1))


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
    ring_pages: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of K7 on any device (through the ring with
    ``ring_pages``). Padding rows are zeros."""
    out = _varlen_reference(
        query, key_caches[layer_idx], value_caches[layer_idx], cu_seqlens_q, seq_lens, block_table, scale, causal,
        softcap, window_size, q_scale, k_scale, v_scale, ring_pages,
    )
    return out.to(query.dtype)


def _varlen_cuda(
    query, key_caches, value_caches, cu_seqlens_q, seq_lens, block_table, scale, causal, layer_idx, softcap,
    window_size, q_scale, k_scale, v_scale, ring_pages,
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
    batch, max_pages = block_table.shape
    if seq_lens.shape != (batch,) or cu_seqlens_q.shape != (batch + 1,):
        msg = (f"varlen_attention kernel: seq_lens {tuple(seq_lens.shape)} and cu_seqlens_q "
               f"{tuple(cu_seqlens_q.shape)} for a block table of {batch} rows")
        raise ValueError(msg)
    k_layer, v_layer = layer_pointers(key_caches, value_caches, layer_idx)
    plan = varlen_tile_plan(total_q, batch, max_pages, page_size, num_q_heads, num_kv_heads, head_size, causal,
                            window_size, sm_count(query.device.index), ring_pages)
    shapes = plan.workspace_shapes(total_q, num_q_heads, head_size) if query.dtype != torch.float32 else None
    part_acc, part_ml = (None, None) if shapes is None else (
        torch.empty(shape, dtype=torch.float32, device=query.device) for shape in shapes
    )
    out = torch.empty_like(query)
    fn = kernel_function("conch_varlen_attention", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ))
    code = fn(
        query.data_ptr(), out.data_ptr(), k_layer, v_layer, cu_seqlens_q.data_ptr(), seq_lens.data_ptr(),
        block_table.data_ptr(), total_q, batch, max_pages, num_q_heads, num_kv_heads,
        page_size, head_size, scale * q_scale * k_scale, softcap, window_size, ring_pages, int(causal), v_scale,
        dtype_code(query, FLOAT_DTYPES), storage_code(key_caches), plan.block_rows, plan.tile_slots, plan.split_len,
        plan.splits,
        None if part_acc is None else part_acc.data_ptr(), None if part_ml is None else part_ml.data_ptr(),
        copy_bytes(head_size * query.element_size(), query.data_ptr()),
        copy_bytes(head_size * key_caches.element_size(), k_layer, v_layer), stream_of(query),
    )
    check_launch("conch_varlen_attention", code)
    varlen_attention_launcher.launches += 1
    if ring_pages > 0:
        varlen_attention_launcher.ring_launches += 1
    if query.dtype == torch.float16:
        varlen_attention_launcher.f16_launches += 1
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
    ring_pages: int = 0,  # > 0: rolling KV, true page i at table entry i % ring_pages (needs a window)
) -> torch.Tensor:
    """Attention of ragged queries over layer ``layer_idx`` of the pool.

    The queries of sequence b are rows ``cu_seqlens_q[b]:cu_seqlens_q[b+1]``
    and are its trailing tokens: row j sits at KV position
    ``seq_lens[b] - q_len[b] + j``. Rows past ``cu_seqlens_q[B]`` are
    padding and come out zero. Under a ring the table's first
    ``ring_pages`` entries hold position ``p`` at slot ``p % (ring_pages *
    page_size)``; the ring must cover the window and the step's writes.
    ``launches`` counts kernel launches (``ring_launches`` those over a ring,
    ``f16_launches`` those of f16 queries).
    """
    check_ring(ring_pages, window_size, block_table.shape[1], key_caches.shape[3])
    args = (
        query, key_caches, value_caches, cu_seqlens_q, seq_lens, block_table, scale, causal, layer_idx, softcap,
        window_size, q_scale, k_scale, v_scale, ring_pages,
    )
    if query.device.type == "cpu":
        return varlen_attention_plain(*args)
    return _varlen_cuda(*args)


varlen_attention_launcher.launches = 0
varlen_attention_launcher.ring_launches = 0  # the launches over a rolling-KV ring
varlen_attention_launcher.f16_launches = 0  # the launches of f16 queries
