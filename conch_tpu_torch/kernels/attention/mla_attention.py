# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Multi-head latent attention: the CUDA kernel (K11) and its plain version.

The kernel is ``csrc/mla_attention.cu``; it replaces
``conch_tpu/kernels/attention/mla_attention.py:_mla_dma_kernel`` and its
launcher. It is bound by bytes at decode and by operations at prefill.
bf16 queries run a warp-specialised tensor-core kernel: a block owns one
(sequence, tile of 64 flattened (token, head) rows) pair and one split of
the tile's keys; a producer warpgroup streams the keys through a ring of
shared-memory stages and two consumer warpgroups multiply on ``wgmma``.
``mla_tile_plan`` sets the tiles, the grid's tile slots, the ring and the
splits from shapes alone, never from the values of ``cu_seqlens_q`` or
``seq_lens``, so the wrapper reads no tensor value on the host; the
kernel finds each block's pair on the device. f32 queries run a
CUDA-core kernel over the same plan. int8 and float8_e4m3fn latent caches
(quantized on store, ``kv_scale`` folded into the score scale and the
output) are read by bf16 or f32 queries: bf16 queries widen their rows to
bf16 exactly as they enter shared memory. ``mla_attention_launcher``
takes the plain version for CPU tensors only; on CUDA it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

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

# The kernels' constants (csrc/mla_attention.cu: kRows, kKeys, kMaxStages,
# kMaxSplits, kMaxPacked, kSmemLimit, kSmemSlack).
TILE_ROWS = 64  # MMA rows a tile: flattened (token, head) rows of one sequence
KV_TILE = 32  # keys a ring stage
MAX_STAGES = 4
MAX_SPLITS = 64
MAX_LATENT = 512
MAX_PACKED = 896  # bf16 queries: two stages beside the Q tile
MIN_SPLIT = 128  # fewest keys a split walks (four stages)
SMEM_LIMIT = 232448
SMEM_SLACK = 1024 + 2 * MAX_STAGES * 8


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


@dataclasses.dataclass(frozen=True)
class MlaTilePlan:
    """K11's grid (``tile_slots``, ``splits``) and ring.

    A tile is ``rows`` consecutive rows of a sequence's queries flattened
    to (token, head) rows (row r is token r // heads, head r % heads), so a
    sequence of q_len tokens owns ``cdiv(q_len * heads, rows)`` tiles, in
    order, and slot x of the grid takes the x-th tile of the step (slots
    past the last exit). A tile's keys are [0, hi) up to its last row's
    limit (``tile_range``); split z walks ``z * split_len`` .. ``+ split_len
    - 1`` of them (``split_range``), a whole number of ``kv_tile`` keys.
    ``stages``: the bf16 kernel's ring stages beside the Q tile."""

    rows: int
    tile_slots: int
    kv_tile: int
    stages: int
    split_len: int
    splits: int
    heads: int
    causal: bool

    def tiles(self, cu_seqlens_q: list[int]) -> list[tuple[int, int]]:
        """The step's (sequence, tile) pairs in slot order, as the kernel
        finds them (``find_tile``)."""
        return [(b, i) for b in range(len(cu_seqlens_q) - 1)
                for i in range(cdiv((cu_seqlens_q[b + 1] - cu_seqlens_q[b]) * self.heads, self.rows))]

    def tile_range(self, q_len: int, seq_len: int, tile: int) -> tuple[int, int, int]:
        """(first flattened row, rows, hi) of one tile (``tile_of``): its
        rows and the keys [0, hi) its last row sees, causal or not."""
        row0 = tile * self.rows
        rows = min(self.rows, q_len * self.heads - row0)
        last = (row0 + rows - 1) // self.heads
        hi = max(min(seq_len - q_len + last + 1 if self.causal else seq_len, seq_len), 0)
        return row0, rows, hi

    def split_range(self, hi: int, split: int) -> tuple[int, int]:
        """Keys [start, end) that split ``split`` of a tile walks; empty
        (start >= end) past the tile's keys."""
        start = split * self.split_len
        return start, min(start + self.split_len, hi)

    def live_splits(self, hi: int) -> int:
        """Splits of a tile with keys to walk, which the merge reads (``live_splits``)."""
        return min(cdiv(hi, self.split_len), self.splits) if hi > 0 else 0

    def workspace_shapes(self, total_q: int, latent: int) -> tuple[tuple, tuple] | None:
        """The splits' f32 accumulators and (max, sum) pairs; none with one split."""
        if self.splits == 1:
            return None
        return (self.splits, total_q, self.heads, latent), (self.splits, total_q, self.heads, 2)


def ring_stages(packed: int) -> int:
    """Stages of KV_TILE keys that fit beside a Q tile of TILE_ROWS rows of
    ``packed`` bf16 values, at most MAX_STAGES (fewer than 2 past MAX_PACKED)."""
    q_bytes, stage_bytes = TILE_ROWS * packed * 2, KV_TILE * packed * 2
    return min(MAX_STAGES, (SMEM_LIMIT - SMEM_SLACK - q_bytes) // stage_bytes)


def mla_tile_plan(
    total_q: int, batch: int, max_pages: int, page_size: int, heads: int, packed: int, latent: int, causal: bool,
    num_sms: int,
) -> MlaTilePlan:
    """K11's tiles, ring and splits from shapes only. A step has at most
    ``cdiv(total_q * heads, TILE_ROWS) + batch`` (sequence, tile) pairs,
    and a tile's keys span at most the block table's ``max_pages *
    page_size``. The splits aim at two waves of working blocks, one block
    on each of ``num_sms`` SMs, when every row belongs to a full tile; a
    causal tile's keys end anywhere up to the table's length, so it is
    counted as working in half its splits (a non-causal one in all). They
    walk at least MIN_SPLIT keys (fewer splits when the span is short) and
    are at most MAX_SPLITS."""
    if latent % 128 or not 0 < latent <= min(MAX_LATENT, packed) or packed % 128:
        msg = f"mla_tile_plan: latent {latent} and packed {packed} must be multiples of 128, latent <= {MAX_LATENT}"
        raise ValueError(msg)
    span = max(max_pages * page_size, 1)
    live = max(cdiv(total_q * heads, TILE_ROWS), 1)
    wanted = cdiv(2 * num_sms, live) * (2 if causal else 1)
    split_len = round_up(max(cdiv(span, wanted), MIN_SPLIT), KV_TILE)
    split_len = max(split_len, round_up(cdiv(span, MAX_SPLITS), KV_TILE))
    tile_slots, splits = cdiv(total_q * heads, TILE_ROWS) + batch, cdiv(span, split_len)
    return MlaTilePlan(rows=TILE_ROWS, tile_slots=tile_slots, kv_tile=KV_TILE, stages=ring_stages(packed),
                       split_len=split_len, splits=splits, heads=heads, causal=causal)


def _mla_cuda(query, kv_cache, cu_seqlens_q, max_seqlen_q, seq_lens, block_table, scale, latent, causal, kv_scale):
    require_cuda(query, kv_cache, cu_seqlens_q, seq_lens, block_table)
    if kv_cache.dtype not in QUANTIZED_CACHE_DTYPES and query.dtype != kv_cache.dtype:
        msg = f"mla_attention kernel: query {query.dtype} and cache {kv_cache.dtype} must share a dtype"
        raise ValueError(msg)
    packed = query.shape[-1]
    if latent % 128 or latent > MAX_LATENT or (query.dtype == torch.bfloat16 and packed > MAX_PACKED):
        msg = (f"mla_attention kernel: latent must be a multiple of 128 up to {MAX_LATENT} and, under bf16 queries, "
               f"packed at most {MAX_PACKED}; got {latent} and {packed}")
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
    total_q, heads, _ = query.shape
    _, page_size, _ = kv_cache.shape
    batch, max_pages = block_table.shape
    plan = mla_tile_plan(total_q, batch, max_pages, page_size, heads, packed, latent, causal,
                         sm_count(query.device.index))
    shapes = plan.workspace_shapes(total_q, latent)
    part_acc, part_ml = (None, None) if shapes is None else (
        torch.empty(shape, dtype=torch.float32, device=query.device) for shape in shapes
    )
    out = torch.empty((total_q, heads, latent), dtype=query.dtype, device=query.device)
    fn = kernel_function("conch_mla_attention", (
        *(ctypes.c_void_p,) * 8, *(ctypes.c_int,) * 15, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ))
    code = fn(
        query.data_ptr(), out.data_ptr(), kv_cache.data_ptr(), cu_seqlens_q.data_ptr(), seq_lens.data_ptr(),
        block_table.data_ptr(), None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), total_q, batch, max_pages, heads, page_size, packed,
        latent, max_seqlen_q, int(causal), plan.rows, plan.tile_slots, plan.kv_tile, plan.stages, plan.split_len,
        plan.splits, scale * kv_scale, kv_scale, dtype_code(query), storage_code(kv_cache), stream_of(query),
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
