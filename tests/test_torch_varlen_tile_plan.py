# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""K7's work list and split plan (``conch_tpu_torch/kernels/attention/
varlen_attention.py:varlen_tile_plan``), which the wrapper computes from
shapes in Python and the CUDA kernel follows (``csrc/varlen_attention.cu``:
``find_tile``, ``tile_of``, ``live_splits``). Held on the CPU, at the
served engines' prefill steps and small ones, over ragged ``cu_seqlens_q``
with zero-length sequences, decode rows mixed in and padding rows:

- the (sequence, tile) pairs fit the grid's tile slots, and every packed
  row belongs to exactly one tile of its own sequence (padding rows to
  none);
- every key a row sees, causal or not, with or without a window, falls in
  its tile's key range, and that range falls in exactly one split; no
  split reaches a key no row of its tile sees, and the merge's live count
  is the number of splits with keys;
- a tile's rows times the GQA group fit the block's 64 MMA rows, a split
  is a whole number of K/V tiles, and the splits stay within the kernel's
  ``MAX_SPLITS``;
- the plan takes shapes only (plain integers), so two steps of one shape
  share a plan whatever their lengths.
"""

import numpy as np
import pytest

from conch_tpu_torch.kernels.attention.varlen_attention import (
    BLOCKS_PER_SM,
    MAX_SPLITS,
    TILE_MMA_ROWS,
    VarlenTilePlan,
    kv_tile,
    varlen_tile_plan,
)

H100_SMS = 132
PAGE = 16
# (total_q, batch, table pages, QH, KH, D): the int4 Llama engine's 512-row
# step and the kernel checks' 128-row one, Gemma-2-2B's served step, a
# decode-sized step, the option sweep's shapes (G 1 / 4 / 8, D 34), and
# GQA group 7: Qwen2-7B's served 512-row step (28 query heads over 4, 9
# rows a tile) and the sweep's group-7 shape.
SHAPES = [
    (512, 32, 256, 32, 8, 128), (128, 8, 64, 32, 8, 128), (512, 16, 384, 8, 4, 256), (8, 8, 64, 32, 8, 128),
    (64, 7, 64, 2, 2, 64), (64, 7, 64, 8, 2, 34), (64, 7, 64, 16, 2, 256), (40, 3, 4, 6, 2, 128),
    (512, 8, 128, 28, 4, 128), (64, 7, 64, 14, 2, 128),
]
# Rolling KV (total_q, batch, QH, KH, D, window): Mistral-7B's 512-row step
# under its 4096 window, small steps at window 48 and group 7. The ring is
# the engine's: ceil((window + total_q) / page) + 1 pages.
RING_SHAPES = [(512, 8, 32, 8, 128, 4096), (64, 3, 4, 2, 64, 48), (32, 4, 14, 2, 128, 48), (128, 8, 28, 4, 128, 500)]


def _ragged(rng, total_q: int, batch: int, capacity: int) -> tuple[list[int], list[int]]:
    """q_lens and seq_lens of one step: a decode row, a zero-length sequence
    between live ones, zero-length padding sequences at the end, and padding
    rows past cu_seqlens_q[batch]; every q_len <= seq_len <= capacity."""
    q_lens = [0] * batch
    budget = int(rng.integers(total_q // 2, total_q + 1))
    live = max(1, min(batch - 1, int(rng.integers(1, batch + 1))))
    for b in range(live):
        if b == 1 and live > 2:
            continue  # zero-length, between live sequences
        q = 1 if b == 0 else int(rng.integers(1, max(2, budget)))
        q = min(q, budget, capacity)
        q_lens[b] = q
        budget -= q
    seq_lens = [int(rng.integers(q, capacity + 1)) if q else 0 for q in q_lens]
    return q_lens, seq_lens


def _cu(q_lens: list[int]) -> list[int]:
    return [0, *np.cumsum(q_lens).tolist()]


def _row_keys(seq_len: int, q_len: int, j: int, causal: bool, window: int) -> tuple[int, int]:
    """Keys [start, end) that query j of a sequence sees (the plain version's mask)."""
    pos = seq_len - q_len + j
    end = pos + 1 if causal else seq_len
    start = max(pos - window + 1, 0) if window > 0 else 0
    return start, end


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 1, 37, 500, 4096])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_every_visible_key_in_one_split_of_its_tile(shape, window, causal):
    total_q, batch, pages, qh, kh, d = shape
    plan = varlen_tile_plan(total_q, batch, pages, PAGE, qh, kh, d, causal, window, H100_SMS)
    assert plan.block_rows * (qh // kh) <= TILE_MMA_ROWS
    assert plan.kv_tile == kv_tile(d) and plan.split_len % plan.kv_tile == 0
    assert 1 <= plan.splits <= MAX_SPLITS
    rng = np.random.default_rng(total_q * 31 + batch * 7 + window + causal)
    for _ in range(3):
        q_lens, seq_lens = _ragged(rng, total_q, batch, pages * PAGE)
        cu = _cu(q_lens)
        pairs = plan.tiles(cu)
        assert len(pairs) <= plan.tile_slots
        owner = {}
        for b, tile in pairs:
            rows, lo, hi = plan.tile_range(q_lens[b], seq_lens[b], tile, causal, window)
            assert 1 <= rows <= plan.block_rows
            keys = np.zeros(max(hi, 1), dtype=np.int64)
            live = 0
            for split in range(plan.splits):
                start, end = plan.split_range(lo, hi, split)
                if start < end:
                    live += 1
                    keys[start:end] += 1
            # The kernel's merge counts min(cdiv(hi - lo, split_len), splits) live splits.
            assert live == (min(-(-(hi - lo) // plan.split_len), plan.splits) if hi > lo else 0)
            seen = np.zeros_like(keys)
            for i in range(rows):
                j = tile * plan.block_rows + i
                row = cu[b] + j
                assert row not in owner and cu[b] <= row < cu[b + 1]
                owner[row] = (b, tile)
                start, end = _row_keys(seq_lens[b], q_lens[b], j, causal, window)
                assert lo <= start and end <= hi, "a row sees a key outside its tile's range"
                assert np.all(keys[start:end] == 1), "a visible key in no split, or in two"
                seen[start:end] = 1
            assert np.all(keys[:lo] == 0) and np.all(keys[hi:] == 0)
            assert np.all(seen[lo:hi] == 1), "the tile walks a key none of its rows sees"
        assert sorted(owner) == list(range(cu[-1])), "a real row in no tile (or a padding row in one)"


@pytest.mark.parametrize("shape", RING_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ring_tiles_walk_the_window_band(shape):
    """Under a ring, sequences run to three times the ring's tokens; a
    tile's key range [lo, hi) starts at its first row's window start, fits
    the ring (no two of its keys share a ring slot) and holds every key its
    rows see, each in one split; the plan equals a wide linear table's."""
    total_q, batch, qh, kh, d, window = shape
    ring = -(-(window + total_q) // PAGE) + 1
    plan = varlen_tile_plan(total_q, batch, ring, PAGE, qh, kh, d, True, window, H100_SMS, ring)
    assert plan == varlen_tile_plan(total_q, batch, 3 * ring, PAGE, qh, kh, d, True, window, H100_SMS)
    assert plan.block_rows * (qh // kh) <= TILE_MMA_ROWS
    rng = np.random.default_rng(total_q + window)
    for _ in range(3):
        q_lens, seq_lens = _ragged(rng, total_q, batch, 3 * ring * PAGE)
        cu = _cu(q_lens)
        for b, tile in plan.tiles(cu):
            rows, lo, hi = plan.tile_range(q_lens[b], seq_lens[b], tile, True, window)
            assert hi - lo <= ring * PAGE, "two keys of a tile share a ring slot"
            keys = np.zeros(max(hi, 1), dtype=np.int64)
            for split in range(plan.splits):
                start, end = plan.split_range(lo, hi, split)
                keys[start:end] += 1
            for i in range(rows):
                start, end = _row_keys(seq_lens[b], q_lens[b], tile * plan.block_rows + i, True, window)
                assert lo == max(seq_lens[b] - q_lens[b] + tile * plan.block_rows - window + 1, 0)
                assert lo <= start and end <= hi and np.all(keys[start:end] == 1)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tile_slots_bound_any_step(shape):
    """cdiv(total_q, BM) + batch slots hold the pairs of the worst split of
    total_q rows over the batch: every sequence one row past a tile."""
    total_q, batch, pages, qh, kh, d = shape
    plan = varlen_tile_plan(total_q, batch, pages, PAGE, qh, kh, d, True, 0, H100_SMS)
    bm = plan.block_rows
    assert plan.tile_slots == -(-total_q // bm) + batch
    q_lens = [min(bm + 1, total_q // batch)] * batch
    q_lens[0] += total_q - sum(q_lens)
    assert len(plan.tiles(_cu(q_lens))) <= plan.tile_slots
    assert plan.tiles(_cu([0] * batch)) == []


def test_splits_fill_the_card_at_gemma_prefill():
    """Gemma-2-2B's 512-row step (16 tiles of 32 rows over 4 KV heads) splits
    the walk so the tiles' blocks fill about two waves of two blocks on each
    of 132 SMs, with and without the 4096 window; Llama's short 128-row step
    keeps splits of at least 128 keys."""
    for window in (0, 4096):
        plan = varlen_tile_plan(512, 16, 384, PAGE, 8, 4, 256, True, window, H100_SMS)
        assert plan.block_rows == 32 and plan.kv_tile == 32
        assert 16 * 4 * plan.splits >= 2 * BLOCKS_PER_SM * H100_SMS
        assert plan.splits * plan.split_len >= (min(384 * PAGE, window + 31) if window else 384 * PAGE)
    llama = varlen_tile_plan(128, 8, 64, PAGE, 32, 8, 128, True, 0, H100_SMS)
    assert llama.block_rows == 16 and llama.split_len >= 128


def test_plan_reads_shapes_only():
    """The plan is a function of integers: one shape, one plan, and its
    workspace shapes follow total_q, the heads and the head size."""
    a = varlen_tile_plan(512, 16, 384, PAGE, 8, 4, 256, True, 0, H100_SMS)
    assert a == varlen_tile_plan(512, 16, 384, PAGE, 8, 4, 256, True, 0, H100_SMS)
    assert a.workspace_shapes(512, 8, 256) == ((a.splits, 512, 8, 256), (a.splits, 512, 8, 2))
    one = VarlenTilePlan(block_rows=32, tile_slots=4, kv_tile=64, split_len=256, splits=1)
    assert one.workspace_shapes(8, 4, 64) is None
