# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""K11's work list and split plan (``conch_tpu_torch/kernels/attention/
mla_attention.py:mla_tile_plan``), which the wrapper computes from shapes
in Python and the CUDA kernel follows (``csrc/mla_attention.cu``:
``find_tile``, ``tile_of``, ``live_splits``, ``store2``,
``zero_padding_rows``). Held on the CPU at DeepSeek-V2-Lite's served
decode and prefill steps, ``chip_smoke.py``'s K11 cases and small ragged
steps (other head counts among them), over ragged ``cu_seqlens_q`` with
zero-length sequences, idle decode rows and padding rows:

- the (sequence, tile) pairs fit the grid's tile slots, and every (token,
  head) row falls in exactly one tile of its own sequence (padding rows
  in none);
- every padding row is written once, by the last sequence's token that
  the TPU launcher's clamped gather gives it, or as a zero row where that
  token does not exist;
- every key a row sees, causal or not, falls in its tile's key range, and
  that range in exactly one split; the merge's live count is the number
  of splits with keys;
- a split is a whole number of ring stages, the splits stay within the
  kernel's ``MAX_SPLITS``, and the ring fits beside the Q tile;
- the plan takes shapes only (plain integers), so two steps of one shape
  share a plan whatever their lengths.
"""

import numpy as np
import pytest

from conch_tpu_torch.kernels.attention.mla_attention import (
    KV_TILE,
    MAX_PACKED,
    MAX_SPLITS,
    MAX_STAGES,
    MIN_SPLIT,
    SMEM_LIMIT,
    SMEM_SLACK,
    TILE_ROWS,
    MlaTilePlan,
    mla_tile_plan,
    ring_stages,
)

H100_SMS = 132
PAGE = 16
PACKED, LATENT = 640, 512  # DeepSeek-V2-Lite's packed rows and latent
# (total_q, batch, table pages, heads): DeepSeek-V2-Lite's served decode
# (16 rows) and 512-row prefill steps over 128 pages, chip_smoke's K11
# decode (batch 8) and prefill cases over 256 pages, the CPU tests' steps
# (8 heads), and steps with 1, 3, 24 and 128 heads.
SHAPES = [
    (16, 16, 128, 16), (512, 16, 128, 16), (8, 8, 256, 16), (512, 16, 256, 16), (51, 4, 16, 8), (64, 6, 16, 8),
    (40, 5, 8, 1), (20, 3, 8, 3), (33, 4, 12, 24), (10, 4, 8, 128),
]


def _ragged(rng, total_q: int, batch: int, capacity: int) -> tuple[list[int], list[int]]:
    """q_lens and seq_lens of one step: an idle decode row (seq_len 0), a
    zero-length sequence between live ones, zero-length padding sequences
    at the end, and padding rows past cu_seqlens_q[batch]; every q_len <=
    seq_len <= capacity."""
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
    if batch > 2 and q_lens[0] == 1:
        seq_lens[0] = 0  # an idle decode row: its token sees no key
    return q_lens, seq_lens


def _cu(q_lens: list[int]) -> list[int]:
    return [0, *np.cumsum(q_lens).tolist()]


def _row_keys(seq_len: int, q_len: int, j: int, causal: bool) -> int:
    """Keys [0, end) that query j of a sequence sees (the plain version's mask)."""
    return max(min(seq_len - q_len + j + 1 if causal else seq_len, seq_len), 0)


def _plan(shape, causal=True) -> MlaTilePlan:
    total_q, batch, pages, heads = shape
    return mla_tile_plan(total_q, batch, pages, PAGE, heads, PACKED, LATENT, causal, H100_SMS)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_every_row_in_one_tile_and_every_key_in_one_split(shape, causal):
    total_q, batch, pages, heads = shape
    plan = _plan(shape, causal)
    assert plan.rows == TILE_ROWS and plan.kv_tile == KV_TILE and plan.split_len % KV_TILE == 0
    assert 1 <= plan.splits <= MAX_SPLITS
    rng = np.random.default_rng(total_q * 31 + batch * 7 + heads + causal)
    for _ in range(3):
        q_lens, seq_lens = _ragged(rng, total_q, batch, pages * PAGE)
        cu = _cu(q_lens)
        pairs = plan.tiles(cu)
        assert len(pairs) <= plan.tile_slots
        owner = {}
        for b, tile in pairs:
            row0, rows, hi = plan.tile_range(q_lens[b], seq_lens[b], tile)
            assert 1 <= rows <= plan.rows and row0 == tile * plan.rows
            keys = np.zeros(max(hi, 1), dtype=np.int64)
            live = 0
            for split in range(plan.splits):
                start, end = plan.split_range(hi, split)
                if start < end:
                    live += 1
                    keys[start:end] += 1
            assert live == plan.live_splits(hi), "the merge would read another number of splits"
            seen = np.zeros_like(keys)
            for r in range(rows):
                flat = row0 + r
                token, head = divmod(flat, heads)
                row = (cu[b] + token, head)
                assert row not in owner and cu[b] + token < cu[b + 1]
                owner[row] = (b, tile)
                end = _row_keys(seq_lens[b], q_lens[b], token, causal)
                assert end <= hi, "a row sees a key past its tile's range"
                assert np.all(keys[:end] == 1), "a visible key in no split, or in two"
                seen[:end] = 1
            assert np.all(keys[hi:] == 0)
            assert np.all(seen[:hi] == 1), "the tile walks a key none of its rows sees"
        expected = {(t, h) for t in range(cu[-1]) for h in range(heads)}
        assert set(owner) == expected, "a real (token, head) row in no tile, or a padding row in one"


def _padding_writes(cu: list[int], max_seqlen_q: int, total_q: int) -> dict[int, list]:
    """What the kernel writes into each padding row: ``store2`` copies the
    last sequence's token i into row total + i (i < max_seqlen_q - 1) or
    into every row from total + i on (i = max_seqlen_q - 1);
    ``zero_padding_rows`` zeroes the rows whose token that sequence does
    not have (the merge computes the same sources)."""
    total, last = cu[-1], len(cu) - 2
    writes = {row: [] for row in range(total, total_q)}
    for i in range(cu[last + 1] - cu[last]):
        if i >= max_seqlen_q:
            continue
        end = min(total + i + 1, total_q) if i < max_seqlen_q - 1 else total_q
        for row in range(total + i, end):
            writes[row].append(("token", i))
    for row in range(total, total_q):
        if min(row - total, max_seqlen_q - 1) >= cu[last + 1] - cu[last]:
            writes[row].append(("zero", None))
    return writes


@pytest.mark.parametrize("above", [0, 5])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_padding_rows_follow_the_clamped_gather(shape, above):
    """Each padding row is written once: with the output of token
    min(row - total, max_seqlen_q - 1) of the last sequence, or zeros where
    it has no such token (the plain version's gather); ``max_seqlen_q`` at
    the real maximum or above it. The last sequence is real in half the
    steps and a zero-length padding sequence in the others."""
    total_q, batch, pages, _ = shape
    rng = np.random.default_rng(total_q + batch + above)
    for step in range(4):
        q_lens, _ = _ragged(rng, total_q, batch, pages * PAGE)
        if step % 2 and batch > 1:
            q_lens[-1] = int(rng.integers(1, max(2, total_q - sum(q_lens[:-1]) + 1)))
            q_lens[-1] = min(q_lens[-1], max(total_q - sum(q_lens[:-1]), 0))
        cu = _cu(q_lens)
        max_q = max(max(q_lens), 1) + above
        for row, got in _padding_writes(cu, max_q, total_q).items():
            i = min(row - cu[-1], max_q - 1)
            want = ("token", i) if cu[-2] + i < cu[-1] else ("zero", None)
            assert got == [want], f"padding row {row}: written {got}, the gather gives {want}"


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tile_slots_bound_any_step(shape):
    """cdiv(total_q * heads, 64) + batch slots hold the pairs of the worst
    split of total_q rows over the batch: every sequence a row past a tile."""
    total_q, batch, _, heads = shape
    plan = _plan(shape)
    assert plan.tile_slots == -(-total_q * heads // TILE_ROWS) + batch
    per = max(1, min(total_q // batch, -(-TILE_ROWS // heads) + 1))
    q_lens = [per] * batch
    q_lens[0] += max(total_q - sum(q_lens), 0)
    assert len(plan.tiles(_cu(q_lens))) <= plan.tile_slots
    assert plan.tiles(_cu([0] * batch)) == []


@pytest.mark.parametrize("packed", [128, 256, 512, 640, 768, 896])
def test_ring_fits_beside_the_q_tile(packed):
    """Two to four stages of 32 keys beside the 64-row Q tile within the
    227 KB a block may use: three at DeepSeek's packed 640."""
    stages = ring_stages(packed)
    assert 2 <= stages <= MAX_STAGES
    assert (packed // 64) * (TILE_ROWS * 128 + stages * KV_TILE * 128) + SMEM_SLACK <= SMEM_LIMIT
    if stages < MAX_STAGES:
        assert (packed // 64) * (TILE_ROWS * 128 + (stages + 1) * KV_TILE * 128) + SMEM_SLACK > SMEM_LIMIT
    assert ring_stages(640) == 3 and ring_stages(MAX_PACKED + 128) < 2


def test_decode_splits_fill_the_card():
    """DeepSeek-V2-Lite's decode steps split each sequence's walk into
    MIN_SPLIT keys, so that batch 8 at full table length would give more
    than two waves of working blocks; the 512-row prefill step, whose 128
    full tiles are one wave, splits its walks in six when causal (a causal
    tile works in half its splits, on average) and in three when not."""
    for total_q, pages in ((8, 256), (16, 128)):
        plan = _plan((total_q, total_q, pages, 16))
        assert plan.split_len == MIN_SPLIT and plan.splits * plan.split_len >= pages * PAGE
        assert total_q * plan.splits >= 2 * H100_SMS or plan.splits == pages * PAGE // MIN_SPLIT
    for causal, splits in ((True, 6), (False, 3)):
        prefill = _plan((512, 16, 128, 16), causal)
        assert prefill.splits == splits and prefill.splits * prefill.split_len >= 128 * PAGE


def test_plan_reads_shapes_only():
    """The plan is a function of integers: one shape, one plan, and its
    workspace shapes follow total_q, the heads and the latent width."""
    a = _plan((512, 16, 128, 16))
    assert a == _plan((512, 16, 128, 16))
    assert a.workspace_shapes(512, LATENT) == ((a.splits, 512, 16, LATENT), (a.splits, 512, 16, 2))
    one = MlaTilePlan(rows=64, tile_slots=4, kv_tile=32, stages=3, split_len=4096, splits=1, heads=16, causal=True)
    assert one.workspace_shapes(8, LATENT) is None and one.live_splits(0) == 0 and one.live_splits(4000) == 1


@pytest.mark.parametrize("latent,packed", [(64, 256), (640, 640), (128, 192), (0, 128)])
def test_plan_refuses_shapes_the_kernel_cannot_run(latent, packed):
    with pytest.raises(ValueError, match="multiples of 128"):
        mla_tile_plan(8, 8, 16, PAGE, 16, packed, latent, True, H100_SMS)
