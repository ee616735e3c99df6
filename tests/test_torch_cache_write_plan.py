# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""K2's launch plan (``conch_tpu_torch/kernels/cache/reshape_and_cache.py:
cache_write_plan``), which the wrapper computes from shapes in Python and
the CUDA kernel follows (``csrc/reshape_and_cache.cu``). Each test walks
the kernel's mapping as the kernel does (row r of block b is ``b *
rows_per_block + r``: token ``r // (2 KH)``, head ``r // 2 % KH``, V when r
is odd; its threads walk the row's chunks from their lane in steps of
``threads_per_row``; a row whose slot is negative returns) and checks, at
the served shapes (Llama-3-8B's KH 8 / D 128, Gemma-2-2B's 4 / 256),
``chip_smoke.check_cache_write_options``' heads and ragged ones:

- every (live token, head, element) of k and v lands once on its cache
  entry ``[slot // ps, head, slot % ps]``, and nothing of an idle token;
- the vector path is taken only when every load and store it makes is
  aligned to its width (16 bytes in, 4 to 16 out);
- Llama's 8- and 32-token decode steps spread over enough blocks;
- the plan takes shapes only.
"""

import inspect
import itertools

import numpy as np
import pytest

from conch_tpu_torch.kernels.cache.reshape_and_cache import (
    MAX_THREADS,
    SCALAR,
    VECTOR,
    cache_write_plan,
)

# (KH, D): Llama-3-8B, Gemma-2-2B, a single head of 64, D 80 (not a power
# of two), D 34 (not a whole number of vectors).
HEADS = [(8, 128), (4, 256), (1, 64), (2, 80), (3, 34)]
TOKENS = [1, 7, 8, 32, 130, 540]
# Row strides of k and v: contiguous (T, KH, D), slices of a fused qkv
# block (QH = 4 KH), and fused rows one element longer (misaligned rows).
LAYOUTS = ["contiguous", "fused", "misaligned"]
PS, PAGES, LAYERS, LAYER = 16, 80, 3, 1


def _strides(kh: int, d: int, layout: str) -> tuple[int, int]:
    if layout == "contiguous":
        return kh * d, kh * d
    fused = 6 * kh * d + (layout == "misaligned")
    return fused, fused


def _slots(rng, tokens: int) -> np.ndarray:
    """Distinct slots from the first 2 * tokens + PS, so that tokens share
    pages, with about a third of the tokens idle (-1)."""
    slots = rng.choice(2 * tokens + PS, size=tokens, replace=False)
    slots[rng.random(tokens) < 1 / 3] = -1
    return slots


def _walk(plan, slots: np.ndarray, kh: int, d: int):
    """The kernel's live rows as it walks them: each row's token, head and
    whether it is V, the element where its cache row starts (layer LAYER of
    a pool of PAGES pages), its chunks' first elements within the row, and
    the elements its threads write."""
    tokens = len(slots)
    rows = 2 * tokens * kh
    r = (np.arange(plan.grid)[:, None] * plan.rows_per_block + np.arange(plan.rows_per_block)[None]).ravel()
    assert (np.bincount(r, minlength=rows)[:rows] == 1).all()  # every row in one block's slot
    r = r[r < rows]
    t, h, is_v = r // 2 // kh, r // 2 % kh, r % 2 == 1
    live = slots[t] >= 0
    r, t, h, is_v = r[live], t[live], h[live], is_v[live]
    slot = slots[t]
    page, entry = slot // PS, slot % PS
    chunks = d // plan.vec
    lanes = np.arange(plan.threads_per_row)
    j = (lanes[:, None] + np.arange(plan.items)[None] * plan.threads_per_row).ravel()
    j = j[j < chunks]
    assert len(j) == chunks and len(np.unique(j)) == chunks  # every chunk on one lane, within items steps
    elem = (j[:, None] * plan.vec + np.arange(plan.vec)[None]).ravel()
    dst_row = LAYER * PAGES * kh * PS * d + ((page * kh + h) * PS + entry) * d
    return t, h, is_v, dst_row, j * plan.vec, elem


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("heads", HEADS, ids=lambda h: "x".join(map(str, h)))
def test_cache_write_plan_covers_every_live_element_once(heads, itemsize, layout):
    kh, d = heads
    k_stride, v_stride = _strides(kh, d, layout)
    rng = np.random.default_rng(kh * 1000 + d)
    for tokens in TOKENS:
        plan = cache_write_plan(tokens, kh, d, itemsize, k_stride, v_stride, True)
        assert 1 <= plan.threads_per_row * plan.rows_per_block <= MAX_THREADS
        slots = _slots(rng, tokens)
        t, h, is_v, dst_row, _, elem = _walk(plan, slots, kh, d)
        for v in (False, True):
            written = np.zeros((LAYERS * PAGES * kh * PS * d,), np.int64)
            np.add.at(written, (dst_row[is_v == v][:, None] + elem[None]).ravel(), 1)
            expected = np.zeros((LAYERS, PAGES, kh, PS, d), np.int64)
            for s in slots[slots >= 0]:
                expected[LAYER, s // PS, :, s % PS, :] += 1
            assert (written.reshape(expected.shape) == expected).all(), (tokens, plan)
            # Every live (token, head) row of k and v, and no idle token's.
            pairs = np.zeros((tokens, kh), np.int64)
            np.add.at(pairs, (t[is_v == v], h[is_v == v]), 1)
            assert (pairs == (slots >= 0)[:, None]).all()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("cache_itemsize", [1, 2, 4])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("heads", HEADS, ids=lambda h: "x".join(map(str, h)))
def test_cache_write_vector_path_only_on_aligned_addresses(heads, itemsize, cache_itemsize, layout):
    """Every 16-byte load (k and v at their row strides) and every store of
    ``vec`` cache elements starts on a multiple of its width when the plan
    takes the vector path (tensor bases on 16-byte boundaries, as
    ``aligned`` says)."""
    kh, d = heads
    k_stride, v_stride = _strides(kh, d, layout)
    for tokens, aligned in itertools.product((1, 8, 33), (True, False)):
        plan = cache_write_plan(tokens, kh, d, itemsize, k_stride, v_stride, aligned)
        if plan.path != VECTOR:
            assert plan.path == SCALAR and plan.vec == 1
            continue
        assert aligned and plan.vec * itemsize == 16 and d % plan.vec == 0
        slots = np.arange(tokens) * 5
        t, h, is_v, dst_row, starts, _ = _walk(plan, slots, kh, d)
        src_row = np.where(is_v, t * v_stride, t * k_stride) + h * d
        assert ((src_row[:, None] + starts[None]) * itemsize % 16 == 0).all()
        width = plan.vec * cache_itemsize
        assert ((dst_row[:, None] + starts[None]) * cache_itemsize % width == 0).all()


def test_cache_write_plan_spreads_a_decode_step():
    """Llama-3-8B's decode step (8 tokens, KH 8, D 128, bf16, v a slice of
    the fused qkv block) runs on 64 blocks of one warp, each row's 16
    threads one 16-byte chunk; the int4 engine's step padded to 32 tokens
    on the card's 132 SMs or more; Gemma-2-2B's (KH 4, D 256) a warp a row."""
    fused = (32 + 2 * 8) * 128
    plan = cache_write_plan(8, 8, 128, 2, 8 * 128, fused, True)
    assert plan.path == VECTOR and plan.items == 1 and plan.threads_per_row == 16 and plan.grid == 64
    assert cache_write_plan(32, 8, 128, 2, 8 * 128, fused, True).grid >= 132
    gemma = cache_write_plan(8, 4, 256, 2, 4 * 256, (8 + 2 * 4) * 256, True)
    assert gemma.path == VECTOR and gemma.threads_per_row == 32 and gemma.items == 1 and gemma.grid == 64


def test_cache_write_plan_takes_shapes_only():
    assert list(inspect.signature(cache_write_plan).parameters) == [
        "num_tokens", "num_kv_heads", "head_size", "itemsize", "k_row_stride", "v_row_stride", "aligned",
    ]
    assert cache_write_plan(8, 8, 128, 2, 1024, 6144, True) == cache_write_plan(8, 8, 128, 2, 1024, 6144, True)
    assert cache_write_plan(0, 8, 128, 2, 1024, 6144, True).grid == 0
