# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""K5's and K10a's launch plans (``conch_tpu_torch/kernels/embedding/
rotary_embedding.py:rope_plan``, ``kernels/normalization/gemma_rms_norm.py:
gemma_norm_plan``), which the wrappers compute from shapes in Python and
the CUDA kernels follow (``csrc/rotary_embedding.cu``,
``csrc/gemma_rms_norm.cu``). Each test walks the kernel's thread-to-work
mapping as the kernel does and checks, at the served shapes (Llama-3-8B's
QH 32 / KH 8 / D 128 and Gemma-2-2B's 8 / 4 / 256 and hidden 2304 at
decode and prefill steps), ``chip_smoke.py``'s option cases and small
ragged ones:

- every (token, head, pair) of K5 and every tail element past rot_dim,
  and every element of every K10a row, is covered exactly once;
- the vector path is chosen only when every address it touches is 16-byte
  aligned (bases on 16-byte boundaries, as ``aligned`` says);
- at 8 tokens K5's grid has at least 64 blocks, and at 8 and 16 Gemma rows
  no K10a row sits on a single warp;
- blocks stay within the kernels' thread limits, and a row shares warps
  only in whole groups of lanes;
- the plans take shapes only (plain integers): one shape, one plan.
"""

import inspect
import itertools

import numpy as np
import pytest

from conch_tpu_torch.kernels.embedding.rotary_embedding import (
    MAX_THREADS as ROPE_MAX_THREADS,
)
from conch_tpu_torch.kernels.embedding.rotary_embedding import (
    SCALAR,
    VECTOR,
    rope_plan,
)
from conch_tpu_torch.kernels.normalization.gemma_rms_norm import (
    LOOPED_SCALAR,
    LOOPED_VECTOR,
    MAX_ITEMS,
    MAX_THREADS,
    REGISTER_THREADS,
    gemma_norm_plan,
)
from conch_tpu_torch.kernels.normalization.gemma_rms_norm import (
    SCALAR as NORM_SCALAR,
)
from conch_tpu_torch.kernels.normalization.gemma_rms_norm import (
    VECTOR as NORM_VECTOR,
)

# (QH, KH, D, rot_dim): Llama-3-8B, Gemma-2-2B, chip_smoke.check_rope_options'
# head shapes, a partial rot_dim with its tail, rot_dim / 2 not a multiple
# of 8 (50 and 36), and a small ragged head.
ROPE_HEADS = [
    (32, 8, 128, 128), (8, 4, 256, 256), (4, 1, 128, 128), (8, 8, 64, 64), (32, 8, 128, 64), (4, 1, 128, 100),
    (8, 8, 64, 36), (3, 1, 34, 20),
]
ROPE_TOKENS = [1, 7, 8, 16, 32, 128, 512]
# Row strides of q and k: contiguous, slices of the fused qkv projection,
# and a fused row one element longer (misaligned rows).
ROPE_LAYOUTS = ["contiguous", "fused", "misaligned"]


def _rope_strides(qh: int, kh: int, d: int, layout: str) -> tuple[int, int]:
    if layout == "contiguous":
        return qh * d, kh * d
    fused = (qh + 2 * kh) * d + (layout == "misaligned")
    return fused, fused


def _rope_cover(plan, qh: int, kh: int, d: int, rot: int) -> tuple[np.ndarray, list[np.ndarray]]:
    """Walk the kernel's mapping for one token (every token is walked the
    same way): the times each element of each head is written, and on the
    vector path the head-relative element offsets each thread loads and
    stores (x1 and x2, or a tail chunk)."""
    half = rot // 2
    bx, by = plan.block
    heads = qh + kh
    h = (np.arange(plan.grid[1])[:, None] * by + np.arange(by)[None]).ravel()
    assert (np.bincount(h, minlength=heads)[:heads] == 1).all()  # every head in one block's slot
    h = h[h < heads]
    count = np.zeros((heads, d), np.int64)
    tx = np.arange(bx)
    if plan.path == VECTOR:
        i = tx * plan.vec
        pair = i < half
        starts = [i[pair], half + i[pair], i[~pair] + half]  # x1, x2, tail chunks
        for s in starts:
            elems = (s[:, None] + np.arange(plan.vec)).ravel()
            np.add.at(count, (slice(None), elems), 1)
        return count[h], starts
    units = half + d - rot
    i = np.arange(units)
    assert np.bincount(i % bx).max() <= plan.items  # a thread's steps
    elems = np.concatenate([i[i < half], i[i < half] + half, i[i >= half] + half])
    np.add.at(count, (slice(None), elems), 1)
    return count[h], []


@pytest.mark.parametrize("layout", ROPE_LAYOUTS)
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("heads", ROPE_HEADS, ids=lambda h: "x".join(map(str, h)))
def test_rope_plan_covers_every_pair_once(heads, itemsize, layout):
    qh, kh, d, rot = heads
    q_stride, k_stride = _rope_strides(qh, kh, d, layout)
    for num_tokens in ROPE_TOKENS:
        plan = rope_plan(num_tokens, qh, kh, d, rot, itemsize, q_stride, k_stride, True)
        count, _ = _rope_cover(plan, qh, kh, d, rot)
        assert count.shape == (qh + kh, d) and (count == 1).all(), (num_tokens, plan)
        assert plan.grid[0] == num_tokens and 1 <= plan.block[0] * plan.block[1] <= ROPE_MAX_THREADS


@pytest.mark.parametrize("layout", ROPE_LAYOUTS)
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("heads", ROPE_HEADS, ids=lambda h: "x".join(map(str, h)))
def test_rope_vector_path_only_on_aligned_addresses(heads, itemsize, layout):
    """Every byte offset a vector thread loads or stores (q and k rows at
    their strides, the contiguous outputs, the cos and sin halves of every
    cache row) is a multiple of 16 when the plan takes the vector path."""
    qh, kh, d, rot = heads
    q_stride, k_stride = _rope_strides(qh, kh, d, layout)
    max_position = 64
    for num_tokens, aligned in itertools.product((1, 8, 33), (True, False)):
        plan = rope_plan(num_tokens, qh, kh, d, rot, itemsize, q_stride, k_stride, aligned)
        if plan.path != VECTOR:
            assert plan.path == SCALAR and plan.vec == 1
            continue
        assert aligned and plan.vec * itemsize == 16
        _, starts = _rope_cover(plan, qh, kh, d, rot)
        offsets = np.concatenate(starts)
        t = np.arange(num_tokens)[:, None, None]
        # q heads at q's stride, k heads at k's; outputs contiguous.
        for heads_at, stride, row in ((np.arange(qh), q_stride, qh * d), (np.arange(kh), k_stride, kh * d)):
            src = t * stride + heads_at[None, :, None] * d + offsets
            dst = t * row + heads_at[None, :, None] * d + offsets
            assert (src * itemsize % 16 == 0).all() and (dst * itemsize % 16 == 0).all()
        cos_sin = np.arange(max_position)[:, None] * rot + np.concatenate(starts[:2])
        assert (cos_sin * 4 % 16 == 0).all()


@pytest.mark.parametrize("heads", [(32, 8, 128, 128), (8, 4, 256, 256)], ids=["llama3_8b", "gemma2_2b"])
def test_rope_plan_spreads_a_decode_step(heads):
    """A decode step of 8 tokens (and the engines' 16 and 32) runs on at
    least 64 blocks, each with one 16-byte chunk a thread."""
    qh, kh, d, rot = heads
    fused = (qh + 2 * kh) * d
    for num_tokens in (8, 16, 32):
        plan = rope_plan(num_tokens, qh, kh, d, rot, 2, fused, fused, True)
        assert plan.path == VECTOR and plan.items == 1
        assert plan.grid[0] * plan.grid[1] >= 64


# (rows, hidden): Gemma-2-2B's decode and prefill steps, chip_smoke.
# check_gemma_rms_norm_options' rows and widths (Gemma-2-9B's 3584 and
# 27B's 4608, JAX's 531, 36872 on the looped path), and small ragged ones.
NORM_ROWS = [1, 3, 8, 16, 512, 4096]
NORM_HIDDEN = [128, 531, 2048, 2304, 3072, 3584, 4608, 36872, 3, 9, 300, 1000]


def _norm_cover(plan, hidden: int) -> np.ndarray:
    """The times each element of one row is written, walking the kernel's
    mapping (every row of a plan is walked the same way): vector j belongs
    to lane j % threads_per_row as its item j // threads_per_row (register
    paths: items below ``plan.items`` only), tail element e to lane e."""
    nvec, tail = hidden // plan.vec, hidden % plan.vec
    j = np.arange(nvec)
    lane, item = j % plan.threads_per_row, j // plan.threads_per_row
    assert (np.bincount(lane, minlength=1) <= plan.items).all()
    if plan.path in (NORM_VECTOR, NORM_SCALAR):
        j = j[item < plan.items]
    count = np.zeros(hidden, np.int64)
    np.add.at(count, (j[:, None] * plan.vec + np.arange(plan.vec)).ravel(), 1)
    assert tail <= plan.threads_per_row
    count[nvec * plan.vec :] += 1
    return count


@pytest.mark.parametrize("layout", ["contiguous", "strided", "misaligned"])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("hidden", NORM_HIDDEN)
def test_gemma_norm_plan_covers_every_element_once(hidden, itemsize, layout):
    stride = {"contiguous": hidden, "strided": hidden + 64, "misaligned": hidden + 1}[layout]
    for rows in NORM_ROWS:
        plan = gemma_norm_plan(rows, hidden, itemsize, stride, True)
        assert (_norm_cover(plan, hidden) == 1).all(), (rows, plan)
        # Every row in exactly one block's slot.
        assert plan.grid * plan.rows_per_block >= rows > (plan.grid - 1) * plan.rows_per_block
        tpr, threads = plan.threads_per_row, plan.threads_per_row * plan.rows_per_block
        assert threads <= (REGISTER_THREADS if plan.path in (NORM_VECTOR, NORM_SCALAR) else MAX_THREADS)
        # Rows share a warp in whole power-of-two groups of lanes; wider rows are whole warps.
        assert (tpr < 32 and 32 % tpr == 0 and threads % 32 == 0) or tpr % 32 == 0
        if plan.path in (NORM_VECTOR, NORM_SCALAR):
            assert plan.items <= MAX_ITEMS[plan.path]
        else:
            assert plan.rows_per_block == 1 and tpr == MAX_THREADS


@pytest.mark.parametrize("layout", ["contiguous", "strided", "misaligned"])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("hidden", NORM_HIDDEN)
def test_gemma_norm_vector_path_only_on_aligned_addresses(hidden, itemsize, layout):
    """Every vector a thread loads or stores (x at its row stride, the
    contiguous output, the weight) starts on a 16-byte boundary; the scalar
    tail exists only on a single row."""
    stride = {"contiguous": hidden, "strided": hidden + 64, "misaligned": hidden + 1}[layout]
    for rows, aligned in itertools.product((1, 3, 16), (True, False)):
        plan = gemma_norm_plan(rows, hidden, itemsize, stride, aligned)
        if plan.vec == 1:
            assert plan.path in (NORM_SCALAR, LOOPED_SCALAR)
            continue
        assert aligned and plan.vec * itemsize == 16 and plan.path in (NORM_VECTOR, LOOPED_VECTOR)
        assert hidden % plan.vec == 0 or rows == 1
        starts = np.arange(hidden // plan.vec) * plan.vec
        r = np.arange(rows)[:, None]
        for row_elems in (r * stride + starts, r * hidden + starts, starts[None]):
            assert (row_elems * itemsize % 16 == 0).all()


def test_gemma_norm_plan_spreads_a_decode_step():
    """At Gemma-2-2B's decode steps (8 and 16 rows of 2304, bf16 and f32)
    no row waits on one warp: several warps share it, two vectors a thread;
    hidden 3584 and 4608 (Gemma-2-9B, 27B) stay in registers at any row
    count, and the 512-row prefill chunk too."""
    for rows in (8, 16):
        for itemsize in (2, 4):
            plan = gemma_norm_plan(rows, 2304, itemsize, 2304, True)
            assert plan.path == NORM_VECTOR and plan.threads_per_row > 32 and plan.items <= 2
            assert plan.grid == rows
    for hidden in (2304, 3584, 4608):
        for rows in (1, 16, 512, 4096):
            assert gemma_norm_plan(rows, hidden, 2, hidden, True).path == NORM_VECTOR
            assert gemma_norm_plan(rows, hidden, 4, hidden, True).path == NORM_VECTOR


def test_plans_take_shapes_only():
    assert list(inspect.signature(rope_plan).parameters) == [
        "num_tokens", "num_q_heads", "num_k_heads", "head_size", "rot_dim", "itemsize", "q_row_stride",
        "k_row_stride", "aligned",
    ]
    assert list(inspect.signature(gemma_norm_plan).parameters) == ["rows", "hidden", "itemsize", "row_stride",
                                                                    "aligned"]
    args = (8, 32, 8, 128, 128, 2, 6144, 6144, True)
    assert rope_plan(*args) == rope_plan(*args)
    assert gemma_norm_plan(16, 2304, 2, 2304, True) == gemma_norm_plan(16, 2304, 2, 2304, True)
    assert rope_plan(0, 32, 8, 128, 128, 2, 6144, 6144, True).grid[0] == 0
    assert gemma_norm_plan(0, 2304, 2, 2304, True).grid == 0
