# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""K6's and K10b's launch plan (``conch_tpu_torch/kernels/activation/
gated_act.py:gated_act_plan``), which the wrappers compute from shapes in
Python and the CUDA kernel follows (``csrc/gated_act.cuh``). Each test
walks the kernel's mapping as the kernel does (block b's thread t takes
units ``base + i * threads``, i < items, from ``base = b * threads * items
+ t`` in steps of ``grid * threads * items`` while ``base`` is inside the
step; unit u is row ``u // (d // vec)``, columns from ``(u % (d // vec)) *
vec``) and checks, for f32, bf16 and f16, both call forms (the fused
halves of a (rows, 2d) input; separate contiguous parts) and the JAX
tests' widths (128, 1024, 4096, 531) beside the served ones (Llama-3-8B's
14336, Gemma-2-2B's 9216, DeepSeek-V2-Lite's 10944 and 2816):

- the grid covers every unit of the step exactly once, on the vector path
  and on the scalar one;
- the vector path is chosen exactly when its conditions hold, and then
  every 16-byte load and store it makes is aligned;
- the served decode steps spread over at least SPREAD_BLOCKS blocks;
- a 512-row prefill chunk stays within GRID_CAP blocks;
- the plan takes shapes only.
"""

import inspect
import itertools

import numpy as np
import pytest

from conch_tpu_torch.kernels.activation.gated_act import (
    GRID_CAP,
    MAX_ITEMS,
    MAX_THREADS,
    MIN_THREADS,
    SCALAR,
    SPREAD_BLOCKS,
    VECTOR,
    VECTOR_ELEMENTS,
    gated_act_plan,
)
from conch_tpu_torch.kernels.common import cdiv

ITEMSIZES = {"float32": 4, "bfloat16": 2, "float16": 2}
FORMS = ["halves", "parts"]
WIDTHS = [128, 1024, 4096, 531, 14336, 9216, 10944, 2816]
ROWS = [0, 1, 7, 8, 16, 32, 512]
# (rows, d) of the served decode steps: Llama-3-8B's 8 and the quantized
# engines' padded 32, Gemma-2-2B's 8 and 16, DeepSeek-V2-Lite's 8 at the
# dense layer's and the shared experts' widths.
DECODE_STEPS = [(8, 14336), (32, 14336), (8, 9216), (16, 9216), (8, 10944), (8, 2816)]


def _strides(d: int, form: str, misaligned_rows: bool = False) -> tuple[int, int]:
    stride = (2 * d if form == "halves" else d) + misaligned_rows
    return stride, stride


def _walk(plan, units: int) -> np.ndarray:
    """Every unit the kernel's threads take, in the order the walk finds them."""
    step = plan.grid * plan.threads * plan.items
    if step == 0:
        return np.zeros((0,), np.int64)
    b, i, t = np.meshgrid(np.arange(plan.grid), np.arange(plan.items), np.arange(plan.threads), indexing="ij")
    first = (b * plan.threads * plan.items + t).ravel()
    offset = (i * plan.threads).ravel()
    taken = []
    for r in range(cdiv(units, step) + 1):
        base = first + r * step
        unit = base + offset
        taken.append(unit[(base < units) & (unit < units)])
    return np.concatenate(taken)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype", list(ITEMSIZES))
def test_gated_act_plan_covers_every_unit_once(dtype, form, d):
    itemsize = ITEMSIZES[dtype]
    gs, us = _strides(d, form)
    for rows, aligned in itertools.product(ROWS, (True, False)):
        if not aligned and rows * d > 512 * 4096:
            continue  # the scalar walk of a served width's prefill chunk: millions of units, no new case
        plan = gated_act_plan(rows, d, itemsize, gs, us, aligned)
        assert MIN_THREADS <= plan.threads <= MAX_THREADS and 1 <= plan.items <= MAX_ITEMS
        assert plan.path == (VECTOR if plan.vec > 1 else SCALAR)
        assert d % plan.vec == 0
        units = rows * (d // plan.vec)
        assert (plan.grid == 0) == (units == 0) and plan.grid <= GRID_CAP
        taken = _walk(plan, units)
        assert len(taken) == units and (np.bincount(taken, minlength=units) == 1).all(), (rows, plan)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype", list(ITEMSIZES))
def test_gated_act_vector_path_exactly_when_aligned(dtype, form):
    """The plan takes vectors exactly when the bases are aligned, d is
    whole vectors and (past one row) both row strides are too; then every
    load of gate and up and every store of out starts on a multiple of the
    vector's bytes (bases on 16-byte boundaries, up of the halves d elements
    after gate)."""
    itemsize = ITEMSIZES[dtype]
    small = VECTOR_ELEMENTS
    for d, rows, aligned, misaligned_rows in itertools.product(WIDTHS, (1, 8, 33, 512), (True, False), (False, True)):
        gs, us = _strides(d, form, misaligned_rows)
        plan = gated_act_plan(rows, d, itemsize, gs, us, aligned)
        wanted = aligned and d % small == 0 and (rows <= 1 or (gs % small == 0 and us % small == 0))
        assert (plan.path == VECTOR) == wanted, (d, rows, aligned, misaligned_rows)
        if plan.path != VECTOR:
            assert plan.vec == 1
            continue
        vec, width = plan.vec, plan.vec * itemsize
        assert width in (8, 16) and vec % small == 0
        units = _walk(plan, rows * d // vec)
        row, col = units // (d // vec), units % (d // vec) * vec
        up_base = d if form == "halves" else 0
        assert ((row * gs + col) * itemsize % width == 0).all()
        assert ((up_base + row * us + col) * itemsize % width == 0).all()


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype", list(ITEMSIZES))
def test_gated_act_plan_spreads_decode_steps(dtype, form):
    """Every served decode step takes the vector path of VECTOR_ELEMENTS
    elements, one unit a thread, on SPREAD_BLOCKS blocks or more, in one
    round; Llama-3-8B's 8 rows of bf16 on 224 blocks of 128 threads."""
    itemsize = ITEMSIZES[dtype]
    for rows, d in DECODE_STEPS:
        gs, us = _strides(d, form)
        plan = gated_act_plan(rows, d, itemsize, gs, us, True)
        assert plan.path == VECTOR and plan.vec == VECTOR_ELEMENTS, (rows, d, plan)
        assert plan.items == 1 and plan.grid >= SPREAD_BLOCKS, (rows, d, plan)
        assert plan.grid * plan.threads >= rows * d // plan.vec
    if dtype == "bfloat16":
        plan = gated_act_plan(8, 14336, 2, *_strides(14336, form), True)
        assert (plan.threads, plan.grid) == (128, 224)


@pytest.mark.parametrize("dtype", list(ITEMSIZES))
def test_gated_act_prefill_grid_within_cap(dtype):
    """A 512-row chunk stays within GRID_CAP blocks at every width: more
    units a thread, not more blocks; its aligned served widths take 16-byte
    vectors (Llama-3-8B's bf16 one a thread on 3584 blocks of 256, in one
    round)."""
    itemsize = ITEMSIZES[dtype]
    for d, form, aligned in itertools.product(WIDTHS, FORMS, (True, False)):
        plan = gated_act_plan(512, d, itemsize, *_strides(d, form), aligned)
        assert plan.grid <= GRID_CAP
        units = 512 * d // plan.vec
        if units <= GRID_CAP * MAX_THREADS * MAX_ITEMS:
            assert plan.grid * plan.threads * plan.items >= units  # one round
        if aligned and d in (14336, 9216, 10944):
            assert plan.vec * itemsize == 16
    if dtype == "bfloat16":
        plan = gated_act_plan(512, 14336, 2, 2 * 14336, 2 * 14336, True)
        assert (plan.vec, plan.threads, plan.items, plan.grid) == (8, 256, 1, 3584)


@pytest.mark.parametrize("cap", [1, 3, 7])
def test_gated_act_plan_walks_rounds_past_its_cap(cap, monkeypatch):
    """A step past GRID_CAP blocks of MAX_ITEMS units a thread is walked
    in rounds, each unit once (the cap lowered so that small steps take
    rounds)."""
    monkeypatch.setattr("conch_tpu_torch.kernels.activation.gated_act.GRID_CAP", cap)
    for rows, d, itemsize, aligned in itertools.product((7, 33, 130), (128, 531, 4096), (2, 4), (True, False)):
        plan = gated_act_plan(rows, d, itemsize, 2 * d, 2 * d, aligned)
        units = rows * d // plan.vec
        assert plan.grid <= cap
        taken = _walk(plan, units)
        assert len(taken) == units and (np.bincount(taken, minlength=units) == 1).all(), (rows, d, plan)
        if units > cap * MAX_THREADS * MAX_ITEMS:
            assert plan.items == MAX_ITEMS and plan.grid == cap  # more than one round


def test_gated_act_plan_takes_shapes_only():
    assert list(inspect.signature(gated_act_plan).parameters) == [
        "rows", "d", "itemsize", "gate_row_stride", "up_row_stride", "aligned",
    ]
    assert gated_act_plan(8, 14336, 2, 28672, 28672, True) == gated_act_plan(8, 14336, 2, 28672, 28672, True)
    assert gated_act_plan(0, 14336, 2, 28672, 28672, True).grid == 0
