# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""The launch of the gated-activation kernels, K6 (``silu_and_mul``) and
K10b (``gelu_tanh_and_mul``), which share ``csrc/gated_act.cuh`` and differ
only in their activation.

``gated_act_plan`` sets a launch from shapes alone: its path (vectors
where gate, up and out start on 16-byte boundaries and d and the row
strides are whole vectors, else scalars), the vector's elements (4 at a
small step, 16 bytes at a large one), the threads of a block, the units a
thread takes and the grid, so that a decode step spreads over the card's
SMs and a prefill chunk stays within a few waves. ``launch_gated_act``
checks the inputs, plans and launches one entry point, as a programmatic
dependent of the kernel before it when ``pdl`` is set.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from conch_tpu_torch.kernels.common import (
    FLOAT_DTYPES,
    cdiv,
    check_launch,
    check_rows,
    dtype_code,
    kernel_function,
    stream_of,
)

VECTOR, SCALAR = 0, 1  # the kernel's paths: units of vec elements, or of one
# Elements a vector at a small step: 16 bytes of f32, 8 of bf16 or f16
# (csrc/gated_act.cuh: launch_vec). Each element's IEEE division runs a
# dependent chain, so a small step finishes sooner with fewer elements a
# thread; a step of more than WAVE_BLOCKS blocks of MAX_THREADS such
# vectors takes 16-byte ones.
VECTOR_ELEMENTS = 4
MAX_THREADS = 256  # a block's threads (csrc/gated_act.cuh: kGatedActMaxThreads)
MIN_THREADS = 32  # a block's threads at least (a warp), while a step spreads
MAX_ITEMS = 8  # units a thread (csrc/gated_act.cuh: launch_items)
SPREAD_BLOCKS = 132  # one block for each SM of an H100: a step keeps this many blocks while blocks can shrink
WAVE_BLOCKS = 8 * SPREAD_BLOCKS  # eight blocks of MAX_THREADS an SM fill the card once
# Four waves; larger steps take more units a thread (more than one slowed a
# 512-row step), then rounds.
GRID_CAP = 4 * WAVE_BLOCKS
MAX_ELEMENTS = 2**31  # the kernel indexes a step's units in 32 bits

HALVES_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)
PARTS_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)


@dataclasses.dataclass(frozen=True)
class GatedActPlan:
    """A launch of K6 or K10b: ``grid`` blocks of ``threads`` threads over
    the step's ``rows * d // vec`` units (``vec`` elements each). Block b
    takes units ``b * threads * items + i * threads + t`` (thread t, i <
    ``items``), then the same ``grid * threads * items`` further on, in
    rounds, while units remain."""

    path: int
    vec: int
    threads: int
    items: int
    grid: int


def gated_act_plan(
    rows: int, d: int, itemsize: int, gate_row_stride: int, up_row_stride: int, aligned: bool
) -> GatedActPlan:
    """K6's and K10b's launch from shapes only. ``aligned``: gate, up and
    out start on 16-byte boundaries. Vectors need that, d in whole vectors
    and, when there are rows after the first, row strides in whole vectors
    too: VECTOR_ELEMENTS elements, or 16 bytes where the step passes
    WAVE_BLOCKS blocks of the small ones. A block has MAX_THREADS threads,
    halved down to MIN_THREADS while the step has fewer than SPREAD_BLOCKS
    blocks; a thread takes one unit, doubled up to MAX_ITEMS while the grid
    would pass GRID_CAP, which bounds the grid."""

    def fits(vec: int) -> bool:
        strides = rows <= 1 or (gate_row_stride % vec == 0 and up_row_stride % vec == 0)
        return aligned and strides and d % vec == 0

    wide = 16 // itemsize
    large = cdiv(rows * d, VECTOR_ELEMENTS * MAX_THREADS) > WAVE_BLOCKS
    vec = wide if large and fits(wide) else VECTOR_ELEMENTS
    path = VECTOR if fits(vec) else SCALAR
    if path == SCALAR:
        vec = 1
    units = rows * (d // vec)
    threads, items = MAX_THREADS, 1
    while threads > MIN_THREADS and cdiv(units, threads) < SPREAD_BLOCKS:
        threads //= 2
    while items < MAX_ITEMS and cdiv(units, threads * items) > GRID_CAP:
        items *= 2
    return GatedActPlan(path=path, vec=vec, threads=threads, items=items,
                        grid=min(cdiv(units, threads * items), GRID_CAP))


def launch_gated_act(entry: str, gate: torch.Tensor, up: torch.Tensor, pdl: bool, halves: torch.Tensor | None = None):
    """One launch of ``entry`` on 2D (rows, d) CUDA gate and up with
    contiguous rows; ``halves`` is the (rows, 2d) input they were sliced
    from, for the fused entry point (``conch_silu_and_mul``,
    ``conch_gelu_tanh_and_mul``), which reads it in place. Returns the new
    contiguous output and whether a kernel was launched (not for an empty
    step)."""
    check_rows(entry, gate, up)
    code_dtype = dtype_code(gate, FLOAT_DTYPES)
    rows, d = gate.shape
    if rows * d >= MAX_ELEMENTS:
        msg = f"{entry} kernel: {rows} x {d} elements, the kernel takes fewer than {MAX_ELEMENTS}"
        raise ValueError(msg)
    out = torch.empty((rows, d), dtype=gate.dtype, device=gate.device)
    if rows * d == 0:
        return out, False
    aligned = all(p % 16 == 0 for p in (gate.data_ptr(), up.data_ptr(), out.data_ptr()))
    plan = gated_act_plan(rows, d, gate.element_size(), gate.stride(0), up.stride(0), aligned)
    args = (code_dtype, plan.vec, plan.threads, plan.items, plan.grid, int(pdl), stream_of(gate))
    if halves is None:
        code = kernel_function(entry, PARTS_ARGTYPES)(
            gate.data_ptr(), up.data_ptr(), out.data_ptr(), rows, d, gate.stride(0), up.stride(0), *args,
        )
    else:
        code = kernel_function(entry, HALVES_ARGTYPES)(
            halves.data_ptr(), out.data_ptr(), rows, d, halves.stride(0), *args,
        )
    check_launch(entry, code)
    return out, True


def split_halves(name: str, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The gate and up halves of a 2D (rows, 2d) input, as views."""
    if x.dim() != 2 or x.shape[1] % 2:
        msg = f"{name} kernel: a 2D input with an even last axis, got {tuple(x.shape)}"
        raise ValueError(msg)
    d = x.shape[1] // 2
    return x[:, :d], x[:, d:]
