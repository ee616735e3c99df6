# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""The launch of the register-held RMS norm kernels, K4 (``rms_norm``) and
K10a (``gemma_rms_norm``), which share ``csrc/row_norm.cuh`` and differ
only in their arithmetic.

``row_norm_plan`` sets a launch from shapes alone: its path (rows held in
registers in 16-byte vectors where every row start is 16-byte aligned,
else in scalars; rows too wide for registers looped), the threads of a
row, the rows of a block and the vectors a thread holds. ``launch_row_norm``
checks the inputs, plans and launches one of the two entry points, as a
programmatic dependent of the kernel before it when ``pdl`` is set.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from conch_tpu_torch.kernels.common import (
    FLOAT_DTYPES,
    aligned16,
    cdiv,
    check_launch,
    dtype_code,
    kernel_function,
    next_power_of_2,
    require_cuda,
    round_up,
    stream_of,
)

# The kernel's paths and constants (csrc/row_norm.cuh: launch_path's path, kMaxItems, kBlockThreads).
VECTOR, SCALAR, LOOPED_VECTOR, LOOPED_SCALAR = 0, 1, 2, 3
MAX_ITEMS = {VECTOR: 4, SCALAR: 8}  # vectors a thread holds in registers: 16-byte ones, scalars
REGISTER_THREADS = 512  # a block's threads on the register paths
MAX_THREADS = 1024  # a block's threads on the looped paths
BLOCK_THREADS = 128  # rows are packed into a block up to this many threads
SPREAD_BLOCKS = 132  # one block for each SM of an H100: steps with fewer rows spread a row over more threads

ENTRY_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)


@dataclasses.dataclass(frozen=True)
class NormPlan:
    """A launch of K4 or K10a: block (``threads_per_row``,
    ``rows_per_block``), ``grid`` blocks. A row is ``hidden // vec`` vectors
    of ``vec`` elements (then, on the vector path of a single row, ``hidden
    % vec`` scalar tail elements, one each for the row's first threads);
    vector j belongs to the row's thread ``j % threads_per_row``, which
    holds ``items`` of them at most (on the looped paths: walks)."""

    path: int
    vec: int
    threads_per_row: int
    rows_per_block: int
    items: int
    grid: int


def row_norm_plan(rows: int, hidden: int, itemsize: int, row_stride: int, aligned: bool) -> NormPlan:
    """K4's and K10a's launch from shapes only. ``aligned``: x, the weight
    and the output start on 16-byte boundaries. Vectors need that and, when
    there are rows after the first, a row stride and a hidden size in whole
    16-byte vectors. A row gets enough threads for two vectors a thread
    while the step has at most SPREAD_BLOCKS rows, four beyond (whole warps
    above 32 threads); rows of fewer threads share a warp, and rows share a
    block up to BLOCK_THREADS threads while there are still SPREAD_BLOCKS
    blocks. Rows that would need more than MAX_ITEMS vectors a thread at
    REGISTER_THREADS threads take a looped path, one block of MAX_THREADS
    a row."""
    vec = 16 // itemsize
    vector = aligned and (rows <= 1 or (row_stride % vec == 0 and hidden % vec == 0))
    if not vector:
        vec = 1
    nvec, tail = hidden // vec, hidden % vec
    want = cdiv(max(nvec, 1), 2 if rows <= SPREAD_BLOCKS else 4)
    tpr = next_power_of_2(want) if want <= 32 else round_up(want, 32)
    tpr = min(max(tpr, next_power_of_2(tail)), REGISTER_THREADS)
    items = cdiv(nvec, tpr)
    if items > MAX_ITEMS[VECTOR if vector else SCALAR]:
        return NormPlan(path=LOOPED_VECTOR if vector else LOOPED_SCALAR, vec=vec, threads_per_row=MAX_THREADS,
                        rows_per_block=1, items=cdiv(nvec, MAX_THREADS), grid=rows)
    rpb = 32 // tpr if tpr < 32 else 1
    while tpr * rpb * 2 <= BLOCK_THREADS and cdiv(rows, rpb * 2) >= SPREAD_BLOCKS:
        rpb *= 2
    return NormPlan(path=VECTOR if vector else SCALAR, vec=vec, threads_per_row=tpr, rows_per_block=rpb,
                    items=items, grid=cdiv(rows, rpb))


def launch_row_norm(entry: str, x: torch.Tensor, weight: torch.Tensor, epsilon: float, pdl: bool) -> torch.Tensor:
    """One launch of ``entry`` (``conch_rms_norm`` or ``conch_gemma_rms_norm``)
    on a 2D (rows, hidden) CUDA input with contiguous rows, the weight cast
    to x's dtype; returns the new contiguous output."""
    weight = weight.to(x.dtype).contiguous()
    require_cuda(x, weight)
    rows, hidden = x.shape
    if x.stride(1) != 1 or weight.shape != (hidden,):
        msg = (
            f"{entry} kernel: x rows must be contiguous and the weight ({hidden},), got x strides {x.stride()} and "
            f"weight {tuple(weight.shape)}"
        )
        raise ValueError(msg)
    code_dtype = dtype_code(x, FLOAT_DTYPES)
    out = torch.empty((rows, hidden), dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    plan = row_norm_plan(rows, hidden, x.element_size(), x.stride(0), aligned16(x, weight, out))
    code = kernel_function(entry, ENTRY_ARGTYPES)(
        x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, hidden, x.stride(0), epsilon, code_dtype, plan.path,
        plan.threads_per_row, plan.rows_per_block, plan.items, plan.grid, int(pdl), stream_of(x),
    )
    check_launch(entry, code)
    return out
