# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""BEV pool: the CUDA kernels K13a (forward) and K13b (backward), the
autograd op, and the unsorted branch.

Counterpart of ``conch_tpu/kernels/vision/bev_pool.py``. With
``cells_sorted=True`` (intervals in ascending flat-cell order and disjoint,
as BEVFusion builds them) the JAX package runs its Pallas kernels; here
``csrc/bev_pool.cu`` replaces them: K13a for ``_interval_sums_kernel`` and
``_placement_kernel``, K13b for ``_grad_sums_kernel`` and
``_grad_points_kernel``. The launchers take the plain versions
(``conch_tpu_torch/reference/vision/vision.py``) only for CPU tensors; on
CUDA they launch the kernel or raise.

The sorted path's contract, as the JAX package's sorted backward assumes
(``searchsorted`` over the ends and starts of the intervals,
``conch_tpu/kernels/vision/bev_pool.py:411-415``): ``interval_starts``
ascend and the intervals are disjoint (a zero-length interval may share
its start with another). K13b relies on it: each of its warps finds the
interval of its first point by one search over the starts, then gives
each of its 32 points the last interval starting at or before it.

With ``cells_sorted=False`` the JAX package runs XLA, not Pallas
(``_bev_pool_xla_impl``, ``_bev_pool_backward_xla_impl``); that branch is
plain torch here too, on either device, as the JAX package's own dispatch
(``index_add_`` / a gather), not a fallback. Its sums are in the input's
dtype, as XLA's are.

A cell with any coordinate outside its range is dropped, and its points
get a zero gradient, on both branches. (The JAX package's sorted path
drops a cell whose flat index falls outside the grid; its XLA path wraps
negative coordinates and clamps the backward gather. The tests compare
the two packages on cells they agree on.)
"""

from __future__ import annotations

import ctypes

import torch

from conch_tpu_torch.kernels.common import (
    cdiv,
    check_launch,
    kernel_function,
    require_cuda,
    storage_code,
    stream_of,
)
from conch_tpu_torch.reference.vision.vision import bev_pool as bev_pool_plain
from conch_tpu_torch.reference.vision.vision import bev_pool_backward as bev_pool_backward_plain
from conch_tpu_torch.reference.vision.vision import interval_cells

KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
)
_PLAN_ARGTYPES = (ctypes.c_int64,)  # K13b's blocks
BWD_BLOCK_POINTS = 256  # points a block of K13b (csrc/bev_pool.cu: kBevBwdBlockPoints): a point a thread


def bev_backward_blocks(num_points: int) -> int:
    """K13b's grid: a block for every BWD_BLOCK_POINTS points, in point
    order, so the blocks in flight write one front of the output, as a fill
    does."""
    return max(1, cdiv(num_points, BWD_BLOCK_POINTS))


def check_bev_inputs(rows: torch.Tensor, geom_feats: torch.Tensor, interval_starts: torch.Tensor,
                     interval_lengths: torch.Tensor) -> None:
    """Raise unless ``geom_feats`` is (num_points, 4) integer and the interval
    arrays are 1-D integer of one length."""
    if geom_feats.dim() != 2 or geom_feats.shape[1] != 4 or geom_feats.is_floating_point():
        msg = f"geom_feats must be (num_points, 4) integer (x, y, z, batch), got {tuple(geom_feats.shape)} {geom_feats.dtype}"
        raise ValueError(msg)
    if (interval_starts.dim() != 1 or interval_starts.shape != interval_lengths.shape
            or interval_starts.is_floating_point() or interval_lengths.is_floating_point()):
        msg = "interval_starts and interval_lengths must be 1-D integer tensors of one length"
        raise ValueError(msg)
    if not rows.is_floating_point():
        msg = f"bev_pool takes floating-point features, got {rows.dtype}"
        raise ValueError(msg)


def vector_width(channels: int, element_size: int, *tensors: torch.Tensor) -> int:
    """Elements per lane load: up to 16 bytes, a divisor of ``channels``, with
    every tensor's base aligned to it."""
    v = 16 // element_size
    while v > 1 and (channels % v or any(t.data_ptr() % (v * element_size) for t in tensors)):
        v //= 2
    return v


def _launch(name: str, src: torch.Tensor, geom: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor,
            out: torch.Tensor, num_points: int, grid: tuple[int, int, int, int], plan: tuple[int, ...] = ()) -> None:
    """One launch of K13a (into the zero-filled ``out``) or K13b (``plan``:
    its blocks; every row of ``out`` written)."""
    if src.dtype not in KERNEL_DTYPES:
        msg = f"{name}: the CUDA kernel takes float32, bfloat16 or float16, got {src.dtype}"
        raise NotImplementedError(msg)
    if geom.shape[0] != num_points or num_points >= 2**31:
        msg = f"{name}: geom_feats has {geom.shape[0]} rows for {num_points} points (at most 2**31 - 1)"
        raise ValueError(msg)
    geom = geom.to(torch.int32).contiguous()
    starts, lengths = starts.to(torch.int32).contiguous(), lengths.to(torch.int32).contiguous()
    require_cuda(src, geom, starts, lengths, out)
    if geom.data_ptr() % 16:
        geom = geom.clone()  # the kernel reads a geom row as one 16-byte load
    channels = src.shape[-1]
    vec = vector_width(channels, src.element_size(), src, out)
    fn = kernel_function(name, (*_ARGTYPES, *_PLAN_ARGTYPES[: len(plan)], ctypes.c_void_p))
    code = fn(src.data_ptr(), geom.data_ptr(), starts.data_ptr(), lengths.data_ptr(), out.data_ptr(), num_points,
              starts.numel(), channels, *grid, storage_code(src), vec, *plan, stream_of(src))
    check_launch(name, code)


def bev_pool_forward_launcher(
    image_feats: torch.Tensor, geom_feats: torch.Tensor, interval_starts: torch.Tensor,
    interval_lengths: torch.Tensor, batch_size: int, grid_cells_z: int, grid_cells_x: int, grid_cells_y: int,
) -> torch.Tensor:
    """The sorted forward: (B, Z, X, Y, C) in ``image_feats``' dtype. K13a on
    CUDA (``launches`` counts its launches), the plain version on the CPU."""
    check_bev_inputs(image_feats, geom_feats, interval_starts, interval_lengths)
    grid = (batch_size, grid_cells_z, grid_cells_x, grid_cells_y)
    if image_feats.device.type == "cpu":
        return bev_pool_plain(image_feats, geom_feats, interval_starts, interval_lengths, *grid)
    feats = image_feats.contiguous()
    out = torch.zeros((*grid, feats.shape[1]), dtype=feats.dtype, device=feats.device)
    if not (interval_starts.numel() and out.numel()):
        return out  # nothing to pool: no launch
    _launch("conch_bev_pool_forward", feats, geom_feats, interval_starts, interval_lengths, out, feats.shape[0], grid)
    bev_pool_forward_launcher.launches += 1
    return out


def bev_pool_backward_launcher(
    grad_output: torch.Tensor, geom_feats: torch.Tensor, interval_starts: torch.Tensor,
    interval_lengths: torch.Tensor, num_points: int,
) -> torch.Tensor:
    """The sorted backward: (num_points, C) in ``grad_output``'s dtype, each
    point its interval's cell row, zero where no kept interval holds it.
    K13b on CUDA (``launches`` counts its launches), which writes every row
    of a ``torch.empty`` output once; the plain version on the CPU. The
    intervals must keep the sorted path's contract (ascending starts,
    disjoint intervals)."""
    check_bev_inputs(grad_output, geom_feats, interval_starts, interval_lengths)
    if grad_output.dim() != 5:
        msg = f"grad_output must be (B, Z, X, Y, C), got {tuple(grad_output.shape)}"
        raise ValueError(msg)
    if grad_output.device.type == "cpu":
        return bev_pool_backward_plain(grad_output, geom_feats, interval_starts, interval_lengths, num_points)
    grad = grad_output.contiguous()
    shape = (num_points, grad.shape[-1])
    if not interval_starts.numel():
        return torch.zeros(shape, dtype=grad.dtype, device=grad.device)  # no point takes a gradient: no launch
    out = torch.empty(shape, dtype=grad.dtype, device=grad.device)
    if not out.numel():
        return out
    _launch("conch_bev_pool_backward", grad, geom_feats, interval_starts, interval_lengths, out, num_points,
            tuple(grad.shape[:4]), (bev_backward_blocks(num_points),))
    bev_pool_backward_launcher.launches += 1
    return out


bev_pool_forward_launcher.launches = 0
bev_pool_backward_launcher.launches = 0


def _point_interval_ids(interval_starts: torch.Tensor, interval_lengths: torch.Tensor,
                        num_points: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each point's interval (by ``searchsorted`` over the starts) and whether
    it lies inside it, as the JAX package's XLA path labels points."""
    starts = interval_starts.long()
    point_ids = torch.arange(num_points, device=starts.device)
    seg = torch.searchsorted(starts, point_ids, right=True) - 1
    seg = seg.clamp(0, max(starts.numel() - 1, 0))
    within = (point_ids >= starts[seg]) & (point_ids < starts[seg] + interval_lengths.long()[seg])
    return seg, within


def bev_pool_unsorted(
    image_feats: torch.Tensor, geom_feats: torch.Tensor, interval_starts: torch.Tensor,
    interval_lengths: torch.Tensor, batch_size: int, grid_cells_z: int, grid_cells_x: int, grid_cells_y: int,
) -> torch.Tensor:
    """Forward for intervals in any cell order (``_bev_pool_xla_impl``):
    segment sums and a scatter-add in the input's dtype."""
    check_bev_inputs(image_feats, geom_feats, interval_starts, interval_lengths)
    num_points, channels = image_feats.shape
    grid = (batch_size, grid_cells_z, grid_cells_x, grid_cells_y)
    out = torch.zeros((batch_size * grid_cells_z * grid_cells_x * grid_cells_y, channels), dtype=image_feats.dtype,
                      device=image_feats.device)
    if interval_starts.numel() and num_points:
        seg, within = _point_interval_ids(interval_starts, interval_lengths, num_points)
        masked = torch.where(within[:, None], image_feats, 0)
        sums = torch.zeros((interval_starts.numel(), channels), dtype=image_feats.dtype, device=image_feats.device)
        sums.index_add_(0, seg, masked)
        cells, valid = interval_cells(geom_feats, interval_starts, *grid)
        out.index_add_(0, cells[valid], sums[valid])
    return out.reshape(*grid, channels)


def bev_pool_backward_unsorted(
    grad_output: torch.Tensor, geom_feats: torch.Tensor, interval_starts: torch.Tensor,
    interval_lengths: torch.Tensor, num_points: int,
) -> torch.Tensor:
    """Backward for intervals in any cell order (``_bev_pool_backward_xla_impl``):
    each point takes its interval's cell row, or zero."""
    check_bev_inputs(grad_output, geom_feats, interval_starts, interval_lengths)
    channels = grad_output.shape[-1]
    if not interval_starts.numel():
        return torch.zeros((num_points, channels), dtype=grad_output.dtype, device=grad_output.device)
    seg, within = _point_interval_ids(interval_starts, interval_lengths, num_points)
    cells, valid = interval_cells(geom_feats, interval_starts, *grad_output.shape[:4])
    per_interval = torch.where(valid[:, None], grad_output.reshape(-1, channels).index_select(0, cells), 0)
    return torch.where(within[:, None], per_interval.index_select(0, seg), 0)


class BevPool(torch.autograd.Function):
    """``bev_pool`` with its gradient wrt ``image_feats`` only, as the JAX
    package's ``custom_vjp``: the backward is K13b on CUDA (sorted), or the
    unsorted branch's gather."""

    @staticmethod
    def forward(ctx, image_feats, geom_feats, interval_starts, interval_lengths, batch_size, grid_cells_z,
                grid_cells_x, grid_cells_y, cells_sorted):
        impl = bev_pool_forward_launcher if cells_sorted else bev_pool_unsorted
        out = impl(image_feats, geom_feats, interval_starts, interval_lengths, batch_size, grid_cells_z,
                   grid_cells_x, grid_cells_y)
        ctx.save_for_backward(geom_feats, interval_starts, interval_lengths)
        ctx.num_points, ctx.cells_sorted = image_feats.shape[0], cells_sorted
        return out

    @staticmethod
    def backward(ctx, grad_output):
        geom_feats, interval_starts, interval_lengths = ctx.saved_tensors
        impl = bev_pool_backward_launcher if ctx.cells_sorted else bev_pool_backward_unsorted
        grad = impl(grad_output.contiguous(), geom_feats, interval_starts, interval_lengths, ctx.num_points)
        return grad, None, None, None, None, None, None, None, None


def bev_pool_launcher(
    image_feats: torch.Tensor, geom_feats: torch.Tensor, interval_starts: torch.Tensor,
    interval_lengths: torch.Tensor, batch_size: int, grid_cells_z: int, grid_cells_x: int, grid_cells_y: int,
    cells_sorted: bool = True,
) -> torch.Tensor:
    """Differentiable BEV pool (wrt ``image_feats``)."""
    return BevPool.apply(image_feats, geom_feats, interval_starts, interval_lengths, batch_size, grid_cells_z,
                         grid_cells_x, grid_cells_y, cells_sorted)


def bev_pool_backward(
    grad_output: torch.Tensor, geom_feats: torch.Tensor, interval_starts: torch.Tensor,
    interval_lengths: torch.Tensor, num_points: int, cells_sorted: bool = True,
) -> torch.Tensor:
    """Gradient wrt image features: each cell's grad broadcast to its points."""
    impl = bev_pool_backward_launcher if cells_sorted else bev_pool_backward_unsorted
    return impl(grad_output, geom_feats, interval_starts, interval_lengths, num_points)
