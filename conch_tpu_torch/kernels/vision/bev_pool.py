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
ascend, the kept intervals' cells ascend, and the intervals are disjoint
(a zero-length interval may share its start with another). K13b relies
on it: each of its warps finds the interval of its first point by one
search over the starts, then gives each of its 32 points the last
interval starting at or before it. So does K13a: each of its blocks owns
the kept intervals that start in its tile of points (one search), and the
runs of equal cells that open among them (``bev_forward_plan``).

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
import dataclasses

import torch

from conch_tpu_torch.kernels.common import (
    cdiv,
    check_launch,
    kernel_function,
    require_cuda,
    storage_code,
    stream_of,
)
from conch_tpu_torch.kernels.vision.nms import SMEM_LIMIT
from conch_tpu_torch.reference.vision.vision import bev_pool as bev_pool_plain
from conch_tpu_torch.reference.vision.vision import bev_pool_backward as bev_pool_backward_plain
from conch_tpu_torch.reference.vision.vision import interval_cells

KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
)
_BWD_PLAN_ARGTYPES = (ctypes.c_int64,)  # K13b's blocks
# K13a's plan: tile_points, tma, stages, stage_rows, stage_bytes, smem_bytes, blocks
_FWD_PLAN_ARGTYPES = (ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                      ctypes.c_int64)
BWD_BLOCK_POINTS = 256  # points a block of K13b (csrc/bev_pool.cu: kBevBwdBlockPoints): a point a thread
# K13a (csrc/bev_pool.cu): a block owns the intervals that start in its tile of FWD_TILE_POINTS points.
FWD_TILE_POINTS = 640
FWD_STAGE_BYTES = 17920  # a TMA stage's rows: at most this many bytes (at least one row)
FWD_MAX_STAGES = 2  # five blocks an SM at BEVFusion's rows
FWD_PIECES = 128  # pieces, and rows, a stage holds at most (kFwdPieces)
FWD_HEADER_BYTES = 2592  # sizeof(FwdHeader); a ring of one more than the stages


@dataclasses.dataclass(frozen=True)
class BevForwardPlan:
    """K13a's launch: ``blocks`` tiles of ``tile_points`` points; a ring of
    ``stages`` stages of ``stage_rows`` rows of the block's stream, whose
    rows go through shared memory (``stage_bytes``) with ``tma``, else the
    consumers read them from global memory; ``smem_bytes`` of dynamic
    shared memory (the ring, a header a stage and one more, the carried
    sums, two mbarriers a stage)."""

    tile_points: int
    blocks: int
    tma: bool
    stages: int
    stage_rows: int
    stage_bytes: int
    smem_bytes: int


def bev_forward_plan(num_points: int, channels: int, element_size: int, vec: int,
                     tile_points: int | None = None) -> BevForwardPlan:
    """K13a's plan from the shapes and ``vector_width``'s ``vec``: TMA bulk
    copies where a row is a whole number of 16-byte vectors on a 16-byte
    base (``vec * element_size == 16``) and two stages fit; stages of whole
    rows, at most FWD_STAGE_BYTES and FWD_PIECES rows, as many as fit up to
    FWD_MAX_STAGES. Raises NotImplementedError where the carried sums (16
    bytes a channel) leave no room (above about 14000 channels)."""
    tile_points = FWD_TILE_POINTS if tile_points is None else tile_points
    row = channels * element_size
    fixed = 16 * channels  # two buffers of the interval's and the run's f32 sums
    tma, stages, stage_rows, stage_bytes = vec * element_size == 16, FWD_MAX_STAGES, FWD_PIECES, 0
    if tma:
        rows = min(max(1, FWD_STAGE_BYTES // row), FWD_PIECES)
        fit = (SMEM_LIMIT - fixed - FWD_HEADER_BYTES) // (rows * row + FWD_HEADER_BYTES + 16)
        tma = fit >= 2
        if tma:
            stages, stage_rows, stage_bytes = min(FWD_MAX_STAGES, fit), rows, rows * row
    smem = fixed + FWD_HEADER_BYTES + stages * (stage_bytes + FWD_HEADER_BYTES + 16)
    if smem > SMEM_LIMIT:
        msg = f"bev_pool forward kernel: {channels} channels need {smem} bytes of shared memory, at most {SMEM_LIMIT}"
        raise NotImplementedError(msg)
    return BevForwardPlan(tile_points=tile_points, blocks=max(1, cdiv(num_points, tile_points)), tma=tma,
                          stages=stages, stage_rows=stage_rows, stage_bytes=stage_bytes, smem_bytes=smem)


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
            out: torch.Tensor, num_points: int, grid: tuple[int, int, int, int], vec: int, plan_types: tuple,
            plan: tuple[int, ...]) -> None:
    """One launch of K13a or K13b (``plan``: the entry point's plan
    arguments, of ``plan_types``); each writes every row of ``out``."""
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
    fn = kernel_function(name, (*_ARGTYPES, *plan_types, ctypes.c_void_p))
    code = fn(src.data_ptr(), geom.data_ptr(), starts.data_ptr(), lengths.data_ptr(), out.data_ptr(), num_points,
              starts.numel(), src.shape[-1], *grid, storage_code(src), vec, *plan, stream_of(src))
    check_launch(name, code)


def bev_pool_forward_launcher(
    image_feats: torch.Tensor, geom_feats: torch.Tensor, interval_starts: torch.Tensor,
    interval_lengths: torch.Tensor, batch_size: int, grid_cells_z: int, grid_cells_x: int, grid_cells_y: int,
) -> torch.Tensor:
    """The sorted forward: (B, Z, X, Y, C) in ``image_feats``' dtype. K13a on
    CUDA (``launches`` counts its launches), which writes every row of a
    ``torch.empty`` output once (zeros where no kept interval lands); the
    plain version on the CPU."""
    check_bev_inputs(image_feats, geom_feats, interval_starts, interval_lengths)
    grid = (batch_size, grid_cells_z, grid_cells_x, grid_cells_y)
    if image_feats.device.type == "cpu":
        return bev_pool_plain(image_feats, geom_feats, interval_starts, interval_lengths, *grid)
    feats = image_feats.contiguous()
    shape = (*grid, feats.shape[1])
    if not interval_starts.numel():
        return torch.zeros(shape, dtype=feats.dtype, device=feats.device)  # nothing to pool: no launch
    out = torch.empty(shape, dtype=feats.dtype, device=feats.device)
    if not out.numel():
        return out
    if out.shape[:4].numel() >= 2**31:
        msg = f"bev_pool forward kernel: a grid of at most 2**31 - 1 cells, got {tuple(out.shape[:4])}"
        raise NotImplementedError(msg)
    vec = vector_width(feats.shape[1], feats.element_size(), feats, out)
    plan = bev_forward_plan(feats.shape[0], feats.shape[1], feats.element_size(), vec)
    _launch("conch_bev_pool_forward", feats, geom_feats, interval_starts, interval_lengths, out, feats.shape[0], grid,
            vec, _FWD_PLAN_ARGTYPES, (plan.tile_points, int(plan.tma), plan.stages, plan.stage_rows, plan.stage_bytes,
                                      plan.smem_bytes, plan.blocks))
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
    vec = vector_width(grad.shape[-1], grad.element_size(), grad, out)
    _launch("conch_bev_pool_backward", grad, geom_feats, interval_starts, interval_lengths, out, num_points,
            tuple(grad.shape[:4]), vec, _BWD_PLAN_ARGTYPES, (bev_backward_blocks(num_points),))
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
