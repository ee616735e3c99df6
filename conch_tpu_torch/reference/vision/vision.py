# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Plain PyTorch versions of the vision kernels (K13a, K13b, K13c).

Counterparts of what ``conch_tpu/kernels/vision/bev_pool.py`` and
``conch_tpu/kernels/vision/nms.py`` compute in Pallas. The CPU path of the
port runs them, and the tests and ``chip_smoke.py`` hold the CUDA kernels
against them on the same inputs. Each sums and rounds in the order its
kernel does, with nothing left to the order of atomics, so a kernel can
be held to them exactly:

- ``bev_pool``: each interval's sum in the accumulation type (f32; f64
  for f64 input), its points added one after the other; the sums then
  added onto the grid in interval order; one cast to the input's dtype.
- ``bev_pool_backward``: each interval's cell row gathered and copied to
  the interval's points; points in no interval get zero.
- ``nms_keep_mask``: the greedy loop of ``_nms_kernel``, step for step,
  in f32.

A cell outside the grid (any coordinate outside its range, or an
interval that starts outside the points) is dropped, and its points get
a zero gradient.
"""

from __future__ import annotations

import numpy as np
import torch


def accumulation_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 for f32 / bf16 / f16 features (as the TPU kernels sum); f64 stays f64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def interval_cells(
    geom_feats: torch.Tensor, interval_starts: torch.Tensor, batch_size: int, grid_z: int, grid_x: int, grid_y: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(flat cell ``((b*Z + z)*X + x)*Y + y`` of each interval's first point,
    whether that cell lies inside the grid), both (num_intervals,)."""
    num_points = geom_feats.shape[0]
    starts = interval_starts.long()
    inside = (starts >= 0) & (starts < num_points)
    if num_points == 0:
        zeros = torch.zeros_like(starts)
        return zeros, torch.zeros_like(inside)
    first = geom_feats[starts.clamp(0, num_points - 1)].long()
    x, y, z, b = first.unbind(1)
    valid = inside & (x >= 0) & (x < grid_x) & (y >= 0) & (y < grid_y) & (z >= 0) & (z < grid_z)
    valid &= (b >= 0) & (b < batch_size)
    cells = ((b * grid_z + z) * grid_x + x) * grid_y + y
    return torch.where(valid, cells, 0), valid


def interval_sums(image_feats: torch.Tensor, interval_starts: torch.Tensor, interval_lengths: torch.Tensor,
                  acc_dtype: torch.dtype) -> torch.Tensor:
    """(num_intervals, C) sums in ``acc_dtype``, each interval's points added
    in order. Step k adds point k of every interval longer than k (the
    intervals ordered by length, so step k's are a prefix): every sum sees
    its points one after the other, and the work is one row per point."""
    num_intervals, channels = interval_starts.shape[0], image_feats.shape[1]
    device = image_feats.device
    sums = torch.zeros((num_intervals, channels), dtype=acc_dtype, device=device)
    if num_intervals == 0:
        return sums
    starts, num_points = interval_starts.long(), image_feats.shape[0]
    # An interval that starts outside the points sums nothing; one that runs
    # past them stops at the last point.
    inside = (starts >= 0) & (starts < num_points)
    lengths = torch.where(inside, torch.minimum(interval_lengths.long(), num_points - starts), 0).clamp(min=0)
    order = torch.argsort(lengths, descending=True, stable=True)
    hist = np.bincount(lengths.cpu().numpy(), minlength=1)
    longer_than = num_intervals - np.cumsum(hist)  # intervals with length > k, for k = 0, 1, ...
    for k, active in enumerate(longer_than[:-1].tolist()):
        idx = order[:active]
        sums.index_add_(0, idx, image_feats[starts[idx] + k].to(acc_dtype))
    return sums


def bev_pool(
    image_feats: torch.Tensor,
    geom_feats: torch.Tensor,
    interval_starts: torch.Tensor,
    interval_lengths: torch.Tensor,
    batch_size: int,
    grid_z: int,
    grid_x: int,
    grid_y: int,
) -> torch.Tensor:
    """(B, Z, X, Y, C) pooled features in ``image_feats``' dtype."""
    channels = image_feats.shape[1]
    acc = accumulation_dtype(image_feats.dtype)
    sums = interval_sums(image_feats, interval_starts, interval_lengths, acc)
    cells, valid = interval_cells(geom_feats, interval_starts, batch_size, grid_z, grid_x, grid_y)
    out = torch.zeros((batch_size * grid_z * grid_x * grid_y, channels), dtype=acc, device=image_feats.device)
    kept = valid.nonzero().squeeze(1)
    if kept.numel():
        # Intervals that share a cell are added in interval order: round r adds
        # the r-th interval of every cell, so no round adds twice to one row.
        cell = cells[kept]
        by_cell = torch.argsort(cell, stable=True)
        sorted_cell = cell[by_cell]
        pos = torch.arange(kept.numel(), device=cell.device)
        new = torch.ones_like(sorted_cell, dtype=torch.bool)
        new[1:] = sorted_cell[1:] != sorted_cell[:-1]
        run_start = torch.cummax(torch.where(new, pos, 0), 0).values
        occurrence = torch.empty_like(pos)
        occurrence[by_cell] = pos - run_start
        for r in range(int(occurrence.max()) + 1):
            sel = kept[occurrence == r]
            out.index_add_(0, cells[sel], sums[sel])
    return out.to(image_feats.dtype).reshape(batch_size, grid_z, grid_x, grid_y, channels)


def bev_pool_backward(
    grad_output: torch.Tensor,
    geom_feats: torch.Tensor,
    interval_starts: torch.Tensor,
    interval_lengths: torch.Tensor,
    num_points: int,
) -> torch.Tensor:
    """(num_points, C) gradient in ``grad_output``'s dtype: each interval's
    points get its cell's row (intervals are disjoint); other points zero."""
    batch_size, grid_z, grid_x, grid_y, channels = grad_output.shape
    rows = grad_output.reshape(-1, channels)
    cells, valid = interval_cells(geom_feats, interval_starts, batch_size, grid_z, grid_x, grid_y)
    per_interval = torch.where(valid[:, None], rows[cells], 0)
    out = torch.zeros((num_points, channels), dtype=grad_output.dtype, device=grad_output.device)
    lengths = interval_lengths.long().clamp(min=0)
    seg = torch.repeat_interleave(torch.arange(lengths.numel(), device=lengths.device), lengths)
    offsets = torch.cumsum(lengths, 0) - lengths
    point = interval_starts.long()[seg] + torch.arange(seg.numel(), device=seg.device) - offsets[seg]
    inside = (point >= 0) & (point < num_points)
    out[point[inside]] = per_interval[seg[inside]]
    return out


def nms_keep_mask(
    x1: torch.Tensor, y1: torch.Tensor, x2: torch.Tensor, y2: torch.Tensor, area: torch.Tensor, iou_threshold: float,
) -> torch.Tensor:
    """Keep mask over N score-sorted f32 boxes: ``_nms_kernel``'s loop, step
    for step. Step i suppresses every later box whose IoU with box i is
    above the threshold (compared in f32), if box i is still kept."""
    n = x1.numel()
    threshold = torch.tensor(iou_threshold, dtype=torch.float32, device=x1.device)
    idx = torch.arange(n, device=x1.device)
    keep = torch.ones(n, dtype=torch.bool, device=x1.device)
    for i in range(n - 1):
        inter_w = (torch.minimum(x2, x2[i]) - torch.maximum(x1, x1[i])).clamp_min(0.0)
        inter_h = (torch.minimum(y2, y2[i]) - torch.maximum(y1, y1[i])).clamp_min(0.0)
        inter = inter_w * inter_h
        union = area + area[i] - inter
        iou = torch.where(union > 0.0, inter / union, 0.0)
        keep &= ~((iou > threshold) & (idx > i) & keep[i])
    return keep
