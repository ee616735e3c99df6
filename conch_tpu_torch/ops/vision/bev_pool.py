# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""BEVPool public ops (counterpart of ``conch_tpu/ops/vision/bev_pool.py``)."""

from __future__ import annotations

import torch

from conch_tpu_torch.kernels.vision.bev_pool import bev_pool_backward as _bev_pool_backward
from conch_tpu_torch.kernels.vision.bev_pool import bev_pool_launcher


def bev_pool(
    image_feats: torch.Tensor,
    geom_feats: torch.Tensor,
    interval_starts: torch.Tensor,
    interval_lengths: torch.Tensor,
    batch_size: int,
    grid_cells_z: int,
    grid_cells_x: int,
    grid_cells_y: int,
    cells_sorted: bool = True,
) -> torch.Tensor:
    """Cumulative-sum pooling onto a 3D voxel grid (differentiable).

    Args:
        image_feats: input image features (num_points, channels).
        geom_feats: input coordinates (num_points, 4) as (x, y, z, batch).
        interval_starts: first point index of each pooled interval.
        interval_lengths: number of points in each pooled interval.
        batch_size / grid_cells_z / grid_cells_x / grid_cells_y: grid dims.
        cells_sorted: intervals arrive in ascending flattened-cell order and
            are disjoint (the BEVFusion quick-cumsum construction, which
            sorts points by cell rank before deriving intervals). Selects
            K13a / K13b on CUDA; pass False for arbitrary order (plain torch).

    Returns:
        (batch_size, grid_z, grid_x, grid_y, channels) pooled features;
        differentiable wrt ``image_feats`` (``torch.autograd.Function``).
    """
    return bev_pool_launcher(
        image_feats,
        geom_feats,
        interval_starts,
        interval_lengths,
        batch_size,
        grid_cells_z,
        grid_cells_x,
        grid_cells_y,
        cells_sorted,
    )


def bev_pool_backward(
    grad_output: torch.Tensor,
    geom_feats: torch.Tensor,
    interval_starts: torch.Tensor,
    interval_lengths: torch.Tensor,
    cells_sorted: bool = True,
) -> torch.Tensor:
    """Explicit backward pass: each cell's gradient broadcast to its points."""
    num_points = geom_feats.shape[0]
    return _bev_pool_backward(
        grad_output, geom_feats, interval_starts, interval_lengths, num_points, cells_sorted=cells_sorted,
    )
