# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Point-cloud voxelization, sort-based and deterministic: plain torch.

Counterpart of ``conch_tpu/kernels/vision/voxelization.py``, which has no
Pallas kernel (a stable argsort, a run-length encoding, ``cummax`` and
scatters with ``mode="drop"``, all XLA). It runs on whatever device the
points are on, and gives the same outputs on the CPU and on the card.

The voxel coordinate is computed as the jitted JAX function computes it:
XLA rewrites the division by the static voxel size into a multiplication
by its f32 reciprocal, so ``floor((p - f32(min)) * r)`` with ``r =
f32(1) / f32(voxel_dim)`` rounded in f32 on the host, passed as an f32
tensor on the points' device (never a Python float, which torch's CUDA
division would turn into a reciprocal of its own). This differs from a
true division on points near voxel boundaries, and so from
``voxelization_stable`` (``conch_tpu_torch/ops/vision/voxelization.py``),
which divides, as the eager JAX function does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

INT32_MAX = 2**31 - 1


def f32_tensor(values, device: torch.device) -> torch.Tensor:
    """``values`` rounded to f32 on the host, as a tensor on ``device``."""
    return torch.tensor(np.asarray(values, dtype=np.float32), device=device)


class VoxelRuns(NamedTuple):
    """Points sorted by flat voxel key and run-length encoded."""

    order: torch.Tensor  # (num_points,) the stable sort's permutation
    sorted_key: torch.Tensor  # flat keys in sorted order; INT32_MAX for points outside the grid
    sorted_valid: torch.Tensor  # whether each sorted point lies inside the grid
    is_new: torch.Tensor  # whether each sorted point starts a voxel
    voxel_rank: torch.Tensor  # each sorted point's voxel, in ascending key order
    num_filled: torch.Tensor  # scalar int32
    counts: torch.Tensor  # (max_num_voxels,) int32 points per voxel, uncapped


def voxel_runs(v: torch.Tensor, grid_dim: tuple[int, int, int], max_num_voxels: int) -> VoxelRuns:
    """Sort (num_points, 3) int32 voxel coordinates ``v`` by flat key
    ``(z*Y + y)*X + x`` (points outside the grid last) and run-length
    encode the keys, as both JAX voxelizers do."""
    gx, gy, gz = grid_dim
    vx, vy, vz = v.unbind(1)
    valid = (vx >= 0) & (vx < gx) & (vy >= 0) & (vy < gy) & (vz >= 0) & (vz < gz)
    sort_key = torch.where(valid, (vz * gy + vy) * gx + vx, INT32_MAX)
    order = torch.argsort(sort_key, stable=True)
    sorted_key, sorted_valid = sort_key[order], valid[order]
    is_new = sorted_valid.clone()
    is_new[1:] &= sorted_key[1:] != sorted_key[:-1]
    voxel_rank = torch.cumsum(is_new, 0) - 1
    seg = torch.where(sorted_valid, voxel_rank, max_num_voxels).clamp(max=max_num_voxels)
    counts = torch.zeros(max_num_voxels + 1, dtype=torch.int32, device=v.device)
    counts.index_add_(0, seg, sorted_valid.to(torch.int32))
    return VoxelRuns(order, sorted_key, sorted_valid, is_new, voxel_rank, is_new.sum().to(torch.int32),
                     counts[:max_num_voxels])


def generate_voxels_launcher(
    points: torch.Tensor,
    *,
    min_range: tuple[float, float, float],
    max_range: tuple[float, float, float],
    voxel_dim: tuple[float, float, float],
    grid_dim: tuple[int, int, int],
    max_num_points_per_voxel: int,
    max_num_voxels: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deterministic voxelization of (num_points, 4) x/y/z/w points.

    Returns:
        (num_filled_voxels scalar int32, point_features (max_voxels, max_pts,
         4) in the points' dtype, voxel_indices (max_voxels, 4) int32 as (x,
         y, z, 0), num_points_per_voxel (max_voxels,) int32, capped). Rows
         past num_filled are zero.
    """
    del max_range  # the grid's extent is grid_dim, as in the JAX launcher
    device, num_points = points.device, points.shape[0]
    gx, gy, _ = grid_dim
    lo = f32_tensor(min_range, device)
    recip = f32_tensor(np.float32(1) / np.asarray(voxel_dim, dtype=np.float32), device)
    runs = voxel_runs(torch.floor((points[:, :3].float() - lo) * recip).to(torch.int32), grid_dim, max_num_voxels)
    sorted_key, voxel_rank = runs.sorted_key, runs.voxel_rank

    idx = torch.arange(num_points, device=device)
    run_start = torch.cummax(torch.where(runs.is_new, idx, 0), 0).values if num_points else idx
    pos_in_voxel = idx - run_start

    # (voxel_rank, pos) <- sorted point, for the first max_pts points of a
    # voxel; the JAX scatter drops the others (mode="drop").
    write = runs.sorted_valid & (pos_in_voxel < max_num_points_per_voxel) & (voxel_rank < max_num_voxels)
    point_features = torch.zeros((max_num_voxels, max_num_points_per_voxel, 4), dtype=points.dtype, device=device)
    point_features[voxel_rank[write], pos_in_voxel[write]] = points[runs.order][write]
    num_points_per_voxel = runs.counts.clamp(max=max_num_points_per_voxel)

    first_key = torch.zeros(max_num_voxels, dtype=torch.int32, device=device)
    first_key[voxel_rank[write]] = sorted_key[write]  # one key per voxel: duplicate writes agree
    filled = torch.arange(max_num_voxels, device=device) < runs.num_filled
    voxel_indices = torch.stack([
        torch.where(filled, first_key % gx, 0),
        torch.where(filled, (first_key // gx) % gy, 0),
        torch.where(filled, first_key // (gx * gy), 0),
        torch.zeros_like(first_key),
    ], dim=1).to(torch.int32)
    return runs.num_filled, point_features, voxel_indices, num_points_per_voxel
