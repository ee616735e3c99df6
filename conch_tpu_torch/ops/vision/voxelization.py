# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Voxelization public ops (counterpart of ``conch_tpu/ops/vision/voxelization.py``).

Deterministic, as in the JAX package: voxels are emitted in ascending
flat-key order and points keep their input order within each voxel. Plain
torch on the points' device (the JAX package has no Pallas kernel here).

The two voxelizers compute the voxel coordinate as their JAX counterparts
do, which is not the same way: ``generate_voxels`` multiplies by the f32
reciprocal of the voxel size (the jitted JAX launcher, where XLA rewrites
the division by a constant), ``voxelization_stable`` divides (the eager JAX
function). On points near a voxel boundary the two can disagree, in both
packages alike.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from conch_tpu_torch.kernels.vision.voxelization import f32_tensor, generate_voxels_launcher, voxel_runs


@dataclass
class VoxelizationParameter:
    """Voxel grid parameters."""

    min_range: tuple[float, float, float]
    max_range: tuple[float, float, float]
    voxel_dim: tuple[float, float, float]
    grid_dim: tuple[int, int, int]
    max_num_points_per_voxel: int
    max_num_voxels: int

    def __init__(
        self,
        min_range: tuple[float, float, float],
        max_range: tuple[float, float, float],
        voxel_dim: tuple[float, float, float],
        max_num_points_per_voxel: int,
    ) -> None:
        self.min_range = tuple(min_range)
        self.max_range = tuple(max_range)
        self.voxel_dim = tuple(voxel_dim)
        self.max_num_points_per_voxel = max_num_points_per_voxel
        self.grid_dim = self._compute_grid_dim()
        self.max_num_voxels = self.grid_dim[0] * self.grid_dim[1] * self.grid_dim[2]

    def _compute_grid_dim(self) -> tuple[int, int, int]:
        grid_x = round((self.max_range[0] - self.min_range[0]) / self.voxel_dim[0])
        grid_y = round((self.max_range[1] - self.min_range[1]) / self.voxel_dim[1])
        grid_z = round((self.max_range[2] - self.min_range[2]) / self.voxel_dim[2])
        return (grid_x, grid_y, grid_z)


def generate_voxels(
    points: torch.Tensor, param: VoxelizationParameter
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Voxelize a point cloud.

    Args:
        points: (num_points, 4) with fields x, y, z, <extra>.
        param: voxelization parameters.

    Returns:
        (num_filled_voxels scalar,
         point_features (max_num_voxels, max_pts_per_voxel, 4),
         voxel_indices (max_num_voxels, 4) as (x, y, z, 0),
         num_points_per_voxel (max_num_voxels,) capped counts).
        Rows past num_filled_voxels are zero.
    """
    if points.dim() != 2 or points.shape[1] != 4:
        msg = f"generate_voxels takes (num_points, 4) points, got {tuple(points.shape)}"
        raise ValueError(msg)
    return generate_voxels_launcher(
        points,
        min_range=param.min_range,
        max_range=param.max_range,
        voxel_dim=param.voxel_dim,
        grid_dim=param.grid_dim,
        max_num_points_per_voxel=param.max_num_points_per_voxel,
        max_num_voxels=param.max_num_voxels,
    )


def voxelization_stable(
    points: torch.Tensor, param: VoxelizationParameter
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deterministic voxelization SoA: label each point with its flat voxel
    key, stable-sort by key, run-length encode; max-padded outputs plus a
    filled count.

    The coordinate is ``floor((p - f32(min)) / f32(voxel_dim))``, a true f32
    division by an f32 tensor on the points' device (on the card, a Python
    scalar divisor would become a multiplication by its reciprocal).

    Args:
        points: (num_points, num_features) with x, y, z leading.
        param: voxelization parameters.

    Returns:
        (num_points_per_voxel (max_num_voxels,) int32 — UNCAPPED counts,
         point_indices (num_points,) int32 — original point indices grouped
           by voxel, contiguous segments in ascending flat-key order; slots
           past the total valid-point count hold ``num_points`` (a sentinel),
         flat_voxel_indices (max_num_voxels,) int32 — ascending flat keys,
         num_filled_voxels scalar int32).
        Rows past num_filled_voxels are zero.
    """
    device, num_points = points.device, points.shape[0]
    lo, size = f32_tensor(param.min_range, device), f32_tensor(param.voxel_dim, device)
    v = torch.floor((points[:, :3].float() - lo) / size).to(torch.int32)
    runs = voxel_runs(v, param.grid_dim, param.max_num_voxels)
    point_indices = torch.where(runs.sorted_valid, runs.order, num_points).to(torch.int32)
    flat_voxel_indices = torch.zeros(param.max_num_voxels, dtype=torch.int32, device=device)
    valid_rank = runs.voxel_rank[runs.sorted_valid]  # one key per voxel: duplicate writes agree
    flat_voxel_indices[valid_rank] = runs.sorted_key[runs.sorted_valid]
    return runs.counts, point_indices, flat_voxel_indices, runs.num_filled


def collect_point_features(
    points: torch.Tensor,
    num_points_per_voxel: torch.Tensor,
    point_indices: torch.Tensor,
    param: VoxelizationParameter,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather per-voxel point features from a ``voxelization_stable`` result:
    one (voxel, slot) gather.

    Args:
        points: (num_points, num_features) raw points.
        num_points_per_voxel: (max_num_voxels,) uncapped counts.
        point_indices: (num_points,) grouped original indices (sentinel-padded).
        param: voxelization parameters.

    Returns:
        (point_features (max_num_voxels, max_num_points_per_voxel,
         num_features) float32, zero-filled for empty slots;
         capped_num_points_per_voxel (max_num_voxels,) int32).
    """
    max_pts = param.max_num_points_per_voxel
    counts = num_points_per_voxel.to(torch.int32)
    capped = torch.minimum(counts, torch.tensor(max_pts, dtype=torch.int32, device=counts.device))
    segment_start = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    slots = torch.arange(max_pts, dtype=torch.int32, device=counts.device)
    slot = segment_start[:, None] + slots[None, :]
    in_voxel = slots[None, :] < capped[:, None]
    src = torch.where(in_voxel, slot.clamp(0, point_indices.shape[0] - 1), 0)
    raw_idx = point_indices.long()[src.long()].clamp(0, points.shape[0] - 1)
    feats = points[raw_idx].to(torch.float32)
    point_features = torch.where(in_voxel[:, :, None], feats, 0.0)
    return point_features, capped
