# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

from conch_tpu_torch.ops.vision.bev_pool import bev_pool, bev_pool_backward
from conch_tpu_torch.ops.vision.nms import nms
from conch_tpu_torch.ops.vision.voxelization import (
    VoxelizationParameter,
    collect_point_features,
    generate_voxels,
    voxelization_stable,
)

__all__ = [
    "VoxelizationParameter",
    "bev_pool",
    "bev_pool_backward",
    "collect_point_features",
    "generate_voxels",
    "nms",
    "voxelization_stable",
]
