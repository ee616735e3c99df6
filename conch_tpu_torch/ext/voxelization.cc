// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Native C++ baseline for voxelization on the host. One deterministic pass
// emitting voxels in ascending flat-key order, the order of the port's
// sort-based generate_voxels, so outputs compare directly. Built by
// conch_tpu_torch/native.py with g++ at first use.

#include <cmath>
#include <cstdint>
#include <map>
#include <vector>

extern "C" {

// Returns the number of filled voxels. Output arrays are sized
// (max_num_voxels * max_pts * 4), (max_num_voxels * 4), (max_num_voxels)
// and must be zero-initialized by the caller.
int64_t conch_voxelize(
    const float* points,  // (n, 4)
    int64_t num_points,
    float min_x, float min_y, float min_z,
    float voxel_dx, float voxel_dy, float voxel_dz,
    int64_t grid_x, int64_t grid_y, int64_t grid_z,
    int64_t max_points_per_voxel,
    int64_t max_num_voxels,
    float* point_features,    // (max_num_voxels, max_pts, 4)
    int32_t* voxel_indices,   // (max_num_voxels, 4)
    int32_t* num_points_per_voxel) {
  std::map<int64_t, std::vector<int64_t>> voxels;
  for (int64_t i = 0; i < num_points; ++i) {
    const float* p = points + i * 4;
    const int64_t vx = static_cast<int64_t>(std::floor((p[0] - min_x) / voxel_dx));
    const int64_t vy = static_cast<int64_t>(std::floor((p[1] - min_y) / voxel_dy));
    const int64_t vz = static_cast<int64_t>(std::floor((p[2] - min_z) / voxel_dz));
    if (vx < 0 || vx >= grid_x || vy < 0 || vy >= grid_y || vz < 0 || vz >= grid_z) continue;
    const int64_t key = (vz * grid_y + vy) * grid_x + vx;
    voxels[key].push_back(i);
  }

  int64_t out = 0;
  for (const auto& [key, rows] : voxels) {
    if (out >= max_num_voxels) break;
    const int64_t count =
        static_cast<int64_t>(rows.size()) < max_points_per_voxel
            ? static_cast<int64_t>(rows.size())
            : max_points_per_voxel;
    num_points_per_voxel[out] = static_cast<int32_t>(count);
    voxel_indices[out * 4 + 0] = static_cast<int32_t>(key % grid_x);
    voxel_indices[out * 4 + 1] = static_cast<int32_t>((key / grid_x) % grid_y);
    voxel_indices[out * 4 + 2] = static_cast<int32_t>(key / (grid_x * grid_y));
    for (int64_t p = 0; p < count; ++p) {
      const float* src = points + rows[p] * 4;
      float* dst = point_features + (out * max_points_per_voxel + p) * 4;
      dst[0] = src[0]; dst[1] = src[1]; dst[2] = src[2]; dst[3] = src[3];
    }
    ++out;
  }
  return out;
}

}  // extern "C"
