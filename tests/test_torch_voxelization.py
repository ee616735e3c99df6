# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Port voxelization (conch_tpu_torch.ops.vision) against the JAX package.

The same numpy points go to ``conch_tpu.ops.vision``'s ``generate_voxels``,
``voxelization_stable`` and ``collect_point_features`` and to the port's,
on the CPU; every output must be equal, element for element and in dtype.

The boundary case: points at ``min + k * vd`` and their +-1-ulp neighbours,
at PointPillars' KITTI range and voxel size 0.16. There the jitted JAX
``generate_voxels`` (XLA multiplies by the f32 reciprocal of the voxel
size) and the eager ``voxelization_stable`` (a true division) part ways;
the port must follow each, and the two functions must disagree on the
same voxels in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conch_tpu.ops.vision as jv
import conch_tpu_torch.ops.vision as tv
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

# PointPillars on KITTI (mmdetection3d pointpillars_hv_secfpn_kitti.py).
PILLARS = dict(min_range=(0.0, -39.68, -3.0), max_range=(69.12, 39.68, 1.0), voxel_dim=(0.16, 0.16, 4.0),
               max_num_points_per_voxel=32)
PILLARS_GRID = (432, 496, 1)
SMALL = dict(min_range=(0.0, 0.0, 0.0), max_range=(8.0, 8.0, 4.0), voxel_dim=(1.0, 1.0, 1.0),
             max_num_points_per_voxel=4)


def _params(spec):
    return jv.VoxelizationParameter(**spec), tv.VoxelizationParameter(**spec)


def _assert_equal(jax_outs, torch_outs):
    for a, b in zip(jax_outs, torch_outs, strict=True):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b, a)


def _boundary_points():
    """x and y at min + k * vd (f32) and one ulp either side, z mid-pillar."""
    lo, vd = np.float32(PILLARS["min_range"][1]), np.float32(0.16)
    ys = (lo + np.arange(496, dtype=np.float32) * vd).astype(np.float32)
    ys = np.concatenate([ys, np.nextafter(ys, np.float32(np.inf)), np.nextafter(ys, np.float32(-np.inf))])
    xs = (np.arange(ys.size, dtype=np.float32) % 432 * vd).astype(np.float32)
    down = np.arange(xs.size) % 3 == 0
    down &= xs > 0  # not below x = 0: XLA on the CPU flushes the subnormal neighbour to zero
    xs[down] = np.nextafter(xs[down], np.float32(-np.inf))
    return np.stack([xs, ys, np.full_like(ys, -1.0), np.arange(ys.size, dtype=np.float32)], axis=1)


def test_param_grid_matches_jax():
    pj, pt = _params(PILLARS)
    assert pt.grid_dim == pj.grid_dim == (432, 496, 1)
    assert pt.max_num_voxels == pj.max_num_voxels == 214272


@pytest.mark.parametrize("num_points", [200, 1000])
def test_generate_voxels_matches_jax(rng, num_points):
    pj, pt = _params(SMALL)
    pts = rng.uniform(-1.0, 9.0, size=(num_points, 4)).astype(np.float32)
    _assert_equal(jv.generate_voxels(jnp.asarray(pts), pj), tv.generate_voxels(torch.from_numpy(pts), pt))


def test_generate_voxels_all_out_of_range():
    pj, pt = _params(dict(SMALL, max_range=(4.0, 4.0, 4.0), max_num_points_per_voxel=2))
    pts = np.full((10, 4), -5.0, dtype=np.float32)
    out = tv.generate_voxels(torch.from_numpy(pts), pt)
    assert int(out[0]) == 0 and not out[3].any()
    _assert_equal(jv.generate_voxels(jnp.asarray(pts), pj), out)


@pytest.mark.parametrize("num_features", [4, 5])
def test_voxelization_stable_and_collect_match_jax(rng, num_features):
    pj, pt = _params(SMALL)
    pts = rng.uniform(-1.0, 9.0, size=(300, num_features)).astype(np.float32)
    stable_j = jv.voxelization_stable(jnp.asarray(pts), pj)
    stable_t = tv.voxelization_stable(torch.from_numpy(pts), pt)
    _assert_equal(stable_j, stable_t)
    _assert_equal(jv.collect_point_features(jnp.asarray(pts), stable_j[0], stable_j[1], pj),
                  tv.collect_point_features(torch.from_numpy(pts), stable_t[0], stable_t[1], pt))


def test_pointpillars_cloud_matches_jax(rng):
    """A PointPillars-range cloud (10% out of range) through all three ops."""
    pj, pt = _params(PILLARS)
    pts = np.stack([rng.uniform(-5.0, 75.0, 4000), rng.uniform(-42.0, 42.0, 4000), rng.uniform(-3.5, 1.5, 4000),
                    rng.uniform(0.0, 1.0, 4000)], axis=1).astype(np.float32)
    _assert_equal(jv.generate_voxels(jnp.asarray(pts), pj), tv.generate_voxels(torch.from_numpy(pts), pt))
    stable_j = jv.voxelization_stable(jnp.asarray(pts), pj)
    stable_t = tv.voxelization_stable(torch.from_numpy(pts), pt)
    _assert_equal(stable_j, stable_t)
    _assert_equal(jv.collect_point_features(jnp.asarray(pts), stable_j[0], stable_j[1], pj),
                  tv.collect_point_features(torch.from_numpy(pts), stable_t[0], stable_t[1], pt))


def _disagreement(generated, stable):
    """Voxels (flat keys) that only one voxelizer has, and voxels whose capped
    counts differ between the two."""
    num_filled, _, indices, counts = (np.asarray(o) for o in generated)
    gx, gy, _ = PILLARS_GRID
    keys = {int((z * gy + y) * gx + x): int(c) for (x, y, z, _), c in zip(indices[:num_filled], counts[:num_filled])}
    s_counts, _, s_keys, s_filled = (np.asarray(o) for o in stable)
    s = {int(k): min(int(c), PILLARS["max_num_points_per_voxel"]) for k, c in zip(s_keys[:s_filled], s_counts[:s_filled])}
    return sorted(keys.keys() ^ s.keys()), sorted(k for k in keys.keys() & s.keys() if keys[k] != s[k])


def test_voxel_boundaries_follow_each_jax_function():
    pj, pt = _params(PILLARS)
    pts = _boundary_points()
    gen_j, gen_t = jv.generate_voxels(jnp.asarray(pts), pj), tv.generate_voxels(torch.from_numpy(pts), pt)
    _assert_equal(gen_j, gen_t)
    stable_j, stable_t = jv.voxelization_stable(jnp.asarray(pts), pj), tv.voxelization_stable(torch.from_numpy(pts), pt)
    _assert_equal(stable_j, stable_t)
    only_j, counts_j = _disagreement(gen_j, stable_j)
    only_t, counts_t = _disagreement(gen_t, stable_t)
    assert only_j and counts_j  # the two JAX functions disagree here...
    assert (only_t, counts_t) == (only_j, counts_j)  # ...and the port's on the same voxels

    # The case tells the two ways apart: a division in generate_voxels, or a
    # multiplication in voxelization_stable, would give other coordinates.
    t = torch.from_numpy(pts[:, :3])
    lo = torch.tensor(np.float32(PILLARS["min_range"]))
    vd = torch.tensor(np.float32(PILLARS["voxel_dim"]))
    divided = torch.floor((t - lo) / vd).to(torch.int32)
    multiplied = torch.floor((t - lo) * (1 / vd)).to(torch.int32)
    assert (divided != multiplied).any()


def test_generate_voxels_rejects_malformed_points():
    _, pt = _params(SMALL)
    with pytest.raises(ValueError, match="num_points, 4"):
        tv.generate_voxels(torch.zeros((10, 3)), pt)
