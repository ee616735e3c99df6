# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Port NMS (conch_tpu_torch.ops.vision.nms, K13c's plain version on the CPU)
against the JAX package's ``nms`` (its Pallas kernel in interpret mode).

The same numpy boxes and scores go to both; the kept indices must be
identical, as tests/vision_test.py holds the JAX op to its golden.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.ops.vision import nms as jax_nms
from conch_tpu_torch.kernels.vision.nms import nms_keep_mask_launcher
from conch_tpu_torch.ops.vision import nms
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)


def _boxes(rng, n):
    centers = rng.uniform(0, 100, size=(n, 2))
    sizes = rng.uniform(2, 20, size=(n, 2))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], axis=1).astype(np.float32)
    return boxes, rng.uniform(0, 1, size=n).astype(np.float32)


def _both(boxes, scores, threshold):
    before = nms_keep_mask_launcher.launches
    keep = nms(torch.from_numpy(boxes), torch.from_numpy(scores), threshold)
    assert nms_keep_mask_launcher.launches == before  # CPU tensors: the plain version, no launch
    assert keep.dtype == torch.int32
    return keep.numpy(), np.asarray(jax_nms(jnp.asarray(boxes), jnp.asarray(scores), threshold))


@pytest.mark.parametrize("num_boxes", [1, 10, 100, 513])
@pytest.mark.parametrize("iou_threshold", [0.3, 0.7])
def test_nms_matches_jax(num_boxes, iou_threshold, rng):
    keep, ref = _both(*_boxes(rng, num_boxes), iou_threshold)
    np.testing.assert_array_equal(keep, ref)


def test_nms_empty():
    keep = nms(torch.zeros((0, 4)), torch.zeros((0,)), 0.5)
    assert keep.shape == (0,) and keep.dtype == torch.int32


def test_nms_identical_boxes():
    boxes = np.repeat(np.asarray([[0.0, 0.0, 10.0, 10.0]], dtype=np.float32), 5, axis=0)
    scores = np.asarray([0.1, 0.9, 0.5, 0.3, 0.7], dtype=np.float32)
    keep, ref = _both(boxes, scores, 0.5)
    np.testing.assert_array_equal(keep, [1])
    np.testing.assert_array_equal(keep, ref)


def test_nms_score_ties_and_touching_boxes(rng):
    """Tied scores keep the lower index first (a stable sort of -scores);
    boxes on a 5-unit lattice touch or overlap at IoU exactly 1/3, 1/2 and 0."""
    boxes, _ = _boxes(rng, 200)
    boxes[:100] = np.round(boxes[:100] / 5.0) * 5.0
    scores = rng.integers(0, 8, size=200).astype(np.float32) / 8.0
    for threshold in (1.0 / 3.0, 0.5, 0.0):
        keep, ref = _both(boxes, scores, threshold)
        np.testing.assert_array_equal(keep, ref)


@pytest.mark.parametrize("boxes_shape, scores_shape", [((5, 3), (5,)), ((5, 4), (4,)), ((4,), (1,))])
def test_nms_rejects_malformed_input(boxes_shape, scores_shape):
    with pytest.raises(ValueError, match="nms takes"):
        nms(torch.zeros(boxes_shape), torch.zeros(scores_shape), 0.5)
