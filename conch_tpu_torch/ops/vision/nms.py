# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""NMS public op (counterpart of ``conch_tpu/ops/vision/nms.py``)."""

from __future__ import annotations

import torch

from conch_tpu_torch.kernels.vision.nms import nms_launcher


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy IoU-based non-maximum suppression (K13c on CUDA).

    Args:
        boxes: (N, 4) boxes in (x1, y1, x2, y2) format.
        scores: (N,) box scores.
        iou_threshold: boxes with IoU above this vs a kept higher-scoring
            box are suppressed.

    Returns:
        int32 indices of kept boxes, sorted by decreasing score.
    """
    if boxes.dim() != 2 or boxes.shape[1] != 4 or scores.shape != boxes.shape[:1]:
        msg = f"nms takes (N, 4) boxes and (N,) scores, got {tuple(boxes.shape)} and {tuple(scores.shape)}"
        raise ValueError(msg)
    if boxes.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.int32, device=boxes.device)
    return nms_launcher(boxes, scores, iou_threshold)
