# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Non-maximum suppression: the CUDA kernel K13c and its launcher.

Counterpart of ``conch_tpu/kernels/vision/nms.py``. ``csrc/nms.cu``
replaces ``_nms_kernel``: the greedy keep mask over score-sorted f32
boxes, with the TPU kernel's f32 IoU arithmetic rounded operation by
operation. ``nms_keep_mask_launcher`` takes the plain version
(``conch_tpu_torch/reference/vision/vision.py:nms_keep_mask``) only for
CPU tensors; on CUDA it launches the kernel or raises. The sort, the f32
cast, the areas and the final gather are plain torch around it, as they
are XLA around the TPU kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from conch_tpu_torch.kernels.common import cdiv, check_launch, kernel_function, require_cuda, stream_of
from conch_tpu_torch.reference.vision.vision import nms_keep_mask as nms_keep_mask_plain

_TILE = 64  # boxes per 64-bit mask word (csrc/nms.cu: kNmsTile)
MAX_BOXES = 6144 * _TILE  # the scan's removed bitmap, 8 bytes a word, fits in 48 KB of shared memory


def nms_keep_mask_launcher(
    x1: torch.Tensor, y1: torch.Tensor, x2: torch.Tensor, y2: torch.Tensor, area: torch.Tensor, iou_threshold: float,
) -> torch.Tensor:
    """(N,) bool keep mask over N score-sorted boxes given as five (N,) f32
    tensors. K13c on CUDA (``launches`` counts its launches), the plain
    version on the CPU."""
    parts = (x1, y1, x2, y2, area)
    if any(t.dim() != 1 or t.shape != x1.shape or t.dtype != torch.float32 for t in parts):
        msg = "nms keep mask: x1, y1, x2, y2 and area must be (N,) float32 tensors"
        raise ValueError(msg)
    if x1.device.type == "cpu":
        return nms_keep_mask_plain(*parts, iou_threshold)
    require_cuda(*parts)
    n = x1.numel()
    if n > MAX_BOXES:
        msg = f"nms keep mask kernel: at most {MAX_BOXES} boxes, got {n}"
        raise NotImplementedError(msg)
    keep = torch.empty(n, dtype=torch.bool, device=x1.device)
    if n == 0:
        return keep
    parts = tuple(t.contiguous() for t in parts)
    mask = torch.empty((n, cdiv(n, _TILE)), dtype=torch.int64, device=x1.device)
    fn = kernel_function("conch_nms_keep_mask", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ))
    code = fn(*(t.data_ptr() for t in parts), n, float(np.float32(iou_threshold)), mask.data_ptr(), keep.data_ptr(),
              stream_of(x1))
    check_launch("conch_nms_keep_mask", code)
    nms_keep_mask_launcher.launches += 1
    return keep


nms_keep_mask_launcher.launches = 0


def sorted_boxes(boxes: torch.Tensor, scores: torch.Tensor) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """(descending-score order, (x1, y1, x2, y2, area) of the sorted boxes in
    f32): ``jnp.argsort(-scores)`` is stable, and the area is
    ``(x2 - x1) * (y2 - y1)`` in f32, as XLA computes it around the kernel."""
    order = torch.argsort(-scores, stable=True)
    sb = boxes[order].to(torch.float32)
    x1, y1, x2, y2 = (sb[:, k].contiguous() for k in range(4))
    return order, (x1, y1, x2, y2, (x2 - x1) * (y2 - y1))


def nms_launcher(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Kept indices (int32) in descending score order.

    Args:
        boxes: (N, 4) in (x1, y1, x2, y2) format.
        scores: (N,).
        iou_threshold: suppression threshold, compared in f32.
    """
    order, parts = sorted_boxes(boxes, scores)
    keep = nms_keep_mask_launcher(*parts, iou_threshold)
    return order[keep].to(torch.int32)
