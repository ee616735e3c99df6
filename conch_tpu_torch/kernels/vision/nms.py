# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Non-maximum suppression: the CUDA kernel K13c, its launch plan and its launcher.

Counterpart of ``conch_tpu/kernels/vision/nms.py``. ``csrc/nms.cu``
replaces ``_nms_kernel``: the greedy keep mask over score-sorted f32
boxes, with the TPU kernel's f32 IoU arithmetic rounded operation by
operation. ``nms_keep_mask_launcher`` takes the plain version
(``conch_tpu_torch/reference/vision/vision.py:nms_keep_mask``) only for
CPU tensors; on CUDA it launches the kernel or raises. The sort, the f32
cast, the areas and the final gather are plain torch around it, as they
are XLA around the TPU kernel.

``nms_plan`` lays out the kernel's scratch and its scan from N alone: the
upper triangle of the 64-bit suppression mask in bands (band w: the 64
rows of word w, columns w .. W - 1, rows padded to an even number of
words), each band cut into chunks of ``chunk_words`` columns, chunk-major,
so a chunk is one contiguous run that a TMA bulk copy moves; and the
scan's ring of ``stages`` chunk slots in shared memory beside the removed
bitmap and the mbarriers.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from conch_tpu_torch.kernels.common import cdiv, check_launch, kernel_function, require_cuda, round_up, stream_of
from conch_tpu_torch.reference.vision.vision import nms_keep_mask as nms_keep_mask_plain

TILE = 64  # boxes per 64-bit mask word (csrc/nms.cu: kNmsTile)
CHUNK_WORDS = 64  # a ring slot's columns at most: 64 rows x 64 words, 32 KB
MAX_STAGES = 8  # ring slots at most
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on the H100 (227 KB)
MAX_BOXES = 6144 * TILE  # the scan's removed bitmap (8 bytes a word, 48 KB) beside a ring of 5 slots


@dataclasses.dataclass(frozen=True)
class NmsPlan:
    """K13c's scratch and scan for N boxes: ``words`` = ceil(N / 64); chunks
    of ``chunk_words`` columns (even); a ring of ``stages`` slots of
    ``stage_bytes``; ``smem_bytes`` of dynamic shared memory (the ring, the
    removed bitmap, two kept words, 2 * stages + 4 mbarriers; the entry
    point raises the kernel's limit above 48 KB); ``mask_words`` 64-bit
    words of scratch for the banded triangle."""

    words: int
    chunk_words: int
    stages: int
    stage_bytes: int
    smem_bytes: int
    mask_words: int


def band_row_words(words: int, w: int) -> int:
    """Words in each row of band w: W - w, rounded up to even."""
    return round_up(words - w, 2)


def band_offset(words: int, w: int) -> int:
    """First word of band w in the triangle: 64 times the sum of
    ``band_row_words(words, u)`` for u < w, that is, of m over m = W - w + 1
    .. W plus the odd m among them (csrc/nms.cu: band_offset)."""
    a, b = words - w + 1, words
    return TILE * ((a + b) * w // 2 + (b + 1) // 2 - a // 2)


def nms_plan(n: int) -> NmsPlan:
    """K13c's plan for ``n`` boxes (1 <= n <= MAX_BOXES): a band's rows in
    one chunk while they fit CHUNK_WORDS, else streamed in chunks of
    CHUNK_WORDS; as many ring slots as fit beside the removed bitmap, up to
    MAX_STAGES."""
    if not 1 <= n <= MAX_BOXES:
        msg = f"nms keep mask kernel: 1 to {MAX_BOXES} boxes, got {n}"
        raise NotImplementedError(msg)
    words = cdiv(n, TILE)
    chunk = min(band_row_words(words, 0), CHUNK_WORDS)
    stage_bytes = TILE * chunk * 8
    fixed = 8 * round_up(words, 2) + 16 + 4 * 8  # removed bitmap, kept words, kept and done mbarriers
    stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // (stage_bytes + 2 * 8))  # a slot and its two mbarriers
    smem = fixed + stages * (stage_bytes + 2 * 8)
    return NmsPlan(words=words, chunk_words=chunk, stages=stages, stage_bytes=stage_bytes, smem_bytes=smem,
                   mask_words=band_offset(words, words))


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
    keep = torch.empty(n, dtype=torch.bool, device=x1.device)
    if n == 0:
        return keep
    plan = nms_plan(n)
    parts = tuple(t.contiguous() for t in parts)
    mask = torch.empty(plan.mask_words, dtype=torch.int64, device=x1.device)
    fn = kernel_function("conch_nms_keep_mask", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ))
    code = fn(*(t.data_ptr() for t in parts), n, float(np.float32(iou_threshold)), mask.data_ptr(), keep.data_ptr(),
              plan.chunk_words, plan.stages, plan.smem_bytes, stream_of(x1))
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
