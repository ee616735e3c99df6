# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Gemma RMS norm: the CUDA kernel (K10a) and its plain version.

The kernel is ``csrc/gemma_rms_norm.cu``; it replaces
``conch_tpu/kernels/normalization/gemma_rms_norm.py:_gemma_rms_norm_kernel``.
Both keep ``x * rsqrt(mean(x^2) + eps) * (1 + w)`` in f32 and cast once
(f16 too, as JAX's launcher upcasts it). The weight is first cast to x's
dtype, as the JAX launcher does. ``gemma_rms_norm_launcher`` takes the
plain version for CPU tensors only; on CUDA it launches the kernel, at any
row count and hidden size, or raises.

The launch (``row_norm.py:row_norm_plan``) and the kernel
(``csrc/row_norm.cuh``) are K4's; ``gemma_rms_norm_launcher.pdl`` (default
True) launches the kernel as a programmatic dependent of the kernel before
it.
"""

from __future__ import annotations

import torch

from conch_tpu_torch.kernels.normalization.row_norm import launch_row_norm
from conch_tpu_torch.reference.normalization.gemma_rms_norm import gemma_rms_norm as _reference


def gemma_rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, epsilon: float) -> torch.Tensor:
    """Plain PyTorch version of K10a, on any device."""
    return _reference(x, weight.to(x.dtype), epsilon)


def _gemma_rms_norm_cuda(x: torch.Tensor, weight: torch.Tensor, epsilon: float) -> torch.Tensor:
    out = launch_row_norm("conch_gemma_rms_norm", x, weight, epsilon, gemma_rms_norm_launcher.pdl)
    if x.shape[0]:
        gemma_rms_norm_launcher.launches += 1
    return out


def gemma_rms_norm_launcher(x: torch.Tensor, weight: torch.Tensor, epsilon: float) -> torch.Tensor:
    """Gemma RMS norm over the last axis of a 2D (rows, hidden) input.

    ``launches`` counts kernel launches; ``pdl`` launches the kernel as a
    programmatic dependent.
    """
    if x.device.type == "cpu":
        return gemma_rms_norm_plain(x, weight, epsilon)
    return _gemma_rms_norm_cuda(x, weight, epsilon)


gemma_rms_norm_launcher.launches = 0
gemma_rms_norm_launcher.pdl = True
