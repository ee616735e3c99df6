# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Gemma RMS norm public op (counterpart of ``conch_tpu/ops/normalization/gemma_rms_norm.py``).

Every call goes to K10a (``kernels/normalization/gemma_rms_norm.py``): the
CUDA kernel for CUDA tensors at any row count, its plain version on the
CPU.
"""

from __future__ import annotations

import torch

from conch_tpu_torch.kernels.normalization.gemma_rms_norm import gemma_rms_norm_launcher


def gemma_rms_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    variance_epsilon: float,
    residual: torch.Tensor | None = None,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Gemma RMS norm: ``x * rsqrt(mean(x^2) + eps) * (1 + w)`` in f32.

    x is (..., hidden); the result has x's shape and dtype. With
    ``residual``, x + residual is normalized and also returned:
    ``(out, x + residual)``.
    """
    if residual is not None:
        x = x + residual
        residual = x
    hidden_size = x.shape[-1]
    out = gemma_rms_norm_launcher(x.reshape(-1, hidden_size), weight, variance_epsilon).reshape(x.shape)
    return out if residual is None else (out, residual)
