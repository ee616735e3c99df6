# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Golden RMS norm and fused residual add + RMS norm (counterpart of
``conch_tpu/reference/normalization/rms_norm.py``).

The squares and the rsqrt are f32, the squares summed in f64 and their
mean rounded once to f32 (so that it does not depend on the order of the
sum, and K4 and K4b equal these bit for bit on the card); the normalized
value is cast back to x's dtype before the weight multiply in that dtype.
These are the plain versions of K4 and K4b
(``kernels/normalization/rms_norm.py``).
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, epsilon: float) -> torch.Tensor:
    """``round(x * rsqrt(mean(x^2) + eps)) * w`` over the last axis, on any device."""
    xf = x.float()
    mean_sq = xf.square().double().mean(dim=-1, keepdim=True).float()
    normalized = (xf * torch.rsqrt(mean_sq + epsilon)).to(x.dtype)
    return normalized * weight.to(x.dtype)


def fused_add_rms_norm(
    x: torch.Tensor, residual: torch.Tensor, weight: torch.Tensor, epsilon: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(rms_norm(x + residual), x + residual)``; the sum is taken in x's
    dtype (rounded once) and both results are new tensors."""
    summed = x + residual
    return rms_norm(summed, weight, epsilon), summed
