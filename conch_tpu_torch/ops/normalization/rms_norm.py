# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""RMS norm public ops (counterpart of ``conch_tpu/ops/normalization/rms_norm.py``).

Every call goes to K4 or K4b (``kernels/normalization/rms_norm.py``): the
CUDA kernel for CUDA tensors at any row count, its plain version on the
CPU. The JAX package sends calls of up to 128 rows to its jnp reference so
that XLA can fuse them on a TPU; the port has no such route, and launch
cost is left to a CUDA graph of the step.
"""

from __future__ import annotations

import torch

from conch_tpu_torch.kernels.normalization.rms_norm import fused_add_rms_norm_launcher, rms_norm_launcher


def rms_norm(x: torch.Tensor, weight: torch.Tensor, epsilon: float) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps)`` in f32, cast to x's dtype, times the weight.

    x is (..., hidden); the result has x's shape and dtype.
    """
    hidden_size = x.shape[-1]
    return rms_norm_launcher(x.reshape(-1, hidden_size), weight, epsilon).reshape(x.shape)


def fused_add_rms_norm(
    x: torch.Tensor,
    residual: torch.Tensor,
    weight: torch.Tensor,
    epsilon: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Residual add fused with RMS norm: ``(rms_norm(x + residual), x + residual)``.

    The functional form of the JAX op: both results are new tensors of x's
    shape and dtype, and neither input is updated.

    Args:
        x: Input tensor, of shape (..., hidden_size).
        residual: Residual tensor, of x's shape.
        weight: Weight tensor, of shape (hidden_size,).
        epsilon: Epsilon value.
    """
    hidden_size = x.shape[-1]
    out, res = fused_add_rms_norm_launcher(
        x.reshape(-1, hidden_size), residual.reshape(-1, hidden_size), weight, epsilon
    )
    return out.reshape(x.shape), res.reshape(x.shape)
