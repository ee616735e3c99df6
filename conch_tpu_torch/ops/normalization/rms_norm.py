# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""RMS norm public op (counterpart of ``conch_tpu/ops/normalization/rms_norm.py``).

Up to 128 rows this is plain PyTorch, as the JAX package computes it
outside any kernel on a chip; above that the K4 kernel is needed and the
op raises.
"""

from __future__ import annotations

import torch

from conch_tpu_torch.ops.common import check_small_op


def rms_norm(x: torch.Tensor, weight: torch.Tensor, epsilon: float) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps)`` in f32, cast to x's dtype, times the weight."""
    hidden_size = x.shape[-1]
    check_small_op(x.numel() // hidden_size, "rms_norm", "K4, conch_tpu/kernels/normalization/rms_norm.py:_rms_norm_kernel")
    xf = x.float()
    normalized = (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + epsilon)).to(x.dtype)
    return normalized * weight.to(x.dtype)
