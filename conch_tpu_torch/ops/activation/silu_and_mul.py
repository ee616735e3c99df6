# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""SiLU-and-mul public op (counterpart of ``conch_tpu/ops/activation/silu_and_mul.py``).

Up to 128 rows this is plain PyTorch, as the JAX package computes it
outside any kernel on a chip; above that the K6 kernel is needed and the
op raises.
"""

from __future__ import annotations

import torch

from conch_tpu_torch.ops.common import check_small_op


def silu_and_mul(x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``silu(x[..., :d]) * x[..., d:]``, silu in f32 cast back first."""
    two_d = x.shape[-1]
    check_small_op(
        x.numel() // two_d, "silu_and_mul", "K6, conch_tpu/kernels/activation/silu_and_mul.py:_silu_and_mul_kernel"
    )
    d = two_d // 2
    gate = x[..., :d].float()
    return (gate * torch.sigmoid(gate)).to(x.dtype) * x[..., d:]
