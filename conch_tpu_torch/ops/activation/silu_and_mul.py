# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""SiLU-and-mul public ops (counterpart of ``conch_tpu/ops/activation/silu_and_mul.py``).

Every call goes to K6 (``kernels/activation/silu_and_mul.py``): the CUDA
kernel for CUDA tensors at any row count, its plain version on the CPU.
"""

from __future__ import annotations

import torch

from conch_tpu_torch.kernels.activation.silu_and_mul import silu_and_mul_launcher, silu_and_mul_parts_launcher


def silu_and_mul(x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``silu(x[..., :d]) * x[..., d:]``, silu in f32 cast back first.

    x is (..., 2d); returns (..., d).
    """
    two_d = x.shape[-1]
    return silu_and_mul_launcher(x.reshape(-1, two_d)).reshape(x.shape[:-1] + (two_d // 2,))


def silu_and_mul_parts(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up`` on separate (..., d) halves."""
    d = gate.shape[-1]
    return silu_and_mul_parts_launcher(gate.reshape(-1, d), up.reshape(-1, d)).reshape(gate.shape)
