# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""GeLU-tanh-and-mul public ops (counterpart of ``conch_tpu/ops/activation/gelu_tanh_and_mul.py``).

Every call goes to K10b (``kernels/activation/gelu_tanh_and_mul.py``): the
CUDA kernel for CUDA tensors at any row count, its plain version on the
CPU.
"""

from __future__ import annotations

import torch

from conch_tpu_torch.kernels.activation.gelu_tanh_and_mul import (
    gelu_tanh_and_mul_launcher,
    gelu_tanh_and_mul_parts_launcher,
)


def gelu_tanh_and_mul(x: torch.Tensor) -> torch.Tensor:
    """GeGLU: ``gelu_tanh(x[..., :d]) * x[..., d:]``, the gate in f32 cast back first.

    x is (..., 2d); returns (..., d).
    """
    two_d = x.shape[-1]
    return gelu_tanh_and_mul_launcher(x.reshape(-1, two_d)).reshape(x.shape[:-1] + (two_d // 2,))


def gelu_tanh_and_mul_parts(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``gelu_tanh(gate) * up`` on separate (..., d) halves."""
    d = gate.shape[-1]
    return gelu_tanh_and_mul_parts_launcher(gate.reshape(-1, d), up.reshape(-1, d)).reshape(gate.shape)
