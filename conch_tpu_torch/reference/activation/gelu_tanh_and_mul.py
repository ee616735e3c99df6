# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Golden GeGLU gate (counterpart of ``conch_tpu/reference/activation/gelu_tanh_and_mul.py``).

``gelu_tanh(g) = 0.5 g (1 + tanh(beta (g + kappa g^3)))`` with
``beta = sqrt(2 / pi)`` and ``kappa = 0.044715``, written as the equal
``g * sigmoid(2 beta (g + kappa g^3))`` that the JAX package's kernel
evaluates. The gate is computed in f32 and rounded to the input dtype
before the multiply by ``up`` in that dtype.
"""

from __future__ import annotations

import math

import torch

BETA = math.sqrt(2.0 / math.pi)
KAPPA = 0.044715


def gelu_tanh_and_mul_parts(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``round(gelu_tanh(gate)) * up`` on separate (..., d) halves."""
    g = gate.float()
    return (g * torch.sigmoid(2.0 * BETA * (g + KAPPA * g * g * g))).to(gate.dtype) * up


def gelu_tanh_and_mul(x: torch.Tensor) -> torch.Tensor:
    """The same on fused ``[gate|up]`` halves: (..., 2d) -> (..., d)."""
    d = x.shape[-1] // 2
    return gelu_tanh_and_mul_parts(x[..., :d], x[..., d:])
