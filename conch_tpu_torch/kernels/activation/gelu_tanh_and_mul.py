# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""GeLU-tanh-and-mul (GeGLU gate): the CUDA kernel (K10b) and its plain versions.

The kernel is ``csrc/gelu_tanh_and_mul.cu`` on the template it shares with
K6 (``csrc/gated_act.cuh``, launched by ``gated_act.py``); it replaces
``conch_tpu/kernels/activation/gelu_tanh_and_mul.py:_gelu_tanh_and_mul_kernel``
in both of its call forms:

- ``gelu_tanh_and_mul_launcher``: the fused halves of a (T, 2d)
  ``[gate|up]`` input, read in place (no slice copies);
- ``gelu_tanh_and_mul_parts_launcher``: separate (T, d) gate and up.

The gate ``g * sigmoid(2 beta (g + kappa g^3))`` is computed in f32 and
rounded to the dtype (f32, bf16 or f16) before the multiply by up. Each
launcher takes its plain version for CPU tensors only; on CUDA it launches
the kernel or raises, counts its launches in ``.launches`` and, with
``.pdl`` (default True), launches the kernel as a programmatic dependent
of the kernel before it.
"""

from __future__ import annotations

import torch

from conch_tpu_torch.kernels.activation.gated_act import launch_gated_act, split_halves
from conch_tpu_torch.reference.activation.gelu_tanh_and_mul import (
    gelu_tanh_and_mul as gelu_tanh_and_mul_plain,
    gelu_tanh_and_mul_parts as gelu_tanh_and_mul_parts_plain,
)

__all__ = [
    "gelu_tanh_and_mul_launcher",
    "gelu_tanh_and_mul_parts_launcher",
    "gelu_tanh_and_mul_parts_plain",
    "gelu_tanh_and_mul_plain",
]


def gelu_tanh_and_mul_launcher(x: torch.Tensor) -> torch.Tensor:
    """GeGLU over a 2D (T, 2d) input; returns (T, d)."""
    if x.device.type == "cpu":
        return gelu_tanh_and_mul_plain(x)
    gate, up = split_halves("gelu_tanh_and_mul", x)
    out, launched = launch_gated_act("conch_gelu_tanh_and_mul", gate, up, gelu_tanh_and_mul_launcher.pdl, halves=x)
    gelu_tanh_and_mul_launcher.launches += launched
    return out


def gelu_tanh_and_mul_parts_launcher(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """GeGLU on separate 2D (T, d) gate and up; returns (T, d)."""
    if gate.shape != up.shape:
        msg = f"gate {tuple(gate.shape)} and up {tuple(up.shape)} must have one shape"
        raise ValueError(msg)
    if gate.device.type == "cpu":
        return gelu_tanh_and_mul_parts_plain(gate, up)
    out, launched = launch_gated_act(
        "conch_gelu_tanh_and_mul_parts", gate, up, gelu_tanh_and_mul_parts_launcher.pdl
    )
    gelu_tanh_and_mul_parts_launcher.launches += launched
    return out


gelu_tanh_and_mul_launcher.launches = 0
gelu_tanh_and_mul_parts_launcher.launches = 0
gelu_tanh_and_mul_launcher.pdl = True
gelu_tanh_and_mul_parts_launcher.pdl = True
