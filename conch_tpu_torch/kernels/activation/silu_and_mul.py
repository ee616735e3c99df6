# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""SiLU-and-mul (SwiGLU gate): the CUDA kernel (K6) and its plain versions.

The kernel is ``csrc/silu_and_mul.cu`` on the template it shares with K10b
(``csrc/gated_act.cuh``, launched by ``gated_act.py``); it replaces
``conch_tpu/kernels/activation/silu_and_mul.py:_silu_and_mul_kernel`` in
both of its call forms:

- ``silu_and_mul_launcher``: the fused halves of a (T, 2d) ``[gate|up]``
  input, read in place (no slice copies), as ``_fused_halves_launcher``;
- ``silu_and_mul_parts_launcher``: separate (T, d) gate and up.

silu is computed in f32 and rounded to the dtype (f32, bf16 or f16) before
the multiply by up. Each launcher takes its plain version for CPU tensors
only; on CUDA it launches the kernel or raises, counts its launches in
``.launches`` and, with ``.pdl`` (default True), launches the kernel as a
programmatic dependent of the kernel before it.
"""

from __future__ import annotations

import torch

from conch_tpu_torch.kernels.activation.gated_act import launch_gated_act, split_halves


def silu_and_mul_parts_plain(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K6 on separate halves, on any device."""
    gf = gate.float()
    return (gf * torch.sigmoid(gf)).to(gate.dtype) * up


def silu_and_mul_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K6 on fused ``[gate|up]`` halves."""
    d = x.shape[-1] // 2
    return silu_and_mul_parts_plain(x[..., :d], x[..., d:])


def silu_and_mul_launcher(x: torch.Tensor) -> torch.Tensor:
    """SwiGLU over a 2D (T, 2d) input; returns (T, d)."""
    if x.device.type == "cpu":
        return silu_and_mul_plain(x)
    gate, up = split_halves("silu_and_mul", x)
    out, launched = launch_gated_act("conch_silu_and_mul", gate, up, silu_and_mul_launcher.pdl, halves=x)
    silu_and_mul_launcher.launches += launched
    return out


def silu_and_mul_parts_launcher(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """SwiGLU on separate 2D (T, d) gate and up; returns (T, d)."""
    if gate.shape != up.shape:
        msg = f"gate {tuple(gate.shape)} and up {tuple(up.shape)} must have one shape"
        raise ValueError(msg)
    if gate.device.type == "cpu":
        return silu_and_mul_parts_plain(gate, up)
    out, launched = launch_gated_act("conch_silu_and_mul_parts", gate, up, silu_and_mul_parts_launcher.pdl)
    silu_and_mul_parts_launcher.launches += launched
    return out


silu_and_mul_launcher.launches = 0
silu_and_mul_parts_launcher.launches = 0
silu_and_mul_launcher.pdl = True
silu_and_mul_parts_launcher.pdl = True
