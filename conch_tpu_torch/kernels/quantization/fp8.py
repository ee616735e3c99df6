# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Static-scale fp8 (e4m3) quantization: the CUDA kernel (K9) and its plain version.

The kernel is ``csrc/static_quant.cu`` (shared with ``int8.py``); it
replaces ``conch_tpu/kernels/quantization/fp8.py:_static_scaled_fp8_quant_kernel``
and the float8_e4m3fn cast that follows it: ``clip(x * (1 / scale), -448,
448)`` rounded to nearest even, the reciprocal taken in f32 on the card.
``static_scaled_fp8_quant_launcher`` takes the plain version for CPU
tensors only; on CUDA it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from conch_tpu_torch.kernels.quantization.int8 import check_static_quant_inputs, static_quant_cuda
from conch_tpu_torch.reference.quantization.fp8 import scaled_fp8_quant as static_scaled_fp8_quant_plain


def static_scaled_fp8_quant_launcher(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize (tokens, hidden) to float8_e4m3fn with a one-element static
    scale. ``launches`` counts kernel launches."""
    check_static_quant_inputs(x, scale)
    if x.device.type == "cpu":
        return static_scaled_fp8_quant_plain(x, scale)
    out = static_quant_cuda(x, scale, torch.float8_e4m3fn)
    static_scaled_fp8_quant_launcher.launches += 1
    return out


static_scaled_fp8_quant_launcher.launches = 0
