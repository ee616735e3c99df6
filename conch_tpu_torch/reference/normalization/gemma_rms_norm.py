# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Golden Gemma RMS norm (counterpart of ``conch_tpu/reference/normalization/gemma_rms_norm.py``).

The whole product ``x * rsqrt(mean(x^2) + eps) * (1 + w)`` is taken in
f32 and cast to x's dtype once at the end (Llama's rms_norm rounds the
normalized value before the weight multiply; Gemma does not).
"""

from __future__ import annotations

import torch


def gemma_rms_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    variance_epsilon: float,
    residual: torch.Tensor | None = None,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Gemma RMS norm over the last axis. With ``residual``, x + residual is
    normalized and returned beside the result: ``(out, x + residual)``."""
    if residual is not None:
        x = x + residual
        residual = x
    xf = x.float()
    inv = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + variance_epsilon)
    out = (xf * inv * (1.0 + weight.float())).to(x.dtype)
    return out if residual is None else (out, residual)
