# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Mixed-precision GEMM public op (counterpart of
``conch_tpu/ops/quantization/gemm.py:mixed_precision_gemm``).

This slice ports the int4 magic layout (K1). The planar and GPTQ-row
layouts (K1b), the codebook formats (K1c) and zero-points come with their
kernels and raise until then.
"""

from __future__ import annotations

import torch

from conch_tpu_torch.kernels.quantization.gemm import mixed_gemm_magic_launcher


def mixed_precision_gemm(
    x: torch.Tensor,
    w_q_packed: torch.Tensor,
    w_s: torch.Tensor,
    w_zp: torch.Tensor | None,
    weight_size_bits: int,
    weight_bias: int,
    group_size: int,
    *,
    codebook: tuple[float, ...] | None = None,
    layout: str = "gptq",
    layer_index: int | None = None,
) -> torch.Tensor:
    """``x @ dequant(w_q_packed)``: (M, K) activations -> (M, N) in x's dtype.

    Args:
        x: (M, K) activations.
        w_q_packed: (K // 8, N) int32 words, or the per-layer stack
            (L, K // 8, N) with ``layer_index`` selecting the layer.
        w_s: (K // group_size, N) scales ((L, ...) when stacked).
        w_zp: zero-points; only None (symmetric) is ported.
        weight_size_bits: 4.
        weight_bias: subtracted from the unpacked codes (8 for uint4b8).
        group_size: quantization group size along K.
        codebook: NF4/FP4 tables (K1c), not ported.
        layout: ``"magic"`` (``conch_tpu_torch.utils.quant_utils.pack_rows_magic``);
            ``"planar"`` and ``"gptq"`` (K1b, K1c) are not ported.
        layer_index: layer of a stacked weight; the stack is never sliced.
    """
    if layout != "magic" or codebook is not None:
        msg = (
            f"mixed_precision_gemm layout {layout!r}{' with a codebook' if codebook is not None else ''} needs "
            "kernel K1b (planar/GPTQ rows) or K1c (codebook), which are not ported yet; only 'magic' is"
        )
        raise NotImplementedError(msg)
    if w_zp is not None:
        msg = "mixed_precision_gemm with zero-points is not ported yet"
        raise NotImplementedError(msg)
    if weight_size_bits != 4:
        msg = f"the magic layout holds 4-bit weights, got {weight_size_bits} bits"
        raise ValueError(msg)
    stacked = w_q_packed.dim() == 3
    if stacked != (layer_index is not None):
        msg = "stacked (L, K//8, N) weights need layer_index, and 2-D weights take none"
        raise ValueError(msg)
    k = x.shape[-1]
    if x.dim() != 2 or k % group_size or group_size % 8 or w_q_packed.shape[-2] * 8 != k:
        msg = (
            f"magic layout needs (M, K) x with K % group_size == 0, group_size % 8 == 0 and K // 8 word rows "
            f"(x {tuple(x.shape)}, packed {tuple(w_q_packed.shape)}, group {group_size})"
        )
        raise ValueError(msg)
    if tuple(w_s.shape[-2:]) != (k // group_size, w_q_packed.shape[-1]):
        msg = f"w_s {tuple(w_s.shape)} does not match {k // group_size} groups x N={w_q_packed.shape[-1]}"
        raise ValueError(msg)
    return mixed_gemm_magic_launcher(x, w_q_packed, w_s, group_size, weight_bias, layer_index)
