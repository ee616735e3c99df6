# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""GEMM public ops: mixed-precision and scaled matrix products
(counterpart of ``conch_tpu/ops/quantization/gemm.py``).

``mixed_precision_gemm`` sends each packed layout to its kernel: ``magic``
to K1, ``planar`` to K1b, ``gptq`` (rows, and the codebook formats) to
K1c, with the JAX launcher's layout checks. ``scaled_gemm`` runs K8 and
adds the bias. Shapes a kernel does not cover raise on CUDA; on the CPU
every kernel's plain version covers them.
"""

from __future__ import annotations

import torch

from conch_tpu_torch.kernels.quantization.gemm import (
    mixed_gemm_magic_launcher,
    mixed_gemm_planar_launcher,
    mixed_gemm_rows_launcher,
    scaled_gemm_launcher,
)
from conch_tpu_torch.utils.quant_utils import get_pack_factor

LAYOUTS = ("gptq", "planar", "magic")


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
        w_q_packed: (K // pack_factor, N) int32 words, or the per-layer stack
            (L, K // pack_factor, N) with ``layer_index`` selecting the layer.
        w_s: (K // group_size, N) scales ((L, ...) when stacked).
        w_zp: None, one zero-point, or per-group zero-points shaped like
            ``w_s``; they replace ``weight_bias`` in the planar layout and
            come after it in GPTQ rows, as in the JAX package.
        weight_size_bits: 2, 4 or 8 (4 for magic and codebooks).
        weight_bias: subtracted from the unpacked codes (8 for uint4b8,
            128 for uint8b128); ignored with a codebook.
        group_size: quantization group size along K.
        codebook: a 16-entry value table (NF4, FP4) that the codes index;
            GPTQ rows only.
        layout: ``"gptq"`` (``utils.quant_utils.pack_rows``, K1c),
            ``"planar"`` (``pack_rows_planar``, K1b) or ``"magic"``
            (``pack_rows_magic``, K1).
        layer_index: layer of a stacked weight; the stack is never sliced.
    """
    if layout not in LAYOUTS:
        msg = f"unknown layout {layout!r}; expected one of {LAYOUTS}"
        raise ValueError(msg)
    stacked = w_q_packed.dim() == 3
    if stacked != (layer_index is not None):
        msg = "stacked (L, K//pack, N) weights need layer_index, and 2-D weights take none"
        raise ValueError(msg)
    if x.dim() != 2:
        msg = f"x must be (M, K), got {tuple(x.shape)}"
        raise ValueError(msg)
    k = x.shape[-1]
    epp = get_pack_factor(weight_size_bits)
    if w_q_packed.shape[-2] * epp != k:
        msg = f"packed {tuple(w_q_packed.shape)} does not hold K={k} rows of {weight_size_bits}-bit codes"
        raise ValueError(msg)
    if layout == "planar" and (codebook is not None or k % group_size or group_size % epp):
        msg = (
            "planar layout requires a non-codebook format with K % group_size == 0 "
            f"and group_size % pack_factor == 0 (K={k}, group={group_size}, pack={epp}, "
            f"codebook={codebook is not None})"
        )
        raise ValueError(msg)
    if layout == "magic" and (codebook is not None or weight_size_bits != 4 or k % group_size or group_size % 8):
        msg = (
            "magic layout requires 4-bit non-codebook weights with K % group_size == 0 and group_size % 8 == 0 "
            f"(K={k}, group={group_size}, bits={weight_size_bits}, codebook={codebook is not None})"
        )
        raise ValueError(msg)
    groups = -(-k // group_size)
    if tuple(w_s.shape[-2:]) != (groups, w_q_packed.shape[-1]):
        msg = f"w_s {tuple(w_s.shape)} does not match {groups} groups x N={w_q_packed.shape[-1]}"
        raise ValueError(msg)
    if layout == "magic":
        if w_zp is not None:
            msg = "the magic layout with zero-points is not ported yet"
            raise NotImplementedError(msg)
        return mixed_gemm_magic_launcher(x, w_q_packed, w_s, group_size, weight_bias, layer_index)
    if layout == "planar":
        return mixed_gemm_planar_launcher(
            x, w_q_packed, w_s, w_zp, weight_size_bits, weight_bias, group_size, layer_index
        )
    return mixed_gemm_rows_launcher(
        x, w_q_packed, w_s, w_zp, weight_size_bits, weight_bias, group_size, codebook, layer_index
    )


def scaled_gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    scale_a: torch.Tensor,
    scale_b: torch.Tensor,
    output_dtype: torch.dtype,
    bias: torch.Tensor | None = None,
    *,
    layer_index: int | None = None,
) -> torch.Tensor:
    """Scaled GEMM: ``(a @ b) * scale_a * scale_b (+ bias)`` for int8 or
    float8_e4m3fn inputs (K8).

    Args:
        a: (M, K) int8 or float8_e4m3fn activations.
        b: (K, N) weights of a's dtype, or the per-layer stack (L, K, N)
            with ``layer_index`` selecting the layer.
        scale_a: per-row scales (M,) or one value.
        scale_b: per-column scales (N,) ((L, N) when stacked) or one value.
        output_dtype: float32 or bfloat16.
        bias: optional (N,) bias added after the scaling, outside the
            kernel, with torch's type promotion (as jnp's).
    """
    if a.dim() != 2 or b.shape[-2] != a.shape[1] or (b.dim() == 3) != (layer_index is not None):
        msg = f"scaled_gemm: a {tuple(a.shape)} and b {tuple(b.shape)} (layer_index {layer_index}) do not fit"
        raise ValueError(msg)
    if a.dtype != b.dtype:
        msg = f"Input tensors a and b must have the same datatype (a: {a.dtype}, b: {b.dtype})"
        raise ValueError(msg)
    output = scaled_gemm_launcher(a, b, scale_a, scale_b, output_dtype, layer_index)
    if bias is not None:
        output = output + bias
    return output
