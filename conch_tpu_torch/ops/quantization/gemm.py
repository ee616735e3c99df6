# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""GEMM public ops: mixed-precision and scaled matrix products
(counterpart of ``conch_tpu/ops/quantization/gemm.py``).

``mixed_precision_gemm`` sends each packed layout to its kernel: ``magic``
to K1, ``planar`` to K1b, ``gptq`` (rows, and the codebook formats) to
K1c, with the JAX launcher's layout checks. ``scaled_gemm`` runs K8 and
adds the bias. Shapes a kernel does not cover raise on CUDA; on the CPU
every kernel's plain version covers them. ``create_mixed_precision_metadata``
and ``create_scaled_metadata`` validate (with ``strict``, JAX's checks and
error types) and deduce the metadata, as the JAX ops do; the dataclasses
and enums they return are the port's own copies of JAX's.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import torch

from conch_tpu_torch.kernels.quantization.gemm import (
    mixed_gemm_magic_launcher,
    mixed_gemm_planar_launcher,
    mixed_gemm_rows_launcher,
    scaled_gemm_launcher,
)
from conch_tpu_torch.utils.quant_utils import get_pack_factor

__all__ = [
    "ChannelScaleMode",
    "MixedPrecisionMatmulMetadata",
    "ScaledMatmulMetadata",
    "WeightGroupMode",
    "create_mixed_precision_metadata",
    "create_scaled_metadata",
    "mixed_precision_gemm",
    "scaled_gemm",
]

LAYOUTS = ("gptq", "planar", "magic")
_EXPECTED_RANK = 2


class WeightGroupMode(enum.Enum):
    """Dequantization weight group modes (as ``conch_tpu``'s)."""

    NONE = 0
    SHIFT = 1
    SYMMETRIC_NO_SHIFT = 2
    SYMMETRIC_WITH_SHIFT = 3
    ASYMMETRIC = 4


class ChannelScaleMode(enum.Enum):
    """Epilogue channel-scaling modes (as ``conch_tpu``'s)."""

    NONE = 0
    WEIGHT_ONLY = 1
    ACTIVATION_ONLY = 2
    WEIGHT_AND_ACTIVATION = 3


@dataclass
class MixedPrecisionMatmulMetadata:
    """Metadata for the mixed-precision GEMM."""

    m_dim: int
    k_dim: int
    n_dim: int
    weight_size_bits: int
    weight_bias: int
    group_size: int
    elements_per_sample: int
    zero_is_scalar: bool
    unpack_mask: int
    input_dtype: torch.dtype
    output_dtype: torch.dtype
    acc_dtype: torch.dtype
    meta_dtype: torch.dtype
    channel_scale_mode: ChannelScaleMode
    weight_group_mode: WeightGroupMode


@dataclass
class ScaledMatmulMetadata:
    """Metadata for the scaled GEMM."""

    m_dim: int
    k_dim: int
    n_dim: int
    input_dtype: torch.dtype
    output_dtype: torch.dtype
    acc_dtype: torch.dtype
    meta_dtype: torch.dtype
    channel_scale_mode: ChannelScaleMode
    weight_group_mode: WeightGroupMode


def create_mixed_precision_metadata(
    x: torch.Tensor,
    w_q_packed: torch.Tensor,
    w_s: torch.Tensor,
    w_zp: torch.Tensor | None,
    weight_size_bits: int,
    weight_bias: int,
    group_size: int,
    *,
    output_dtype: torch.dtype | None = None,
    acc_dtype: torch.dtype | None = None,
    meta_dtype: torch.dtype | None = None,
    scaled_activations: bool = False,
    strict: bool = False,
) -> MixedPrecisionMatmulMetadata:
    """Verify shapes and dtypes (``strict``) and deduce the metadata, as
    ``conch_tpu.ops.quantization.gemm.create_mixed_precision_metadata``."""
    if strict:
        for name, t in (("x", x), ("w_q_packed", w_q_packed), ("w_s", w_s)):
            if t.dim() != _EXPECTED_RANK:
                msg = f"Unexpected number of dimensions of input tensor {name}: {t.dim()}"
                raise ValueError(msg)
        if w_zp is not None and w_zp.numel() > 1 and w_zp.dim() != _EXPECTED_RANK:
            msg = f"Unexpected number of dimensions of input tensor w_zp: {w_zp.dim()}"
            raise ValueError(msg)
        if w_q_packed.dtype not in (torch.int32, torch.uint32):
            msg = f"Invalid datatype for packed weights: {w_q_packed.dtype}"
            raise ValueError(msg)
        if scaled_activations:
            msg = "Scaled activations not yet implemented"
            raise NotImplementedError(msg)
    m_dim, k_dim = x.shape
    n_dim = w_q_packed.shape[1]
    zero_is_scalar = False if w_zp is None else w_zp.numel() == 1
    if strict:
        expected = (k_dim // group_size, n_dim)
        if tuple(w_s.shape) != expected:
            msg = f"Invalid w_s shape (expected: {expected}, actual: {tuple(w_s.shape)})"
            raise ValueError(msg)
        if w_zp is not None and not zero_is_scalar and tuple(w_zp.shape) != expected:
            msg = f"Invalid w_zp shape (expected: {expected}, actual: {tuple(w_zp.shape)})"
            raise ValueError(msg)
    return MixedPrecisionMatmulMetadata(
        m_dim=m_dim,
        k_dim=k_dim,
        n_dim=n_dim,
        weight_size_bits=weight_size_bits,
        weight_bias=weight_bias,
        group_size=group_size,
        elements_per_sample=32 // weight_size_bits,
        zero_is_scalar=zero_is_scalar,
        unpack_mask=2**weight_size_bits - 1,
        input_dtype=x.dtype,
        output_dtype=x.dtype if output_dtype is None else output_dtype,
        acc_dtype=torch.float32 if acc_dtype is None else acc_dtype,
        meta_dtype=x.dtype if meta_dtype is None else meta_dtype,
        channel_scale_mode=ChannelScaleMode.NONE,
        weight_group_mode=(
            WeightGroupMode.SYMMETRIC_NO_SHIFT if w_zp is None else WeightGroupMode.SYMMETRIC_WITH_SHIFT
        ),
    )


def mixed_precision_gemm(
    x: torch.Tensor,
    w_q_packed: torch.Tensor,
    w_s: torch.Tensor,
    w_zp: torch.Tensor | None,
    weight_size_bits: int,
    weight_bias: int,
    group_size: int,
    *,
    output_dtype: torch.dtype | None = None,
    acc_dtype: torch.dtype | None = None,
    meta_dtype: torch.dtype | None = None,
    scaled_activations: bool = False,
    strict: bool = False,
    codebook: tuple[float, ...] | None = None,
    layout: str = "gptq",
    layer_index: int | None = None,
) -> torch.Tensor:
    """``x @ dequant(w_q_packed)``: (M, K) activations -> (M, N) in
    ``output_dtype`` (x's dtype by default).

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
        output_dtype: the dtype of the one final rounding of the f32 sums;
            on the card float32 or bfloat16 (the magic layout, K1, float16
            too), any float dtype on the CPU. On the card x is bfloat16
            (K1 also float16, over bf16, f16 or f32 scales: a GPTQ
            checkpoint's float16 as it ships).
        acc_dtype: recorded in the metadata as given, as in JAX, whose
            kernels never read it: every path sums in float32 whatever it
            says.
        meta_dtype: recorded in the metadata, as in JAX; the scales keep
            their own dtype.
        scaled_activations: not implemented (raises, as JAX's strict check).
        strict: JAX's shape and dtype checks, with its error types.
        codebook: a 16-entry value table (NF4, FP4) that the codes index;
            GPTQ rows only.
        layout: ``"gptq"`` (``utils.quant_utils.pack_rows``, K1c),
            ``"planar"`` (``pack_rows_planar``, K1b) or ``"magic"``
            (``pack_rows_magic``, K1).
        layer_index: layer of a stacked weight; the stack is never sliced.
    """
    if scaled_activations:
        msg = "Scaled activations not yet implemented"
        raise NotImplementedError(msg)
    metadata = create_mixed_precision_metadata(
        x,
        w_q_packed[0] if w_q_packed.dim() == 3 else w_q_packed,
        w_s[0] if w_s.dim() == 3 else w_s,
        w_zp,
        weight_size_bits,
        weight_bias,
        group_size,
        output_dtype=output_dtype,
        acc_dtype=acc_dtype,
        meta_dtype=meta_dtype,
        strict=strict,
    )
    out_dtype = metadata.output_dtype
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
        return mixed_gemm_magic_launcher(x, w_q_packed, w_s, group_size, weight_bias, layer_index, out_dtype)
    if layout == "planar":
        return mixed_gemm_planar_launcher(
            x, w_q_packed, w_s, w_zp, weight_size_bits, weight_bias, group_size, layer_index, out_dtype
        )
    return mixed_gemm_rows_launcher(
        x, w_q_packed, w_s, w_zp, weight_size_bits, weight_bias, group_size, codebook, layer_index, out_dtype
    )


def create_scaled_metadata(
    a: torch.Tensor,
    b: torch.Tensor,
    scale_a: torch.Tensor,
    scale_b: torch.Tensor,
    output_dtype: torch.dtype,
    strict: bool = False,
) -> ScaledMatmulMetadata:
    """Verify shapes and dtypes (``strict``) and deduce the metadata, as
    ``conch_tpu.ops.quantization.gemm.create_scaled_metadata``."""
    if strict:
        for name, t in (("a", a), ("b", b)):
            if t.dim() != _EXPECTED_RANK:
                msg = f"Unexpected number of dimensions of input tensor {name}: {t.dim()}"
                raise ValueError(msg)
        if a.dtype != b.dtype:
            msg = f"Input tensors a and b must have the same datatype (a: {a.dtype}, b: {b.dtype})"
            raise ValueError(msg)
    m_dim, k_dim = a.shape
    n_dim = b.shape[1]
    if strict:
        if scale_a.numel() != 1 and scale_a.shape[0] != m_dim:
            msg = f"Invalid scale_a shape (expected: ({m_dim},), actual: {tuple(scale_a.shape)})"
            raise ValueError(msg)
        if scale_b.numel() != 1 and scale_b.shape[0] != n_dim:
            msg = f"Invalid scale_b shape (expected: ({n_dim},), actual: {tuple(scale_b.shape)})"
            raise ValueError(msg)
    return ScaledMatmulMetadata(
        m_dim=m_dim,
        k_dim=k_dim,
        n_dim=n_dim,
        input_dtype=a.dtype,
        output_dtype=output_dtype,
        acc_dtype=torch.float32 if a.dtype.is_floating_point else torch.int32,
        meta_dtype=scale_a.dtype,
        channel_scale_mode=ChannelScaleMode.WEIGHT_AND_ACTIVATION,
        weight_group_mode=WeightGroupMode.NONE,
    )


def scaled_gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    scale_a: torch.Tensor,
    scale_b: torch.Tensor,
    output_dtype: torch.dtype,
    bias: torch.Tensor | None = None,
    strict: bool = False,
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
        strict: JAX's shape and dtype checks (``create_scaled_metadata``),
            on the selected layer of a stack.
    """
    if strict:
        stacked = layer_index is not None
        create_scaled_metadata(
            a, b[layer_index] if stacked else b, scale_a,
            scale_b[layer_index] if stacked and scale_b.dim() == 2 else scale_b, output_dtype, strict=True,
        )
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
