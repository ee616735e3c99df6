# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Quantization-polymorphic linear layers (counterpart of ``conch_tpu/models/linear.py``).

A projection's ``kind`` picks its product:

- ``dense``: a plain matrix product, which the JAX package leaves to XLA
  (``jnp.dot``) and the port leaves to ``torch.matmul``;
- ``int4``: GPTQ-style uint4b8 codes with bf16 group scales, in the
  fastest packing the shape allows (``_pack_grouped``): magic (K1, groups
  32, 64 and 128 on the card), else planar (K1b), else GPTQ rows (K1c);
- ``int8_grouped``: uint8b128 codes, group 128 by default (DeepSeek's 32),
  bf16 scales, planar (K1b; on the card a group of a multiple of 8 word
  rows, so any multiple of 32) or GPTQ rows (K1c);
- ``nf4``: NF4 codes (encoded by K12q) in GPTQ rows with f32 absmax per
  ``blocksize`` rows of K, multiplied through the 16-entry codebook (K1c);
- ``w8a8``: per-column int8 weights with f32 scales, the activations
  quantized per row to int8 on the fly (plain torch, outside any kernel as
  in the JAX package), multiplied by K8.

Stacked (L, ...) weights are read at a layer offset, never sliced.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from conch_tpu_torch.kernels.common import round_up
from conch_tpu_torch.kernels.quantization.bitsandbytes.blockwise import NF4_CODE
from conch_tpu_torch.ops.quantization import mixed_precision_gemm, scaled_gemm
from conch_tpu_torch.ops.quantization.bitsandbytes import quantize_4bit
from conch_tpu_torch.types.scalar_type import scalar_types
from conch_tpu_torch.utils.quant_utils import (
    get_pack_factor,
    pack_rows,
    pack_rows_magic,
    pack_rows_planar,
    quantize_weights,
)

KINDS = ("dense", "int4", "int8_grouped", "nf4", "w8a8")


def padded_out_features(n: int) -> int:
    """N rounded up to a multiple of 128 and, for wide N whose largest
    128-multiple divisor up to 2048 is below 1024, to a multiple of 2048;
    as ``conch_tpu.models.linear.padded_out_features``, so packed weights
    carried across keep their shapes."""
    n128 = round_up(n, 128)
    best = max(d for d in range(128, min(n128, 2048) + 1, 128) if n128 % d == 0)
    if best >= 1024 or n <= 4096:
        return n128
    return round_up(n, 2048)


def _pack_grouped(w_q: torch.Tensor, num_bits: int, group_size: int) -> tuple[torch.Tensor, str]:
    """The fastest packing the shape allows, as the JAX package picks it:
    magic (4-bit) > planar > GPTQ rows."""
    epp = get_pack_factor(num_bits)
    if num_bits == 4 and w_q.shape[0] % group_size == 0 and group_size % 8 == 0:
        return pack_rows_magic(w_q, group_size), "magic"
    if w_q.shape[0] % group_size == 0 and group_size % epp == 0:
        return pack_rows_planar(w_q, num_bits, group_size), "planar"
    return pack_rows(w_q, num_bits), "gptq"


@dataclass
class QuantizedLinear:
    """A (K, N) projection, or a per-layer stack of them: (L, K, N)."""

    kind: str
    arrays: dict[str, torch.Tensor] = field(default_factory=dict)
    meta: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            msg = f"Unknown linear kind: {self.kind} (expected one of {KINDS})"
            raise ValueError(msg)

    @staticmethod
    def dense(w: torch.Tensor) -> QuantizedLinear:
        return QuantizedLinear("dense", {"w": w})

    @staticmethod
    def int4_from_dense(w: torch.Tensor, group_size: int = 128, dtype: torch.dtype = torch.bfloat16) -> QuantizedLinear:
        """uint4b8 groupwise quantization of a (K, N) weight, on w's device.

        N is padded to ``padded_out_features(N)`` with zero columns (their
        scale is 0), and ``meta["out_features"]`` keeps the true N.
        """
        group_size = min(group_size, w.shape[0])  # small K: one group spans all of K
        w = w.to(torch.float32)
        n = w.shape[1]
        n_pad = padded_out_features(n)
        if n_pad != n:
            w = torch.nn.functional.pad(w, (0, n_pad - n))
        _, w_q, w_s = quantize_weights(w, scalar_types.uint4b8, group_size)
        packed, layout = _pack_grouped(w_q, 4, group_size)
        meta = {"bits": 4, "bias": 8, "group_size": group_size, "layout": layout}
        if n_pad != n:
            meta["out_features"] = n
        return QuantizedLinear("int4", {"packed": packed, "scales": w_s.to(dtype)}, meta)

    @staticmethod
    def int8_grouped_from_dense(
        w: torch.Tensor, group_size: int = 128, dtype: torch.dtype = torch.bfloat16
    ) -> QuantizedLinear:
        """uint8b128 groupwise quantization of a (K, N) weight, on w's device
        (N is not padded, as in the JAX package)."""
        group_size = min(group_size, w.shape[0])
        _, w_q, w_s = quantize_weights(w.to(torch.float32), scalar_types.uint8b128, group_size)
        packed, layout = _pack_grouped(w_q, 8, group_size)
        return QuantizedLinear(
            "int8_grouped",
            {"packed": packed, "scales": w_s.to(dtype)},
            {"bits": 8, "bias": 128, "group_size": group_size, "layout": layout},
        )

    @staticmethod
    def nf4_from_dense(w: torch.Tensor, blocksize: int = 64, dtype: torch.dtype = torch.bfloat16) -> QuantizedLinear:
        """NF4 blockwise quantization of a (K, N) weight, on w's device.

        As the JAX package does it: the weight is rounded to ``dtype`` and
        transposed, so each block of ``blocksize`` is one (column, K-group)
        pair; K12q encodes it (``quantize_4bit``); the codes, turned back to
        (K, N), are packed as GPTQ rows ((K // 8, N) int32) beside the
        (K // blocksize, N) f32 absmax.
        """
        k_dim, n_dim = w.shape
        if k_dim % blocksize:
            msg = f"nf4 requires K ({k_dim}) divisible by blocksize ({blocksize})"
            raise ValueError(msg)
        wt = w.to(torch.float32).t().to(dtype).contiguous()
        packed_flat, state = quantize_4bit(wt, blocksize=blocksize, quant_type="nf4")
        del wt
        octets = packed_flat.reshape(-1)
        codes = torch.stack([octets >> 4, octets & 0x0F], dim=1).reshape(n_dim, k_dim)  # even element: high nibble
        absmax = state.absmax.reshape(n_dim, k_dim // blocksize).t().contiguous()
        return QuantizedLinear(
            "nf4",
            {"packed": pack_rows(codes.t(), 4), "absmax": absmax},
            {"shape": (k_dim, n_dim), "blocksize": blocksize, "dtype": str(dtype).removeprefix("torch.")},
        )

    @staticmethod
    def w8a8_from_dense(w: torch.Tensor) -> QuantizedLinear:
        """Per-column symmetric int8 quantization of a (K, N) weight (W8A8),
        on w's device; the activations are quantized per row in ``apply``."""
        w = w.to(torch.float32)
        # A 0-dim divisor on w's device: CUDA turns a Python scalar divisor
        # into a product with its reciprocal (see ``quantize_weights``).
        scales = torch.clamp_min(w.abs().amax(dim=0) / w.new_full((), 127.0), 1e-8)  # (N,)
        w8 = torch.clamp(torch.round(w / scales), -127, 127).to(torch.int8)
        return QuantizedLinear("w8a8", {"w8": w8, "out_scales": scales}, {})

    def _product(self, x: torch.Tensor, layer_index: int | None) -> torch.Tensor:
        if self.kind in ("int4", "int8_grouped"):
            out = mixed_precision_gemm(
                x, self.arrays["packed"], self.arrays["scales"], None, self.meta["bits"], self.meta["bias"],
                self.meta["group_size"], layout=self.meta.get("layout", "gptq"), layer_index=layer_index,
            )
            n = self.meta.get("out_features")
            return out if n is None else out[:, :n]
        if self.kind == "nf4":
            return mixed_precision_gemm(
                x, self.arrays["packed"], self.arrays["absmax"], None, 4, 0, self.meta["blocksize"],
                codebook=NF4_CODE, layer_index=layer_index,
            )
        if self.kind == "w8a8":
            # Dynamic per-row activation quantization, as the JAX package:
            # a division (not a reciprocal: the divisor a 0-dim tensor, as
            # in ``w8a8_from_dense``), rounding half to even.
            xf = x.to(torch.float32)
            a_scale = torch.clamp_min(xf.abs().amax(dim=-1), 1e-8) / xf.new_full((), 127.0)
            xq = torch.clamp(torch.round(xf / a_scale[:, None]), -127, 127).to(torch.int8)
            return scaled_gemm(
                xq, self.arrays["w8"], a_scale, self.arrays["out_scales"], x.dtype, layer_index=layer_index
            )
        w = self.arrays["w"] if layer_index is None else self.arrays["w"][layer_index]
        return torch.matmul(x, w.to(x.dtype))

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ W`` for (tokens, K) activations, in x's dtype (accumulated
        in f32, as the JAX package and cuBLAS do)."""
        return self._product(x, None)

    def apply_stacked(self, x: torch.Tensor, layer_index: int) -> torch.Tensor:
        """``x @ W[layer_index]`` for a stacked (L, ...) weight: the layer is
        a view (dense) or a pointer offset (the kernels), so nothing is
        copied."""
        return self._product(x, layer_index)

    def take_layer(self, layer_index: int) -> QuantizedLinear:
        """One layer of stacked (L, ...) arrays, as views (``apply_stacked``
        needs none)."""
        return QuantizedLinear(self.kind, {k: v[layer_index] for k, v in self.arrays.items()}, dict(self.meta))

    @staticmethod
    def concat_n(qls: list[QuantizedLinear]) -> QuantizedLinear:
        """Concatenate projections along N: ``[x@W1 | x@W2 | ...]``.

        Every array keeps N as its last axis (the packings interleave rows
        within a column only; w8a8's ``w8`` and ``out_scales`` are per
        column), so concatenating each array on its last axis equals
        quantizing the concatenated weight. Raises ValueError for pieces
        that cannot fuse: mixed kinds or metadata, pack-time N padding
        (padded columns would land mid-concat), or a pinned ``shape`` (nf4,
        which the JAX package leaves unfused).
        """
        if not qls:
            raise ValueError("concat_n needs at least one projection")
        first = qls[0]
        if any(q.kind != first.kind or q.meta != first.meta for q in qls):
            raise ValueError("concat_n requires one storage kind and identical metadata")
        if "out_features" in first.meta or "shape" in first.meta:
            raise ValueError("concat_n does not support pack-time-padded or shape-pinned projections")
        arrays = {k: torch.cat([q.arrays[k] for q in qls], dim=-1) for k in first.arrays}
        return QuantizedLinear(first.kind, arrays, dict(first.meta))


def cast_dense_head(params: dict, dtype: torch.dtype) -> dict:
    """``params`` with a dense ``lm_head`` held in ``dtype`` (the
    activations') where that keeps its size, as for an int4 model's bf16
    head under f16 activations; else ``params`` as they are.

    ``apply`` casts a dense weight to x's dtype at every call, as the JAX
    package does (``w.astype(x.dtype)``), so converting once at load gives
    the same values, and a step no longer converts the whole head
    (Qwen2-7B's 3584 x 152064: 1.1 GB read and 1.1 GB written a step).
    """
    head = params.get("lm_head")
    if not isinstance(head, QuantizedLinear) or head.kind != "dense":
        return params
    w = head.arrays["w"]
    if w.dtype == dtype or w.dtype.itemsize != dtype.itemsize:
        return params
    return {**params, "lm_head": QuantizedLinear.dense(w.to(dtype))}


def quantize_linear(w: torch.Tensor, mode: str, **kwargs) -> QuantizedLinear:
    """Build a QuantizedLinear from a dense (K, N) weight by mode name."""
    if mode in ("bf16", "dense", "none"):
        return QuantizedLinear.dense(w.to(torch.bfloat16))
    if mode == "int4":
        return QuantizedLinear.int4_from_dense(w, **kwargs)
    if mode == "int8":
        return QuantizedLinear.int8_grouped_from_dense(w, **kwargs)
    if mode == "nf4":
        return QuantizedLinear.nf4_from_dense(w, **kwargs)
    if mode == "w8a8":
        return QuantizedLinear.w8a8_from_dense(w, **kwargs)
    msg = f"Unknown quantization mode: {mode}"
    raise ValueError(msg)
