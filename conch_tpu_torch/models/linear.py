# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Quantization-polymorphic linear layers (counterpart of ``conch_tpu/models/linear.py``).

The port has two kinds so far:

- ``dense``: a plain matrix product, which the JAX package leaves to XLA
  (``jnp.dot``) and the port leaves to ``torch.matmul``;
- ``int4``: GPTQ-style uint4b8 codes, group 128, in the magic packing
  (``utils/quant_utils.py:pack_rows_magic``) with bf16 scales, multiplied
  by the K1 kernel (``ops/quantization/gemm.py``). Stacked (L, K/8, N)
  weights are read at a layer offset, never sliced.

The other kinds (int8_grouped, nf4, w8a8) need the GEMM kernels of later
slices and raise.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from conch_tpu_torch.kernels.common import round_up
from conch_tpu_torch.ops.quantization import mixed_precision_gemm
from conch_tpu_torch.types.scalar_type import scalar_types
from conch_tpu_torch.utils.quant_utils import pack_rows_magic, quantize_weights


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


@dataclass
class QuantizedLinear:
    """A (K, N) projection, or a per-layer stack of them: (L, K, N)."""

    kind: str
    arrays: dict[str, torch.Tensor] = field(default_factory=dict)
    meta: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.kind not in ("dense", "int4"):
            msg = f"QuantizedLinear kind {self.kind!r} needs the quantized GEMM kernels (K1b/K1c/K8), which are not ported yet"
            raise NotImplementedError(msg)

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
        if w.shape[0] % group_size or group_size % 8:
            msg = (
                f"K={w.shape[0]} with group {group_size} needs the planar or GPTQ-row int4 layouts (K1b/K1c), "
                "which are not ported yet"
            )
            raise NotImplementedError(msg)
        _, w_q, w_s = quantize_weights(w, scalar_types.uint4b8, group_size)
        meta = {"bits": 4, "bias": 8, "group_size": group_size, "layout": "magic"}
        if n_pad != n:
            meta["out_features"] = n
        return QuantizedLinear("int4", {"packed": pack_rows_magic(w_q, group_size), "scales": w_s.to(dtype)}, meta)

    def _gemm(self, x: torch.Tensor, layer_index: int | None) -> torch.Tensor:
        out = mixed_precision_gemm(
            x, self.arrays["packed"], self.arrays["scales"], None, self.meta["bits"], self.meta["bias"],
            self.meta["group_size"], layout=self.meta.get("layout", "gptq"), layer_index=layer_index,
        )
        n = self.meta.get("out_features")
        return out if n is None else out[:, :n]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ W`` for (tokens, K) activations, in x's dtype (accumulated
        in f32, as the JAX package and cuBLAS do)."""
        if self.kind == "int4":
            return self._gemm(x, None)
        return torch.matmul(x, self.arrays["w"].to(x.dtype))

    def apply_stacked(self, x: torch.Tensor, layer_index: int) -> torch.Tensor:
        """``x @ W[layer_index]`` for a stacked (L, ...) weight: the layer is
        a view (dense) or a pointer offset (int4), so nothing is copied."""
        if self.kind == "int4":
            return self._gemm(x, layer_index)
        return torch.matmul(x, self.arrays["w"][layer_index].to(x.dtype))

    @staticmethod
    def concat_n(qls: list[QuantizedLinear]) -> QuantizedLinear:
        """Concatenate projections along N: ``[x@W1 | x@W2 | ...]``.

        Every array keeps N as its last axis (the magic packing interleaves
        rows within a column only), so concatenating each array on its
        last axis equals packing the concatenated weight. Raises
        ValueError for pieces that cannot fuse: mixed kinds or metadata, or
        pack-time N padding (padded columns would land mid-concat).
        """
        if not qls:
            raise ValueError("concat_n needs at least one projection")
        first = qls[0]
        if any(q.kind != first.kind or q.meta != first.meta for q in qls):
            raise ValueError("concat_n requires one storage kind and identical metadata")
        if "out_features" in first.meta:
            raise ValueError("concat_n does not support pack-time-padded projections")
        arrays = {k: torch.cat([q.arrays[k] for q in qls], dim=-1) for k in first.arrays}
        return QuantizedLinear(first.kind, arrays, dict(first.meta))


def quantize_linear(w: torch.Tensor, mode: str, **kwargs) -> QuantizedLinear:
    """Build a QuantizedLinear from a dense (K, N) weight by mode name."""
    if mode in ("bf16", "dense", "none"):
        return QuantizedLinear.dense(w.to(torch.bfloat16))
    if mode == "int4":
        return QuantizedLinear.int4_from_dense(w, **kwargs)
    if mode in ("int8", "nf4", "w8a8"):
        msg = f"quantization mode {mode!r} needs the quantized GEMM kernels (K1b/K1c/K8), which are not ported yet"
        raise NotImplementedError(msg)
    msg = f"Unknown quantization mode: {mode}"
    raise ValueError(msg)
