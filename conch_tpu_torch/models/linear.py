# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Quantization-polymorphic linear layers (counterpart of ``conch_tpu/models/linear.py``).

This slice ports the ``dense`` kind only: a plain matrix product, which
the JAX package leaves to XLA (``jnp.dot``) and the port leaves to
``torch.matmul``. The packed kinds (int4, int8_grouped, nf4, w8a8) need
the GEMM kernels of later slices and raise.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"QuantizedLinear kind {kind!r} needs the quantized GEMM kernels (K1/K8), which are not ported yet"
    )


@dataclass
class QuantizedLinear:
    """A (K, N) projection, or a per-layer stack of them: (L, K, N)."""

    kind: str
    arrays: dict[str, torch.Tensor] = field(default_factory=dict)
    meta: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.kind != "dense":
            raise _not_ported(self.kind)

    @staticmethod
    def dense(w: torch.Tensor) -> QuantizedLinear:
        return QuantizedLinear("dense", {"w": w})

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ W`` for (tokens, K) activations, in x's dtype (the JAX
        package accumulates in f32 and rounds to x's dtype, as cuBLAS does)."""
        return torch.matmul(x, self.arrays["w"].to(x.dtype))

    def apply_stacked(self, x: torch.Tensor, layer_index: int) -> torch.Tensor:
        """``x @ W[layer_index]`` for a stacked (L, K, N) weight: the layer is
        a view, so nothing is copied."""
        return torch.matmul(x, self.arrays["w"][layer_index].to(x.dtype))

    @staticmethod
    def concat_n(qls: list[QuantizedLinear]) -> QuantizedLinear:
        """Concatenate projections along N: ``[x@W1 | x@W2 | ...]``."""
        if not qls:
            raise ValueError("concat_n needs at least one projection")
        if any(q.kind != qls[0].kind or q.meta != qls[0].meta for q in qls):
            raise ValueError("concat_n requires one storage kind and identical metadata")
        return QuantizedLinear("dense", {"w": torch.cat([q.arrays["w"] for q in qls], dim=-1)})
