# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Integer storage formats of the quantized weights.

The port's own copy of the part of ``conch_tpu/types/scalar_type.py`` that
the quantized projections need: unsigned integers of up to 8 bits with a
bias (GPTQ-style ``uint4b8`` stores the values -8..7 as the codes 0..15,
``uint8b128`` the values -128..127 as 0..255) and their representable
range. The minifloat formats of the original come with the slices that
use them.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ScalarType:
    """An unsigned integer of ``size_bits`` bits with ``stored = value + bias``."""

    size_bits: int
    bias: int = 0

    @classmethod
    def uint(cls, size_bits: int, bias: int | None = None) -> ScalarType:
        return cls(size_bits, bias or 0)

    def has_bias(self) -> bool:
        return self.bias != 0

    def max(self) -> int:
        """Largest representable value (before bias)."""
        return (1 << self.size_bits) - 1 - self.bias

    def min(self) -> int:
        """Smallest representable value (before bias)."""
        return -self.bias


class scalar_types:  # noqa: N801 - the JAX package's name
    uint4 = ScalarType.uint(4)
    uint8 = ScalarType.uint(8)
    uint2b2 = ScalarType.uint(2, 2)
    uint4b8 = ScalarType.uint(4, 8)
    uint8b128 = ScalarType.uint(8, 128)
