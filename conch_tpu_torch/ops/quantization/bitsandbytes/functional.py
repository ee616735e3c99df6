# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""bitsandbytes-style 4-bit quantization (counterpart of
``conch_tpu/ops/quantization/bitsandbytes/functional.py``).

``quantize_4bit`` with ``compress_statistics=False`` on the K12q kernel
(NF4 and FP4). Double quantization of the absmax (the 8-bit dynamic code),
``quantize_blockwise`` and the decoders are not ported yet and raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Final, Optional

import torch

from conch_tpu_torch.kernels.common import cdiv
from conch_tpu_torch.kernels.quantization.bitsandbytes.blockwise import quantize4_launcher

SUPPORTED_BLOCKSIZES: Final = [4096, 2048, 1024, 512, 256, 128, 64]


@dataclass
class QuantState:
    """Quantization state (the JAX package's ``QuantState``)."""

    absmax: torch.Tensor
    shape: tuple[int, ...]
    dtype: torch.dtype
    blocksize: int
    quant_type: str
    code: torch.Tensor | None = None
    offset: float | None = None
    state2: Optional[QuantState] = None

    @property
    def nested(self) -> bool:
        return self.state2 is not None


def quantize_4bit(
    x: torch.Tensor,
    absmax: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
    blocksize: int = 64,
    compress_statistics: bool = False,
    quant_type: str = "fp4",
    quant_storage: torch.dtype = torch.uint8,
) -> tuple[torch.Tensor, QuantState]:
    """Quantize ``x`` to packed 4-bit blocks: ((size + 1) // 2, 1) uint8
    and its ``QuantState`` (absmax (ceil(size / blocksize),) f32). As in
    the JAX package, ``absmax`` and ``out`` are accepted and ignored: the
    results are new tensors."""
    if quant_type not in ("nf4", "fp4"):
        msg = f"Unsupported quant_type: {quant_type} (4-bit: nf4, fp4)"
        raise NotImplementedError(msg)
    if blocksize not in SUPPORTED_BLOCKSIZES:
        msg = f"Unsupported blocksize: {blocksize} ({SUPPORTED_BLOCKSIZES = })"
        raise NotImplementedError(msg)
    if quant_storage != torch.uint8:
        msg = f"quant_storage {quant_storage} is not ported; only torch.uint8"
        raise NotImplementedError(msg)
    if compress_statistics:
        msg = "double quantization (compress_statistics=True) needs the 8-bit dynamic code, not ported yet"
        raise NotImplementedError(msg)
    packed, absmax_out = quantize4_launcher(x, blocksize, quant_type)
    if absmax_out.shape != (cdiv(x.numel(), blocksize),):
        msg = f"absmax of shape {tuple(absmax_out.shape)} for {x.numel()} values in blocks of {blocksize}"
        raise AssertionError(msg)
    state = QuantState(absmax=absmax_out, shape=tuple(x.shape), dtype=x.dtype, blocksize=blocksize,
                       quant_type=quant_type)
    return packed.reshape(-1, 1), state
