# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""bitsandbytes-compatible functional quantization API (counterpart of
``conch_tpu/ops/quantization/bitsandbytes/functional.py``).

The ``QuantState`` container (with nested "double quantization" of the
absmax statistics, QLoRA's ``compress_statistics``), ``quantize_blockwise``
/ ``quantize_4bit`` on K12q, ``dequantize_blockwise`` / ``dequantize_4bit``
on K12d, the 8-bit dynamic code (plain torch, as the JAX package computes
it in XLA), its map generator, and the same blocksizes and quant types.
Results are new tensors; nothing is updated in place.
``quant_state_from_jax`` carries a JAX ``QuantState`` across, so that both
packages decode the same codes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Final, Optional

import numpy as np
import torch

from conch_tpu_torch.kernels.common import cdiv
from conch_tpu_torch.kernels.quantization.bitsandbytes.blockwise import (
    dequantize_blockwise_launcher,
    quantize_blockwise_launcher,
)
from conch_tpu_torch.platforms import resolve_device

SUPPORTED_QUANT_TYPES: Final = ["nf4", "fp4", "fp8"]
SUPPORTED_BLOCKSIZES: Final = [4096, 2048, 1024, 512, 256, 128, 64]

_BYTES_PER_ELEMENT: Final = {
    torch.float32: 4,
    torch.float16: 2,
    torch.bfloat16: 2,
    torch.uint8: 1,
    torch.int8: 1,
}

_NAME_TO_QMAP: dict[str, torch.Tensor] = {}


def create_dynamic_map(signed: bool = True, max_exponent_bits: int = 7, total_bits: int = 8) -> torch.Tensor:
    """The bitsandbytes dynamic 8-bit quantization code map, (256,) f32 on the CPU.

    Dynamic exponent + linear fraction layout from "8-Bit Approximations for
    Parallelism in Deep Learning" (arXiv:1511.04561); the values are bit for
    bit the JAX package's (the same float32 ``linspace`` midpoints, scaled in
    float64 and rounded to float32 once).
    """
    data: list[float] = []
    non_sign_bits = total_bits - 1
    additional_items = 2 ** (non_sign_bits - max_exponent_bits) - 1
    for i in range(max_exponent_bits):
        fraction_items = int(
            2 ** (i + non_sign_bits - max_exponent_bits) + 1
            if signed
            else 2 ** (i + non_sign_bits - max_exponent_bits + 1) + 1
        )
        boundaries = np.linspace(0.1, 1.0, fraction_items, dtype=np.float32)
        means = (boundaries[:-1] + boundaries[1:]) / 2.0
        data += ((10 ** (-(max_exponent_bits - 1) + i)) * means).tolist()
        if signed:
            data += (-(10 ** (-(max_exponent_bits - 1) + i)) * means).tolist()

    if additional_items > 0:
        boundaries = np.linspace(0.1, 1.0, additional_items + 1, dtype=np.float32)
        means = (boundaries[:-1] + boundaries[1:]) / 2.0
        data += (max_exponent_bits * means).tolist()
        if signed:
            data += (-max_exponent_bits * means).tolist()

    data.append(0.0)
    data.append(1.0)

    if len(data) != 2**total_bits:
        msg = f"the dynamic map has {len(data)} values, not {2**total_bits}"
        raise ValueError(msg)

    data += [0.0] * (256 - len(data))
    data.sort()
    return torch.from_numpy(np.array(data, dtype=np.float32))


def _dynamic_map(device: torch.device) -> torch.Tensor:
    """The default dynamic map (cached once per process, as in the JAX
    package), on ``device``."""
    if "dynamic" not in _NAME_TO_QMAP:
        _NAME_TO_QMAP["dynamic"] = create_dynamic_map()
    return _NAME_TO_QMAP["dynamic"].to(device)


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


_DTYPES_BY_NAME: Final = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def quant_state_from_jax(numpy_state: Any, device: str | torch.device | None = None) -> QuantState:
    """Carry a JAX ``QuantState`` (arrays as numpy, or anything ``np.asarray``
    takes; a nested ``state2`` included) over to the port's, bit for bit, on
    ``device`` (None: the card, as every entry point; ``"cpu"`` asks for the
    CPU)."""
    device = resolve_device(device)

    def tensor(a: Any) -> torch.Tensor | None:
        return None if a is None else torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    state2 = numpy_state.state2
    return QuantState(
        absmax=torch.from_numpy(np.array(numpy_state.absmax)).to(device),
        shape=tuple(numpy_state.shape),
        dtype=_DTYPES_BY_NAME[np.dtype(numpy_state.dtype).name],
        blocksize=numpy_state.blocksize,
        quant_type=numpy_state.quant_type,
        code=tensor(numpy_state.code),
        offset=None if numpy_state.offset is None else float(numpy_state.offset),
        state2=None if state2 is None else quant_state_from_jax(state2, device),
    )


def get_absmax_shape(input_size: int, blocksize: int) -> tuple[int, ...]:
    """Shape of the per-block absmax tensor."""
    return (cdiv(input_size, blocksize),)


def get_quantized_output_shape(input_size: int, quant_type: str, quant_storage: torch.dtype = torch.uint8) -> tuple[
        int, ...]:
    """Shape of the packed quantized output."""
    if quant_type == "fp8":
        return (input_size,)
    mod = _BYTES_PER_ELEMENT[quant_storage] * 2
    return ((input_size + 1) // mod, 1)


def _check_type_and_blocksize(quant_type: str, blocksize: int) -> None:
    if quant_type not in SUPPORTED_QUANT_TYPES:
        msg = f"Unsupported quant_type: {quant_type} ({SUPPORTED_QUANT_TYPES = })"
        raise NotImplementedError(msg)
    if blocksize not in SUPPORTED_BLOCKSIZES:
        msg = f"Unsupported blocksize: {blocksize} ({SUPPORTED_BLOCKSIZES = })"
        raise NotImplementedError(msg)


def quantize_blockwise(
    x: torch.Tensor,
    absmax: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
    code: torch.Tensor | None = None,
    blocksize: int = 64,
    quant_type: str = "fp4",
    quant_storage: torch.dtype = torch.uint8,
) -> tuple[torch.Tensor, QuantState]:
    """Quantize ``x`` in blocks: (codes, ``QuantState``).

    nf4 / fp4: two codes a byte, ((size + 1) // 2, 1) uint8 (K12q). "fp8"
    (the JAX package's name for the 8-bit dynamic ``code``, which it needs):
    one code a value, (size,) uint8. As in the JAX package, ``absmax`` and
    ``out`` are accepted and ignored: the results are new tensors. Only
    ``quant_storage=torch.uint8`` is ported; others raise.
    """
    _check_type_and_blocksize(quant_type, blocksize)
    if quant_storage != torch.uint8:
        msg = f"quant_storage {quant_storage} is not ported; only torch.uint8"
        raise NotImplementedError(msg)
    if quant_type == "fp8" and code is None:
        msg = "8-bit quantization requires a code table"
        raise ValueError(msg)
    if code is not None:
        code = code.to(x.device)

    input_size = x.numel()
    packed, absmax_out = quantize_blockwise_launcher(x, code, blocksize, input_size, quant_type)
    packed = packed.reshape(get_quantized_output_shape(input_size, quant_type, quant_storage))
    if absmax_out.shape != get_absmax_shape(input_size, blocksize):
        msg = f"absmax of shape {tuple(absmax_out.shape)} for {input_size} values in blocks of {blocksize}"
        raise AssertionError(msg)

    state = QuantState(
        absmax=absmax_out, shape=tuple(x.shape), dtype=x.dtype, blocksize=blocksize, quant_type=quant_type, code=code,
    )
    return packed, state


def quantize_4bit(
    x: torch.Tensor,
    absmax: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
    blocksize: int = 64,
    compress_statistics: bool = False,
    quant_type: str = "fp4",
    quant_storage: torch.dtype = torch.uint8,
) -> tuple[torch.Tensor, QuantState]:
    """Quantize ``x`` to packed 4-bit blocks: ((size + 1) // 2, 1) uint8 and
    its ``QuantState`` (absmax (ceil(size / blocksize),) f32).

    With ``compress_statistics`` (QLoRA's double quantization) the absmax is
    shifted by its f32 mean (``offset``) and stored in the 8-bit dynamic
    code at blocksize 256 (``state2``). The mean is taken in f32 by torch,
    whose order of summation is not XLA's, so the offset may differ from
    the JAX package's in its last bit and a code by one step. As in the JAX
    package, ``absmax`` and ``out`` are accepted and ignored.
    """
    if quant_type not in ("nf4", "fp4"):
        msg = f"Unsupported quant_type: {quant_type} (4-bit: nf4, fp4)"
        raise NotImplementedError(msg)
    packed, state = quantize_blockwise(
        x=x, absmax=absmax, out=out, code=None, blocksize=blocksize, quant_type=quant_type,
        quant_storage=quant_storage,
    )
    if compress_statistics:
        offset = state.absmax.mean()
        qabsmax, state2 = quantize_blockwise(
            x=state.absmax - offset, code=_dynamic_map(x.device), blocksize=256, quant_type="fp8",
        )
        state = QuantState(
            absmax=qabsmax, shape=state.shape, dtype=state.dtype, blocksize=blocksize, quant_type=quant_type,
            offset=float(offset), state2=state2,
        )
    return packed, state


def dequantize_blockwise(
    x: torch.Tensor,
    quant_state: QuantState | None = None,
    absmax: torch.Tensor | None = None,
    code: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
    blocksize: int = 64,
    quant_type: str = "fp4",
) -> torch.Tensor:
    """Dequantize blocks back to a flat tensor.

    With ``quant_state``: its absmax, code, blocksize and quant type (an
    ``absmax`` or ``code`` given here takes the state's place), the state's
    dtype, ``prod(shape)`` values. Without: ``absmax`` (and ``code`` for
    "fp8") are needed, and the output is f32 of ``x.numel() * 2`` values
    for 4-bit codes, ``x.numel()`` for 8-bit. ``out`` is accepted and
    ignored, as in the JAX package. A nested state's absmax is not
    recovered here (``dequantize_4bit`` does that).
    """
    _check_type_and_blocksize(quant_type, blocksize)
    if quant_state is None:
        if absmax is None:
            msg = "Must pass either quant_state or absmax!"
            raise ValueError(msg)
        if code is None and quant_type == "fp8":
            msg = "Must pass either quant_state or code!"
            raise ValueError(msg)
        output_size = x.numel() * 2 if quant_type in ("nf4", "fp4") else x.numel()
        output_dtype = torch.float32
    else:
        absmax = quant_state.absmax if absmax is None else absmax
        code = quant_state.code if code is None else code
        output_size = int(np.prod(quant_state.shape))
        output_dtype = quant_state.dtype
        blocksize = quant_state.blocksize
        quant_type = quant_state.quant_type
    if code is not None:
        code = code.to(x.device)
    return dequantize_blockwise_launcher(x, absmax, code, blocksize, output_size, quant_type, output_dtype)


def dequantize_4bit(
    x: torch.Tensor,
    quant_state: QuantState | None = None,
    absmax: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
    blocksize: int = 64,
    quant_type: str = "fp4",
) -> torch.Tensor:
    """Dequantize packed 4-bit blocks (K12d) to a flat tensor, as the JAX
    package returns it (reshape it to ``quant_state.shape``).

    A nested state first recovers its absmax in f32: the 8-bit decode of
    ``state2`` plus ``offset``. ``out`` is accepted and ignored.
    """
    if quant_state is not None and quant_state.nested:
        state2 = quant_state.state2
        recovered = dequantize_blockwise(
            x=quant_state.absmax, quant_state=state2, blocksize=state2.blocksize, quant_type=state2.quant_type,
        )
        recovered = (recovered + quant_state.offset).to(torch.float32)
        return dequantize_blockwise_launcher(
            x, recovered, None, quant_state.blocksize, int(np.prod(quant_state.shape)), quant_state.quant_type,
            quant_state.dtype,
        )
    return dequantize_blockwise(
        x=x, quant_state=quant_state, absmax=absmax, code=None, out=out, blocksize=blocksize, quant_type=quant_type,
    )
