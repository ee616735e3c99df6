# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

from conch_tpu_torch.ops.quantization.bitsandbytes.functional import (
    QuantState,
    create_dynamic_map,
    dequantize_4bit,
    dequantize_blockwise,
    get_absmax_shape,
    get_quantized_output_shape,
    quant_state_from_jax,
    quantize_4bit,
    quantize_blockwise,
)

__all__ = [
    "QuantState",
    "create_dynamic_map",
    "dequantize_4bit",
    "dequantize_blockwise",
    "get_absmax_shape",
    "get_quantized_output_shape",
    "quant_state_from_jax",
    "quantize_4bit",
    "quantize_blockwise",
]
