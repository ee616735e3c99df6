# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

from conch_tpu_torch.ops.quantization.fp8 import scaled_fp8_quant, static_scaled_fp8_quant
from conch_tpu_torch.ops.quantization.gemm import (
    ChannelScaleMode,
    MixedPrecisionMatmulMetadata,
    ScaledMatmulMetadata,
    WeightGroupMode,
    create_mixed_precision_metadata,
    create_scaled_metadata,
    mixed_precision_gemm,
    scaled_gemm,
)
from conch_tpu_torch.ops.quantization.int8 import scaled_int8_quant, static_scaled_int8_quant

__all__ = [
    "ChannelScaleMode", "MixedPrecisionMatmulMetadata", "ScaledMatmulMetadata", "WeightGroupMode",
    "create_mixed_precision_metadata", "create_scaled_metadata", "mixed_precision_gemm", "scaled_fp8_quant",
    "scaled_gemm", "scaled_int8_quant", "static_scaled_fp8_quant", "static_scaled_int8_quant",
]
