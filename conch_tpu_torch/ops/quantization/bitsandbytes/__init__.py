# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

from conch_tpu_torch.ops.quantization.bitsandbytes.functional import QuantState, quantize_4bit

__all__ = ["QuantState", "quantize_4bit"]
