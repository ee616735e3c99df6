# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

from conch_tpu_torch.ops.quantization.gemm import mixed_precision_gemm, scaled_gemm

__all__ = ["mixed_precision_gemm", "scaled_gemm"]
