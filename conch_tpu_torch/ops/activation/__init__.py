# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

from conch_tpu_torch.ops.activation.gelu_tanh_and_mul import gelu_tanh_and_mul, gelu_tanh_and_mul_parts
from conch_tpu_torch.ops.activation.silu_and_mul import silu_and_mul, silu_and_mul_parts

__all__ = ["gelu_tanh_and_mul", "gelu_tanh_and_mul_parts", "silu_and_mul", "silu_and_mul_parts"]
