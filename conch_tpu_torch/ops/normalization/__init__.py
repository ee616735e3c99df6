# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

from conch_tpu_torch.ops.normalization.gemma_rms_norm import gemma_rms_norm
from conch_tpu_torch.ops.normalization.rms_norm import fused_add_rms_norm, rms_norm

__all__ = ["fused_add_rms_norm", "gemma_rms_norm", "rms_norm"]
