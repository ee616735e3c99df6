# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

from conch_tpu_torch.ops.attention.mla_attention import mla_attention
from conch_tpu_torch.ops.attention.paged_attention import paged_attention
from conch_tpu_torch.ops.attention.varlen_attention import varlen_attention

__all__ = ["mla_attention", "paged_attention", "varlen_attention"]
