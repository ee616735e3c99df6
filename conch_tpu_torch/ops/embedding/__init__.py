# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

from conch_tpu_torch.ops.embedding.rotary_embedding import rotary_embedding

__all__ = ["rotary_embedding"]
