# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

from conch_tpu_torch.ops.cache.copy_blocks import copy_blocks
from conch_tpu_torch.ops.cache.reshape_and_cache import reshape_and_cache, reshape_and_cache_stacked
from conch_tpu_torch.ops.cache.reshape_and_cache_mla import reshape_and_cache_mla

__all__ = ["copy_blocks", "reshape_and_cache", "reshape_and_cache_mla", "reshape_and_cache_stacked"]
