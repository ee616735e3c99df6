# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

from conch_tpu_torch.serving.block_allocator import BlockAllocator
from conch_tpu_torch.serving.engine import EngineConfig, LLMEngine, Request
from conch_tpu_torch.serving.sampling import SamplingParams

__all__ = ["BlockAllocator", "EngineConfig", "LLMEngine", "Request", "SamplingParams"]
