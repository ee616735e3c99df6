# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

from conch_tpu_torch.serving.beam_search import BeamHypothesis, beam_search
from conch_tpu_torch.serving.block_allocator import BlockAllocator
from conch_tpu_torch.serving.engine import EngineConfig, LLMEngine, Request
from conch_tpu_torch.serving.sampling import SamplingParams
from conch_tpu_torch.serving.server import EngineWorker, ServerConfig, make_server, serve

__all__ = [
    "BeamHypothesis", "BlockAllocator", "EngineConfig", "EngineWorker",
    "LLMEngine", "Request", "SamplingParams", "ServerConfig", "beam_search",
    "make_server", "serve",
]
