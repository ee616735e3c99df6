# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Rotary embedding public op (counterpart of ``conch_tpu/ops/embedding/rotary_embedding.py``)."""

from __future__ import annotations

import torch

from conch_tpu_torch.kernels.embedding.rotary_embedding import rotary_embedding_launcher


def rotary_embedding(
    positions: torch.Tensor,
    query: torch.Tensor,
    key: torch.Tensor,
    head_size: int,
    cos_sin_cache: torch.Tensor,
    *,
    is_neox: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply NeoX rotary embedding to query and key.

    Args:
        positions: (num_tokens,) int32 token positions.
        query: (num_tokens, num_heads * head_size); rows may be strided.
        key: (num_tokens, num_kv_heads * head_size); rows may be strided.
        head_size: attention head size.
        cos_sin_cache: f32 [cos | sin] cache, (max_position, rot_dim).
        is_neox: must be True (split-half rotation), as in the JAX package.

    Returns:
        New rotated (query, key), contiguous.
    """
    if not is_neox:
        msg = "Only NeoX-style rotary embedding is supported"
        raise NotImplementedError(msg)
    return rotary_embedding_launcher(positions, query, key, head_size, cos_sin_cache)
