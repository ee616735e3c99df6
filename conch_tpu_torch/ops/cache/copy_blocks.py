# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""copy_blocks public op (counterpart of ``conch_tpu/ops/cache/copy_blocks.py``).

Plain PyTorch, as the JAX side is plain ``jnp`` (its kernel module has no
Pallas kernel): each layer's pages are gathered at the sources, then
scattered to the destinations. The JAX op returns new buffers (its caches
are donated); the port updates the caches in place, saving a copy of every
layer, and returns them so call sites read alike.
"""

from __future__ import annotations

import torch


def _validate_sizes(
    key_caches: list[torch.Tensor], value_caches: list[torch.Tensor], block_mapping: torch.Tensor
) -> None:
    """The JAX op's checks, with its messages."""
    num_layers = len(key_caches)
    if len(value_caches) != num_layers:
        msg = f"Mismatch in number of layers between key_caches ({num_layers}) and value_caches ({len(value_caches)})"
        raise ValueError(msg)
    if num_layers == 0:
        msg = "Empty list of kv caches passed to copy_blocks"
        raise ValueError(msg)
    expected_shape = key_caches[0].shape
    if any(c.shape != expected_shape for c in (*key_caches, *value_caches)):
        msg = "Mismatch in shape of entries in key/value caches"
        raise ValueError(msg)
    expected_dtype = key_caches[0].dtype
    if any(c.dtype != expected_dtype for c in (*key_caches, *value_caches)):
        msg = "Mismatch in dtype of entries in key/value caches"
        raise ValueError(msg)
    if block_mapping.dim() != 2 or block_mapping.shape[1] != 2:
        msg = f"Block mapping tensor has invalid shape ({tuple(block_mapping.shape)}), expected shape=(num_pairs, 2)"
        raise ValueError(msg)


def copy_blocks(
    key_caches: list[torch.Tensor], value_caches: list[torch.Tensor], block_mapping: torch.Tensor
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Copy cache pages ``src -> dst`` in every layer's K and V cache, in place.

    Args:
        key_caches/value_caches: per-layer caches of any page-major shape.
        block_mapping: (num_pairs, 2) ``[src, dst]`` page indices; the
            destinations are free pages (vLLM's rule), so no source is also
            a destination.

    Returns:
        The (key_caches, value_caches) lists, updated.
    """
    _validate_sizes(key_caches, value_caches, block_mapping)
    for cache in (*key_caches, *value_caches):
        mapping = block_mapping.to(device=cache.device, dtype=torch.long)
        cache[mapping[:, 1]] = cache[mapping[:, 0]]
    return list(key_caches), list(value_caches)
