# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Plain PyTorch version of the ring all-gather (K14).

What ``conch_tpu/kernels/collectives/ring_all_gather.py:ring_all_gather_pallas``
returns on every device of the ring: the shards concatenated along rows,
row block ``j`` being rank ``j``'s shard.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch


def ring_all_gather(shards: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Rank ``r``'s result is ``cat(shards)`` on rank ``r``'s device: one new
    ``(n * rows, cols)`` tensor per rank."""
    return [torch.cat([s.to(dst.device) for s in shards]) for dst in shards]
