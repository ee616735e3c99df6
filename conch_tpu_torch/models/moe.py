# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Mixture-of-experts dispatch (counterpart of ``conch_tpu/models/moe.py``).

Only ``make_dispatch``, which the DeepSeek MoE layers use, is ported;
``MoEConfig``, Mixtral and ``moe_ffn`` wait for a later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def make_dispatch(
    weights: torch.Tensor,  # (T, k) f32
    experts: torch.Tensor,  # (T, k) int
    num_experts: int,
    capacity: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Build the (T, E, C) dispatch one-hot and combine tensors (f32).

    Position-in-expert is an exclusive cumsum of each expert's selection
    mask over tokens (earlier tokens win capacity, matching GShard), and
    k-slots are ranked in order: a token's second-choice expert sees it
    after every token's first choice at that expert.

    The JAX package walks the k slots one at a time, starting each from the
    tokens its earlier slots admitted. Here one cumsum runs over the
    selections in slot-major order, which counts the earlier slots'
    dropped selections too; that changes no outcome: an expert that dropped
    a selection is full, so every later selection of it is dropped either
    way, and below capacity both counts agree. A token's k experts are
    distinct, so each (token, expert, position) gets at most one term.
    """
    t, k = weights.shape
    mask = F.one_hot(experts.t().reshape(-1).long(), num_experts).to(torch.int32)  # (k*T, E)
    pos = torch.cumsum(mask, dim=0, dtype=torch.int32) - mask  # exclusive
    keep = mask * (pos < capacity)
    pos_onehot = F.one_hot((pos * keep).sum(dim=1).long(), capacity).to(torch.float32).view(k, t, 1, capacity)
    sel = keep.to(torch.float32).view(k, t, num_experts, 1)
    dispatch = (sel * pos_onehot).sum(dim=0)
    combine = (sel * weights.t().to(torch.float32)[:, :, None, None] * pos_onehot).sum(dim=0)
    return dispatch, combine
