# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""K3's split plan (``conch_tpu_torch/kernels/attention/paged_attention.py:
paged_split_plan``), which the wrapper computes in Python and the CUDA
kernel follows (``csrc/paged_attention.cu``: split z walks the visible
tokens ``kv_start + z * split_len`` onwards). Held on the CPU:

- every token a decode query sees, ``[max(seq_len - window, 0), seq_len)``,
  falls in exactly one split, and no split reaches outside that range, for
  random lengths up to the block table's capacity, random windows and idle
  rows, at the served engines' shapes and small ones;
- a split is a whole number of the kernel's tiles (``SPLIT_TILE`` tokens),
  the splits stay within the kernel's ``MAX_SPLITS`` and together cover
  the visible capacity;
- the plan reads shapes only: ``seq_lens`` and ``block_table`` on the meta
  device, which hold no values, still plan.
"""

import numpy as np
import pytest
import torch

from conch_tpu_torch.kernels.attention.paged_attention import (
    MAX_SPLITS,
    SPLIT_TILE,
    paged_split_plan,
)
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

H100_SMS = 132
PAGE = 16
# (rows, table pages, KV heads): the int4 Llama engine's decode step, the
# kernel checks' Llama batch, Gemma-2-2B's served step, one long sequence,
# a small test batch, a table a split's worth wide.
SHAPES = [(32, 64, 8), (8, 64, 8), (16, 384, 4), (1, 64, 8), (1, 8192, 1), (2, 4, 1), (3, 16, 2)]


def _meta(rows: int, pages: int) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.empty(rows, dtype=torch.int32, device="meta"),
            torch.empty((rows, pages), dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("window", [0, 1, 37, 4096])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_each_visible_token_in_one_split(shape, window):
    rows, pages, kv_heads = shape
    plan = paged_split_plan(*_meta(rows, pages), PAGE, kv_heads, window, H100_SMS)
    assert 1 <= plan.splits <= MAX_SPLITS
    assert plan.split_len % SPLIT_TILE == 0
    assert plan.splits * plan.split_len >= (min(pages * PAGE, window) if window > 0 else pages * PAGE)
    rng = np.random.default_rng(rows * 7919 + pages + window)
    lens = [0, 1, pages * PAGE, *rng.integers(0, pages * PAGE + 1, size=13).tolist()]
    for seq_len in lens:
        kv_start = max(seq_len - window, 0) if window > 0 else 0
        hits = np.zeros(seq_len + 1, dtype=np.int64)
        for split in range(plan.splits):
            start, end = plan.split_range(seq_len, window, split)
            if start >= end:
                continue
            assert kv_start <= start and end <= seq_len
            hits[start:end] += 1
        assert (hits[kv_start:seq_len] == 1).all(), f"seq_len {seq_len}, window {window}"
        assert hits[:kv_start].sum() == 0 and hits[seq_len] == 0


@pytest.mark.parametrize("shape", SHAPES[:3], ids=lambda s: "x".join(map(str, s)))
def test_served_shapes_split(shape):
    """The served decode steps split their rows: a block walks at most 256
    tokens, so a row of the block table's full width takes several."""
    rows, pages, kv_heads = shape
    plan = paged_split_plan(*_meta(rows, pages), PAGE, kv_heads, 0, H100_SMS)
    assert plan.splits > 1 and plan.split_len <= 256
    assert plan.splits * plan.split_len >= pages * PAGE


def test_workspace_and_shape_checks():
    sl, bt = _meta(16, 384)
    plan = paged_split_plan(sl, bt, PAGE, 4, 4096, H100_SMS)
    assert plan.workspace_shapes(16, 8, 256) == ((plan.splits, 16, 8, 256), (plan.splits, 16, 8, 2))
    assert paged_split_plan(*_meta(2, 4), PAGE, 1, 0, H100_SMS).workspace_shapes(2, 4, 128) is None
    with pytest.raises(ValueError, match="seq_lens"):
        paged_split_plan(torch.empty(3, dtype=torch.int32, device="meta"), bt, PAGE, 4, 0, H100_SMS)
