# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Port varlen prefill attention (conch_tpu_torch, K7's module) against the JAX package.

The same numpy inputs go through ``conch_tpu.ops.attention.varlen_attention``
(the Pallas kernel in interpret mode) and the port's op on
``device="cpu"``, in f32, bf16 and f16 (the JAX launcher keeps f16 in
interpret mode). Tolerances are those of tests/varlen_attention_test.py:25
and :69 (f16).
Cases, as the engine builds them: a mixed-in decode row, a fresh prompt,
the trailing chunk of a longer prompt (q_len < seq_len), a chunk whose
first pages are shared with another sequence, zero-length padding
sequences at the tail, padding rows past cu_seqlens_q[-1], lengths off
page multiples, and a 3-layer pool read at a non-zero layer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.ops.attention import varlen_attention as jax_varlen
from conch_tpu_torch.ops.attention import varlen_attention
from conch_tpu_torch.reference.attention.attention import varlen_attention as varlen_reference
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

TOLERANCES = {"float32": 2e-3, "bfloat16": 2e-2, "float16": 2e-3}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
L, PS, MAX_PAGES = 3, 16, 8
Q_LENS = [1, 23, 17, 9, 0, 0]
SEQ_LENS = [70, 23, 50, 41, 0, 0]
ROWS = 64  # 50 real rows, 14 padding rows


def make_inputs(rng, num_q_heads, num_kv_heads, head_size):
    num_pages = sum(-(-n // PS) for n in SEQ_LENS) + 2
    perm = iter(rng.permutation(np.arange(1, num_pages)).tolist())
    bt = np.zeros((len(SEQ_LENS), MAX_PAGES), np.int32)
    for b, n in enumerate(SEQ_LENS):
        for p in range(-(-n // PS)):
            bt[b, p] = next(perm)
    bt[3, :2] = bt[2, :2]  # sequence 3 shares sequence 2's first 32 tokens
    kc = rng.normal(size=(L, num_pages, num_kv_heads, PS, head_size)).astype(np.float32)
    vc = rng.normal(size=(L, num_pages, num_kv_heads, PS, head_size)).astype(np.float32)
    q = rng.normal(size=(ROWS, num_q_heads, head_size)).astype(np.float32)
    cu = np.concatenate([[0], np.cumsum(Q_LENS)]).astype(np.int32)
    return q, kc, vc, cu, np.asarray(SEQ_LENS, np.int32), bt


@pytest.mark.parametrize("num_q_heads,num_kv_heads,head_size", [(4, 1, 128), (8, 2, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_varlen_attention_matches_jax(num_q_heads, num_kv_heads, head_size, dtype):
    rng = np.random.default_rng(31)
    q, kc, vc, cu, sl, bt = make_inputs(rng, num_q_heads, num_kv_heads, head_size)
    layer, total = 1, int(cu[-1])
    jd, td = JAX_DTYPES[dtype], TORCH_DTYPES[dtype]
    ref = jax_varlen(
        jnp.asarray(q, jd), jnp.asarray(kc, jd), jnp.asarray(vc, jd), jnp.asarray(cu), 32, jnp.asarray(sl),
        int(sl.max()), jnp.asarray(bt), causal=True, layer_idx=jnp.asarray(layer, jnp.int32),
    )
    out = varlen_attention(
        torch.from_numpy(q).to(td), torch.from_numpy(kc).to(td), torch.from_numpy(vc).to(td),
        torch.from_numpy(cu), 32, torch.from_numpy(sl), int(sl.max()), torch.from_numpy(bt),
        causal=True, layer_idx=layer,
    )
    assert out.dtype == td and out.shape == q.shape
    tol = TOLERANCES[dtype]
    np.testing.assert_allclose(
        out[:total].float().numpy(), np.asarray(ref, np.float32)[:total], atol=tol, rtol=tol
    )
    assert torch.isfinite(out).all() and out[total:].abs().max().item() == 0.0  # padding rows


def test_varlen_decode_row_equals_paged_decode():
    """A single-query sequence in a varlen step is decode attention."""
    from conch_tpu_torch.ops.attention import paged_attention

    rng = np.random.default_rng(32)
    q, kc, vc, cu, sl, bt = map(torch.from_numpy, make_inputs(rng, 4, 1, 128))
    out = varlen_attention(q, kc, vc, cu, 32, sl, 70, bt, causal=True, layer_idx=2)
    dec = paged_attention(q[:1], kc, vc, bt[:1], sl[:1], layer_idx=2)
    torch.testing.assert_close(out[:1], dec, atol=0, rtol=0)


def test_varlen_non_causal_matches_reference():
    rng = np.random.default_rng(33)
    q, kc, vc, cu, sl, bt = map(torch.from_numpy, make_inputs(rng, 4, 1, 128))
    out = varlen_attention(q, kc, vc, cu, 32, sl, 70, bt, causal=False, layer_idx=0)
    gold = varlen_reference(q, kc[0], vc[0], cu, sl, bt, 1.0 / np.sqrt(128), causal=False)
    torch.testing.assert_close(out, gold, atol=2e-3, rtol=2e-3)
