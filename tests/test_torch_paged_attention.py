# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Port paged decode attention (conch_tpu_torch, K3's module) against the JAX package.

The same numpy inputs go through ``conch_tpu.ops.attention.paged_attention``
(the Pallas kernel in interpret mode) and the port's op on
``device="cpu"``, in f32, bf16 and f16 (the JAX launcher keeps f16 in
interpret mode). Tolerances are those of tests/paged_attention_test.py:21
and :52 (f16).
Cases: an idle row (seq_len 0), lengths off page multiples, pages shared
by two sequences (a prefix-cache hit), block-table entries past a
sequence's pages left 0 (page 0 is a real page), and a 3-layer pool read
at a non-zero layer.

The idle row sits at the tail in the comparison with JAX, where the
engine puts idle rows: the JAX kernel zeroes its chunk buffers only when
row 0 has pages (conch_tpu/kernels/attention/paged_attention.py:155), so
an idle row 0 leaves uninitialized scratch that turns later rows to NaN
in interpret mode. The port's idle-first case is held against the golden
reference instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.ops.attention import paged_attention as jax_paged
from conch_tpu_torch.ops.attention import paged_attention
from conch_tpu_torch.reference.attention.attention import paged_attention as paged_reference
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

TOLERANCES = {"float32": 2e-3, "bfloat16": 3e-2, "float16": 5e-3}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
L, PS, MAX_PAGES = 3, 16, 8


def make_inputs(rng, seq_lens, num_q_heads, num_kv_heads, head_size, shared=(1, 2, 2)):
    """Stacked pool, block table and queries; sequence ``shared[1]`` reads
    the first ``shared[2]`` pages of sequence ``shared[0]``."""
    num_pages = sum(-(-n // PS) for n in seq_lens) + 3
    perm = iter(rng.permutation(np.arange(1, num_pages)).tolist())
    bt = np.zeros((len(seq_lens), MAX_PAGES), np.int32)
    for b, n in enumerate(seq_lens):
        for p in range(-(-n // PS)):
            bt[b, p] = next(perm)
    src, dst, n_shared = shared
    bt[dst, :n_shared] = bt[src, :n_shared]
    kc = rng.normal(size=(L, num_pages, num_kv_heads, PS, head_size)).astype(np.float32)
    vc = rng.normal(size=(L, num_pages, num_kv_heads, PS, head_size)).astype(np.float32)
    q = rng.normal(size=(len(seq_lens), num_q_heads, head_size)).astype(np.float32)
    return q, kc, vc, bt, np.asarray(seq_lens, np.int32)


@pytest.mark.parametrize("num_q_heads,num_kv_heads,head_size", [(4, 1, 128), (8, 2, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_paged_attention_matches_jax(num_q_heads, num_kv_heads, head_size, dtype):
    rng = np.random.default_rng(21)
    q, kc, vc, bt, sl = make_inputs(rng, [37, 64, 1, 100, 0], num_q_heads, num_kv_heads, head_size, shared=(0, 1, 2))
    layer = 2
    jd, td = JAX_DTYPES[dtype], TORCH_DTYPES[dtype]
    ref = jax_paged(
        jnp.asarray(q, jd), jnp.asarray(kc, jd), jnp.asarray(vc, jd), jnp.asarray(bt), jnp.asarray(sl),
        layer_idx=jnp.asarray(layer, jnp.int32),
    )
    out = paged_attention(
        torch.from_numpy(q).to(td), torch.from_numpy(kc).to(td), torch.from_numpy(vc).to(td),
        torch.from_numpy(bt), torch.from_numpy(sl), layer_idx=layer,
    )
    assert out.dtype == td and out.shape == q.shape
    tol = TOLERANCES[dtype]
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol)
    assert torch.isfinite(out).all() and out[-1].abs().max().item() == 0.0  # idle row


def test_paged_attention_idle_first_row_matches_reference():
    rng = np.random.default_rng(24)
    q, kc, vc, bt, sl = map(torch.from_numpy, make_inputs(rng, [0, 37, 64, 1, 100], 4, 1, 128))
    out = paged_attention(q, kc, vc, bt, sl, layer_idx=1)
    gold = paged_reference(q, kc[1], vc[1], bt, sl, 1.0 / np.sqrt(128))
    torch.testing.assert_close(out, gold, atol=2e-3, rtol=2e-3)
    assert torch.isfinite(out).all() and out[0].abs().max().item() == 0.0


def test_paged_attention_reads_the_named_layer_only():
    """Same inputs at layers 0 and 2 differ, and layer 2 equals the golden
    reference on that layer's 4-D cache."""
    rng = np.random.default_rng(22)
    q, kc, vc, bt, sl = make_inputs(rng, [5, 33, 48], 4, 1, 128)
    tq, tk, tv = map(torch.from_numpy, (q, kc, vc))
    tbt, tsl = torch.from_numpy(bt), torch.from_numpy(sl)
    out2 = paged_attention(tq, tk, tv, tbt, tsl, layer_idx=2)
    out0 = paged_attention(tq, tk, tv, tbt, tsl, layer_idx=0)
    gold = paged_reference(tq, tk[2], tv[2], tbt, tsl, 1.0 / np.sqrt(128))
    torch.testing.assert_close(out2, gold, atol=2e-3, rtol=2e-3)
    assert not torch.allclose(out0, out2)
    four_d = paged_attention(tq, tk[2], tv[2], tbt, tsl)
    torch.testing.assert_close(four_d, out2, atol=0, rtol=0)


def test_paged_attention_unported_options_raise():
    """Ring pages without a window raise ValueError, with the JAX
    launchers' words (rolling KV is ported). fp8 caches, once refused, are read: an e4m3
    cache (and its uint8 view) under kv_cache_dtype "fp8" equals the golden
    reference on the same values with the scales folded in. A string that
    does not name the caches' dtype raises."""
    rng = np.random.default_rng(23)
    q, kc, vc, bt, sl = map(torch.from_numpy, make_inputs(rng, [5, 20, 33], 4, 1, 128))
    with pytest.raises(ValueError, match="window"):
        paged_attention(q, kc, vc, bt, sl, layer_idx=1, ring_pages=4)
    with pytest.raises(ValueError, match="fp8"):
        paged_attention(q, kc, vc, bt, sl, layer_idx=1, kv_cache_dtype="fp8")
    k8, v8 = kc.to(torch.float8_e4m3fn), vc.to(torch.float8_e4m3fn)
    scales = {"k_scale": torch.tensor([1.5]), "v_scale": torch.tensor([0.75])}
    out = paged_attention(q, k8, v8, bt, sl, layer_idx=1, kv_cache_dtype="fp8", **scales)
    gold = paged_reference(q, k8[1].float(), v8[1].float(), bt, sl, 1.5 / np.sqrt(128)) * 0.75
    torch.testing.assert_close(out, gold, atol=2e-3, rtol=2e-3)
    as_bytes = paged_attention(
        q, k8.view(torch.uint8), v8.view(torch.uint8), bt, sl, layer_idx=1, kv_cache_dtype="fp8", **scales
    )
    torch.testing.assert_close(as_bytes, out, atol=0, rtol=0)
