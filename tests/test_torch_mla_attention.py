# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Port MLA attention and the latent-cache write (K11's module) against the JAX package.

The same numpy inputs go through ``conch_tpu.ops.attention.mla_attention``
(the Pallas kernel in interpret mode) and ``conch_tpu.ops.cache.reshape_and_cache_mla``,
and through the port's ops on ``device="cpu"``. Cases of
tests/mla_attention_test.py:45 (decode [1,1,1] / [33,200,7], prefill
[40,9,1] / [40,121,64]; 8 heads, packed 256 = latent 128 + rope 64 + 64
pad), each with an idle seq_len-0 row first, negative slots among the
writes, a prefill step's padding rows: after zero-length padding
sequences, and after a last sequence that is real, where the JAX
launcher's clamped gather hands padding rows that sequence's outputs;
and the prefill step without the causal mask.
Tolerance: 2e-4 absolute and relative in f32 (tests/mla_attention_test.py:83);
in bf16, 3e-2 + 3e-2 x |ref| (the two sides round p to bf16 against
different running maxima). The caches must agree bit for bit.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.ops.attention import mla_attention as jax_mla
from conch_tpu.ops.cache import reshape_and_cache_mla as jax_cache_mla
from conch_tpu_torch.ops.attention import mla_attention
from conch_tpu_torch.ops.cache import reshape_and_cache_mla
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

LATENT, ROPE, PACKED, HEADS, PS = 128, 64, 256, 8, 16
SCALE = 1 / math.sqrt(192)
TOLERANCES = {"float32": 2e-4, "bfloat16": 3e-2}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (query lengths, KV lengths, rows, causal): the JAX test's cases with an
# idle row first; "padded" adds padding rows past two zero-length
# sequences, "full" padding rows after a real last sequence, and
# "noncausal" the prefill step without the causal mask.
CASES = {
    "decode": ([1, 1, 1, 1], [0, 33, 200, 7], 4, True),
    "prefill": ([1, 40, 9, 1], [0, 40, 121, 64], 51, True),
    "padded": ([1, 40, 9, 1, 0, 0], [0, 40, 121, 64, 0, 0], 64, True),
    "full": ([1, 9, 40], [0, 121, 40], 64, True),
    "noncausal": ([1, 40, 9, 1], [0, 40, 121, 64], 51, False),
}


def _build(rng, q_lens, seq_lens, rows):
    """Numpy inputs: queries and latent rows with zero pad columns, a
    shuffled page layout, and the rows' slots with every fifth one
    replaced by -1 (dropped) written again at the end with its real slot."""
    batch = len(seq_lens)
    pages_per = [-(-s // PS) for s in seq_lens]
    num_pages = sum(pages_per) + 3
    perm = iter(rng.permutation(num_pages).tolist())
    bt = np.zeros((batch, max(max(pages_per), 1)), np.int32)
    kv, slots = [], []
    for b, s in enumerate(seq_lens):
        pages = [next(perm) for _ in range(pages_per[b])]
        bt[b, : len(pages)] = pages
        for p in range(s):
            row = rng.standard_normal(PACKED).astype(np.float32)
            row[LATENT + ROPE :] = 0.0
            kv.append(row)
            slots.append(pages[p // PS] * PS + p % PS)
    kv = np.stack(kv)
    slots = np.asarray(slots, np.int32)
    dropped = np.arange(0, len(slots), 5)
    kv = np.concatenate([kv, kv[dropped]])
    slots = np.concatenate([np.where(np.isin(np.arange(len(slots)), dropped), -1, slots), slots[dropped]])
    q = rng.standard_normal((rows, HEADS, PACKED)).astype(np.float32)
    q[..., LATENT + ROPE :] = 0.0
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    return q, kv, slots, num_pages, cu, np.asarray(seq_lens, np.int32), bt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_mla_attention_matches_jax(case, dtype):
    q_lens, seq_lens, rows, causal = CASES[case]
    q, kv, slots, num_pages, cu, sl, bt = _build(np.random.default_rng(7), q_lens, seq_lens, rows)
    jd, td = JAX_DTYPES[dtype], TORCH_DTYPES[dtype]
    max_q = max(q_lens)

    jax_cache = jax_cache_mla(jnp.asarray(kv, jd), jnp.zeros((num_pages, PS, PACKED), jd), jnp.asarray(slots))
    cache = torch.zeros((num_pages, PS, PACKED), dtype=td)
    assert reshape_and_cache_mla(torch.from_numpy(kv).to(td), cache, torch.from_numpy(slots)) is cache
    np.testing.assert_array_equal(cache.float().numpy(), np.asarray(jax_cache.astype(jnp.float32)))

    ref = jax_mla(
        jnp.asarray(q, jd), jax_cache, jnp.asarray(cu), max_q, jnp.asarray(sl), jnp.asarray(bt),
        scale=SCALE, latent=LATENT, causal=causal,
    )
    out = mla_attention(
        torch.from_numpy(q).to(td), cache, torch.from_numpy(cu), max_q, torch.from_numpy(sl), torch.from_numpy(bt),
        scale=SCALE, latent=LATENT, causal=causal,
    )
    assert out.dtype == td and out.shape == (rows, HEADS, LATENT)
    expect = np.asarray(ref.astype(jnp.float32))
    tol = TOLERANCES[dtype]
    np.testing.assert_allclose(out.float().numpy(), expect, atol=tol, rtol=tol)
    assert not out[0].any()  # the idle row
    if case == "full":  # padding rows take the last sequence's first rows, as in JAX
        total, last = int(cu[-1]), int(cu[-2])
        assert np.abs(expect[total:]).min(axis=(1, 2)).max() > 0
        assert torch.equal(out[total:], out[last : last + rows - total])


def test_reshape_and_cache_mla_int8_store_matches_jax():
    """Quantize-on-store (stored = round(x / scale), saturating), bit for
    bit; values reach past the int8 range."""
    rng = np.random.default_rng(3)
    kv = (rng.standard_normal((20, PACKED)) * 8).astype(np.float32)
    slots = rng.permutation(4 * PS)[:20].astype(np.int32)
    slots[[2, 11]] = -1
    ref = jax_cache_mla(jnp.asarray(kv), jnp.zeros((4, PS, PACKED), jnp.int8), jnp.asarray(slots), scale=1 / 32)
    cache = torch.zeros((4, PS, PACKED), dtype=torch.int8)
    reshape_and_cache_mla(torch.from_numpy(kv), cache, torch.from_numpy(slots), scale=1 / 32)
    np.testing.assert_array_equal(cache.numpy(), np.asarray(ref))
    assert cache.abs().max() == 127


def test_reshape_and_cache_mla_all_dropped_keeps_cache():
    cache = torch.randn((2, PS, PACKED))
    before = cache.clone()
    reshape_and_cache_mla(torch.randn((3, PACKED)), cache, torch.tensor([-1, -1, -1], dtype=torch.int32))
    assert torch.equal(cache, before)


def test_mla_validation():
    """The errors of tests/mla_attention_test.py:86; an int8 latent cache,
    once refused, is read with kv_scale folded into the scores and the
    output (against the same values dequantized, in f32)."""
    q = torch.zeros((2, 4, 256))
    cache = torch.zeros((4, 16, 256))
    cu = torch.tensor([0, 1, 2], dtype=torch.int32)
    sl = torch.ones(2, dtype=torch.int32)
    bt = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="latent"):
        mla_attention(q, cache, cu, 1, sl, bt, scale=1.0, latent=512)
    with pytest.raises(ValueError, match="packed"):
        mla_attention(q, torch.zeros((4, 16, 128)), cu, 1, sl, bt, scale=1.0, latent=64)
    with pytest.raises(ValueError, match="lane multiple"):
        mla_attention(torch.zeros((2, 4, 192)), torch.zeros((4, 16, 192)), cu, 1, sl, bt, scale=1.0, latent=64)
    with pytest.raises(ValueError, match="batch mismatch"):
        mla_attention(q, cache, cu, 1, sl, torch.zeros((3, 4), dtype=torch.int32), scale=1.0, latent=64)
    codes = torch.arange(-64, 64, dtype=torch.int8).repeat(2).reshape(1, 1, 256).expand(4, 16, 256).contiguous()
    q = torch.linspace(-1, 1, 2 * 4 * 256).reshape(2, 4, 256)
    out = mla_attention(q, codes, cu, 1, sl, bt, scale=0.5, latent=64, kv_scale=1 / 16)
    same = mla_attention(q, codes.float() / 16, cu, 1, sl, bt, scale=0.5, latent=64)
    assert out.shape == (2, 4, 64) and torch.isfinite(out).all() and out.abs().max() > 0
    torch.testing.assert_close(out, same, atol=2e-4, rtol=2e-4)
