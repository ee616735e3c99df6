# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Port paged and varlen attention with softcap and a sliding window (the
options K3 and K7 gained for Gemma-2) against the JAX package's ops (the
Pallas kernels in interpret mode), through the port's plain path on the
CPU.

A 3-layer pool read at layer 1, page 16, window 24 with lengths up to 100
(past the window), softcap 50 and Gemma-2's scale, 1/16. Decode: an idle
row that is not first, a length of 1, lengths on and off page multiples.
Prefill, as the engine packs it: a mixed-in decode row, a fresh prompt,
the trailing chunk of a longer prompt, zero-length padding sequences and
padding rows. Tolerances are those of tests/paged_attention_test.py:21
and tests/varlen_attention_test.py:25.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.ops.attention import paged_attention as jax_paged
from conch_tpu.ops.attention import varlen_attention as jax_varlen
from conch_tpu_torch.ops.attention import paged_attention, varlen_attention
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

PAGED_TOL = {"float32": 2e-3, "bfloat16": 3e-2}
VARLEN_TOL = {"float32": 2e-3, "bfloat16": 2e-2}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
L, PS, MAX_PAGES, LAYER = 3, 16, 8, 1
QH, KH, D = 4, 2, 128
SCALE, WINDOW = 1.0 / 16.0, 24
DECODE_LENS = [37, 0, 100, 1, 64, 25]
Q_LENS = [1, 23, 30, 0, 0]
SEQ_LENS = [70, 23, 100, 0, 0]
ROWS = 64  # 54 real rows, 10 padding rows
# (dtype, softcap, window): each option alone and both in f32, both in bf16.
CASES = [("float32", 50.0, 0), ("float32", 0.0, WINDOW), ("float32", 50.0, WINDOW), ("bfloat16", 50.0, WINDOW)]


def make_pool(rng, seq_lens, rows):
    num_pages = sum(-(-n // PS) for n in seq_lens) + 2
    perm = iter(rng.permutation(np.arange(1, num_pages)).tolist())
    bt = np.zeros((len(seq_lens), MAX_PAGES), np.int32)
    for b, n in enumerate(seq_lens):
        for p in range(-(-n // PS)):
            bt[b, p] = next(perm)
    kc = rng.normal(size=(L, num_pages, KH, PS, D)).astype(np.float32)
    vc = rng.normal(size=(L, num_pages, KH, PS, D)).astype(np.float32)
    # Logits of a few tens, so softcap 50 bends them.
    q = (4.0 * rng.normal(size=(rows, QH, D))).astype(np.float32)
    return q, kc, vc, bt


@pytest.mark.parametrize("dtype,softcap,window", CASES)
def test_paged_attention_softcap_window_match_jax(softcap, window, dtype):
    rng = np.random.default_rng(41)
    q, kc, vc, bt = make_pool(rng, DECODE_LENS, len(DECODE_LENS))
    sl = np.asarray(DECODE_LENS, np.int32)
    jd, td = JAX_DTYPES[dtype], TORCH_DTYPES[dtype]
    ref = jax_paged(
        jnp.asarray(q, jd), jnp.asarray(kc, jd), jnp.asarray(vc, jd), jnp.asarray(bt), jnp.asarray(sl),
        scale=SCALE, softcap=softcap, window_size=window, layer_idx=jnp.asarray(LAYER, jnp.int32),
    )
    out = paged_attention(
        torch.from_numpy(q).to(td), torch.from_numpy(kc).to(td), torch.from_numpy(vc).to(td),
        torch.from_numpy(bt), torch.from_numpy(sl), scale=SCALE, softcap=softcap, window_size=window,
        layer_idx=LAYER,
    )
    assert out.dtype == td and out.shape == q.shape
    tol = PAGED_TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol)
    assert torch.isfinite(out).all() and out[1].abs().max().item() == 0.0  # idle row


@pytest.mark.parametrize("dtype,softcap,window", CASES)
def test_varlen_attention_softcap_window_match_jax(softcap, window, dtype):
    rng = np.random.default_rng(42)
    q, kc, vc, bt = make_pool(rng, SEQ_LENS, ROWS)
    cu = np.concatenate([[0], np.cumsum(Q_LENS)]).astype(np.int32)
    sl = np.asarray(SEQ_LENS, np.int32)
    total = int(cu[-1])
    jd, td = JAX_DTYPES[dtype], TORCH_DTYPES[dtype]
    ref = jax_varlen(
        jnp.asarray(q, jd), jnp.asarray(kc, jd), jnp.asarray(vc, jd), jnp.asarray(cu), 32, jnp.asarray(sl),
        int(sl.max()), jnp.asarray(bt), causal=True, scale=SCALE, softcap=softcap, window_size=window,
        layer_idx=jnp.asarray(LAYER, jnp.int32),
    )
    out = varlen_attention(
        torch.from_numpy(q).to(td), torch.from_numpy(kc).to(td), torch.from_numpy(vc).to(td),
        torch.from_numpy(cu), 32, torch.from_numpy(sl), int(sl.max()), torch.from_numpy(bt), causal=True,
        scale=SCALE, softcap=softcap, window_size=window, layer_idx=LAYER,
    )
    assert out.dtype == td and out.shape == q.shape
    tol = VARLEN_TOL[dtype]
    np.testing.assert_allclose(out[:total].float().numpy(), np.asarray(ref, np.float32)[:total], atol=tol, rtol=tol)
    assert torch.isfinite(out).all() and out[total:].abs().max().item() == 0.0  # padding rows


def test_window_keeps_exactly_the_last_keys():
    """With window w, decode attention equals attention over a cache that
    holds only the last w tokens, and a prefill row at position p equals
    decode at seq_len p + 1: the two kernels' window rules agree."""
    rng = np.random.default_rng(43)
    q, kc, vc, bt = map(torch.from_numpy, make_pool(rng, SEQ_LENS, ROWS))
    sl = torch.tensor([100], dtype=torch.int32)
    windowed = paged_attention(q[:1], kc, vc, bt[2:3], sl, scale=SCALE, window_size=WINDOW, layer_idx=LAYER)
    # The same keys moved to the front of a fresh 24-token sequence.
    keep = torch.arange(100 - WINDOW, 100)
    pages, entries = bt[2, keep // PS].long(), keep % PS
    kc2, vc2 = kc.clone(), vc.clone()
    fresh = torch.tensor([[0, 1, 0, 0, 0, 0, 0, 0]], dtype=torch.int32)
    for i in range(WINDOW):
        kc2[LAYER, i // PS, :, i % PS] = kc[LAYER, pages[i], :, entries[i]]
        vc2[LAYER, i // PS, :, i % PS] = vc[LAYER, pages[i], :, entries[i]]
    moved = paged_attention(q[:1], kc2, vc2, fresh, torch.tensor([WINDOW], dtype=torch.int32), scale=SCALE,
                            layer_idx=LAYER)
    torch.testing.assert_close(windowed, moved, atol=1e-5, rtol=1e-5)

    cu = torch.tensor([0, 30], dtype=torch.int32)
    pre = varlen_attention(q[:30], kc, vc, cu, 32, sl, 100, bt[2:3], causal=True, scale=SCALE,
                           window_size=WINDOW, layer_idx=LAYER)
    for j in (0, 17, 29):
        dec = paged_attention(q[j : j + 1], kc, vc, bt[2:3], torch.tensor([71 + j], dtype=torch.int32),
                              scale=SCALE, window_size=WINDOW, layer_idx=LAYER)
        torch.testing.assert_close(pre[j : j + 1], dec, atol=1e-5, rtol=1e-5)
