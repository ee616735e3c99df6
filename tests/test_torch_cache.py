# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Port KV-cache writes (conch_tpu_torch, K2's module) against the JAX package.

The stacked write (K2) and the per-layer prefill write go through both
``conch_tpu.ops.cache`` (the Pallas kernel in interpret mode / the XLA
scatter) and ``conch_tpu_torch.ops.cache`` on ``device="cpu"``, from the
same numpy inputs; the caches must agree exactly (a write is a copy).
The pool has 3 layers and the write lands in a non-zero layer, so a
wrong layer stride cannot go unnoticed. K2's stacked write is held in
f32, bf16 and f16 (an f16 store into an f16 cache is a copy, bit for bit).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.ops.cache import reshape_and_cache as jax_write
from conch_tpu.ops.cache import reshape_and_cache_stacked as jax_write_stacked
from conch_tpu_torch.kernels.cache.reshape_and_cache import reshape_and_cache_stacked_launcher
from conch_tpu_torch.ops.cache import reshape_and_cache, reshape_and_cache_stacked
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
L, P, KH, PS, D = 3, 12, 2, 16, 128


def _pool(rng, dtype):
    kc = rng.normal(size=(L, P, KH, PS, D)).astype(np.float32)
    vc = rng.normal(size=(L, P, KH, PS, D)).astype(np.float32)
    return kc, vc


def _to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


@pytest.mark.parametrize("layer", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_stacked_write_matches_jax(layer, dtype):
    """Decode-shaped write: one token per sequence, an idle row (slot -1),
    page 0 in use, entries off the 8-entry windows' starts. The JAX kernel
    takes at most one token per (page, 8-entry window), which holds here."""
    rng = np.random.default_rng(11)
    kc, vc = _pool(rng, dtype)
    t = 6
    k = rng.normal(size=(t, KH, D)).astype(np.float32)
    v = rng.normal(size=(t, KH, D)).astype(np.float32)
    slots = np.array([0 * PS + 5, 3 * PS + 15, -1, 7 * PS + 8, 11 * PS + 1, 3 * PS + 2], np.int32)

    jd, td = JAX_DTYPES[dtype], TORCH_DTYPES[dtype]
    jk, jv = jax_write_stacked(
        jnp.asarray(k, jd), jnp.asarray(v, jd), jnp.asarray(kc, jd), jnp.asarray(vc, jd),
        jnp.asarray(slots), jnp.asarray(layer, jnp.int32),
    )
    tkc, tvc = torch.from_numpy(kc).to(td), torch.from_numpy(vc).to(td)
    out_k, out_v = reshape_and_cache_stacked(
        torch.from_numpy(k).to(td), torch.from_numpy(v).to(td), tkc, tvc, torch.from_numpy(slots), layer
    )
    assert out_k is tkc and out_v is tvc  # updated in place
    np.testing.assert_array_equal(_to_np(tkc), _to_np(jk))
    np.testing.assert_array_equal(_to_np(tvc), _to_np(jv))
    untouched = [i for i in range(L) if i != layer]
    np.testing.assert_array_equal(_to_np(tkc)[untouched], _to_np(torch.from_numpy(kc).to(td))[untouched])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_layer_prefill_write_matches_jax(dtype):
    """Prefill-shaped write: many tokens per page, lengths off page
    multiples, padding rows with slot -1 at the tail."""
    rng = np.random.default_rng(12)
    kc, vc = _pool(rng, dtype)
    kc, vc = kc[0], vc[0]
    t = 32
    k = rng.normal(size=(t, KH, D)).astype(np.float32)
    v = rng.normal(size=(t, KH, D)).astype(np.float32)
    slots = np.concatenate([np.arange(2 * PS + 3, 2 * PS + 3 + 21), 5 * PS + np.arange(4), -np.ones(7)]).astype(np.int32)

    jd, td = JAX_DTYPES[dtype], TORCH_DTYPES[dtype]
    jk, jv = jax_write(
        jnp.asarray(k, jd), jnp.asarray(v, jd), jnp.asarray(kc, jd), jnp.asarray(vc, jd), jnp.asarray(slots)
    )
    tkc, tvc = torch.from_numpy(kc).to(td), torch.from_numpy(vc).to(td)
    reshape_and_cache(torch.from_numpy(k).to(td), torch.from_numpy(v).to(td), tkc, tvc, torch.from_numpy(slots))
    np.testing.assert_array_equal(_to_np(tkc), _to_np(jk))
    np.testing.assert_array_equal(_to_np(tvc), _to_np(jv))


def test_stacked_write_takes_many_tokens_per_page_and_strided_rows():
    """The port has no one-token-per-window limit: a whole prefill chunk
    through the stacked write equals the per-layer write. k and v are
    column slices of a fused qkv product, as the model passes them."""
    rng = np.random.default_rng(13)
    kc, vc = _pool(rng, "float32")
    t = 20
    qkv = torch.from_numpy(rng.normal(size=(t, 3 * KH * D)).astype(np.float32))
    k = qkv[:, KH * D : 2 * KH * D].view(t, KH, D)
    v = qkv[:, 2 * KH * D :].view(t, KH, D)
    slots = torch.from_numpy(np.concatenate([np.arange(PS + 1, PS + 18), [-1, -1, 0]]).astype(np.int32))
    a_k, a_v = torch.from_numpy(kc), torch.from_numpy(vc)
    b_k, b_v = a_k.clone(), a_v.clone()
    before = reshape_and_cache_stacked_launcher.launches
    reshape_and_cache_stacked(k, v, a_k, a_v, slots, 2)
    reshape_and_cache(k.contiguous(), v.contiguous(), b_k[2], b_v[2], slots)
    assert torch.equal(a_k, b_k) and torch.equal(a_v, b_v)
    assert reshape_and_cache_stacked_launcher.launches == before  # CPU: plain version, no launch


def test_unported_options_raise():
    """int8 caches, once refused, now store: x times the f32 reciprocal of
    the scale, rounded half to even (2.5 -> 2, 3.5 -> 4), clipped. A
    kv_cache_dtype that does not name the caches' dtype, an unknown one and
    a layer outside the pool still raise."""
    kc = torch.zeros(L, P, KH, PS, D)
    k = torch.zeros(1, KH, D)
    slots = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="int8"):
        reshape_and_cache_stacked(k, k, kc, kc, slots, 0, kv_cache_dtype="int8")
    with pytest.raises(ValueError, match="Unsupported"):
        reshape_and_cache_stacked(k, k, kc, kc, slots, 0, kv_cache_dtype="fp16")
    with pytest.raises(IndexError):
        reshape_and_cache_stacked(k, k, kc, kc, slots, L)
    kq, vq = torch.zeros(L, P, KH, PS, D, dtype=torch.int8), torch.zeros(L, P, KH, PS, D, dtype=torch.int8)
    with pytest.raises(ValueError, match="auto"):
        reshape_and_cache_stacked(k, k, kq, vq, slots, 0)
    k[0, 0, :4] = torch.tensor([2.5, 3.5, 100.0, -100.0]) / 16
    scale = torch.tensor([1 / 16])
    reshape_and_cache_stacked(k, 2 * k, kq, vq, slots, 1, kv_cache_dtype="int8", k_scale=scale, v_scale=scale)
    assert kq[1, 0, 0, 0, :4].tolist() == [2, 4, 100, -100]
    assert vq[1, 0, 0, 0, :4].tolist() == [5, 7, 127, -128]
    assert kq[0].abs().sum() == 0 and kq[2].abs().sum() == 0
