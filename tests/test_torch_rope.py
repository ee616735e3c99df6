# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Port RoPE (conch_tpu_torch, K5's module) against the JAX package.

Inputs come from a numpy seed and go through both ``conch_tpu.ops``
(the Pallas kernel in interpret mode on the CPU) and
``conch_tpu_torch.ops`` on ``device="cpu"`` (the kernel's plain version).
Tolerances are those of tests/rotary_embedding_test.py:21 (f16 too,
which both packages rotate in f32 and round once).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.ops.embedding import rotary_embedding as jax_rope
from conch_tpu.reference.embedding.rotary_embedding import compute_cos_sin_cache as jax_cache
from conch_tpu_torch.kernels.embedding.rotary_embedding import rotary_embedding_launcher
from conch_tpu_torch.ops.embedding import rotary_embedding
from conch_tpu_torch.reference.embedding.rotary_embedding import compute_cos_sin_cache
from conch_tpu_torch.reference.embedding.rotary_embedding import rotary_embedding as rope_reference

TOLERANCES = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 1e-3}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
LLAMA31_SCALING = {
    "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
    "high_freq_factor": 4.0, "original_max_position_embeddings": 8192,
}


def _as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


@pytest.mark.parametrize("rope_scaling", [None, LLAMA31_SCALING])
def test_cos_sin_cache_matches_jax(rope_scaling):
    ours = compute_cos_sin_cache(500000.0, 128, 1024, rope_scaling=rope_scaling)
    ref = np.asarray(jax_cache(500000.0, 128, 1024, rope_scaling=rope_scaling))
    assert ours.dtype == torch.float32 and ours.shape == (1024, 128)
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("num_tokens", [1, 7, 128])
@pytest.mark.parametrize("num_q_heads,num_k_heads,head_size", [(32, 8, 128), (4, 1, 128), (8, 8, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_rope_matches_jax(num_tokens, num_q_heads, num_k_heads, head_size, dtype):
    rng = np.random.default_rng(7)
    max_pos = 1024
    positions = rng.integers(0, max_pos, size=num_tokens).astype(np.int32)
    q = rng.normal(size=(num_tokens, num_q_heads * head_size)).astype(np.float32)
    k = rng.normal(size=(num_tokens, num_k_heads * head_size)).astype(np.float32)

    jq, jk = jax_rope(
        jnp.asarray(positions), jnp.asarray(q, JAX_DTYPES[dtype]), jnp.asarray(k, JAX_DTYPES[dtype]),
        head_size, jax_cache(10000.0, head_size, max_pos),
    )
    tq, tk = rotary_embedding(
        torch.from_numpy(positions), torch.from_numpy(q).to(TORCH_DTYPES[dtype]),
        torch.from_numpy(k).to(TORCH_DTYPES[dtype]), head_size, compute_cos_sin_cache(10000.0, head_size, max_pos),
    )
    tol = TOLERANCES[dtype]
    assert tq.dtype == TORCH_DTYPES[dtype] and tq.shape == q.shape and tk.shape == k.shape
    np.testing.assert_allclose(_as_f32(tq), _as_f32(jq), atol=tol, rtol=tol)
    np.testing.assert_allclose(_as_f32(tk), _as_f32(jk), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_strided_qkv_slices_match_reference(dtype):
    """The model feeds q and k as column slices of the fused qkv product;
    the result must equal rotating contiguous copies (and the golden
    reference, computed in the input dtype, within the dtype's tolerance)."""
    rng = np.random.default_rng(3)
    t, qh, kh, d = 9, 4, 1, 128
    cache = compute_cos_sin_cache(500000.0, d, 256, rope_scaling=LLAMA31_SCALING)
    qkv = torch.from_numpy(rng.normal(size=(t, (qh + 2 * kh) * d)).astype(np.float32)).to(TORCH_DTYPES[dtype])
    positions = torch.from_numpy(rng.integers(0, 256, size=t).astype(np.int32))
    q, k = qkv[:, : qh * d], qkv[:, qh * d : (qh + kh) * d]
    out_q, out_k = rotary_embedding(positions, q, k, d, cache)
    ref_q, ref_k = rotary_embedding(positions, q.contiguous(), k.contiguous(), d, cache)
    assert torch.equal(out_q, ref_q) and torch.equal(out_k, ref_k)
    assert out_q.is_contiguous() and out_k.is_contiguous()
    gold_q, gold_k = rope_reference(positions, q, k, cache, d, d)
    tol = TOLERANCES[dtype]
    np.testing.assert_allclose(_as_f32(out_q), _as_f32(gold_q), atol=tol, rtol=tol)
    np.testing.assert_allclose(_as_f32(out_k), _as_f32(gold_k), atol=tol, rtol=tol)


def test_rope_partial_rotary_dim_keeps_tail():
    rng = np.random.default_rng(5)
    t, d, rot = 4, 128, 64
    cache = compute_cos_sin_cache(10000.0, rot, 64)
    q = torch.from_numpy(rng.normal(size=(t, 2 * d)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(t, d)).astype(np.float32))
    positions = torch.arange(t, dtype=torch.int32)
    out_q, out_k = rotary_embedding(positions, q, k, d, cache)
    gold_q, gold_k = rope_reference(positions, q, k, cache, rot, d)
    torch.testing.assert_close(out_q, gold_q, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out_k, gold_k, atol=1e-5, rtol=1e-5)
    assert torch.equal(out_q.view(t, 2, d)[..., rot:], q.view(t, 2, d)[..., rot:])


def test_rope_cpu_path_counts_no_launch_and_rejects_gptj():
    before = rotary_embedding_launcher.launches
    cache = compute_cos_sin_cache(10000.0, 64, 16)
    x = torch.zeros(2, 64)
    rotary_embedding(torch.zeros(2, dtype=torch.int32), x, x, 64, cache)
    assert rotary_embedding_launcher.launches == before
    with pytest.raises(NotImplementedError):
        rotary_embedding(torch.zeros(2, dtype=torch.int32), x, x, 64, cache, is_neox=False)
