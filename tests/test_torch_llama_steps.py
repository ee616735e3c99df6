# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""The slice step by step: the port's llama_prefill / llama_decode_step
logits against the JAX package's, in f32 and bf16.

JAX params (``conch_tpu.models.llama.init_llama_params``: 3 layers,
hidden 256, 4 query heads / 1 KV head, head_dim 128, so the JAX side runs
the same all-heads Pallas kernels as at full width, in interpret mode)
are carried over with ``params_from_jax`` and fused on both sides. The
same step inputs then go through both: a prefill of two fresh prompts
with padding rows and zero-length padding sequences, a chunked prefill
step with a mixed-in decode row, and two decode steps with idle rows.
Logits and the final KV pool must agree within TOLERANCES.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from conch_tpu.models.llama import fuse_llama_params as jax_fuse
from conch_tpu.models.llama import init_kv_caches as jax_init_kv_caches
from conch_tpu.models.llama import init_llama_params as jax_init_llama_params
from conch_tpu.models.llama import llama_decode_step as jax_decode_step
from conch_tpu.models.llama import llama_prefill as jax_prefill
from conch_tpu_torch.models.llama import (
    LlamaConfig,
    fuse_llama_params,
    init_kv_caches,
    llama_decode_step,
    llama_prefill,
    params_from_jax,
)
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

DIMS = {
    "vocab_size": 256, "hidden_size": 256, "intermediate_size": 512, "num_layers": 3,
    "num_heads": 4, "num_kv_heads": 1, "head_dim": 128,
}
# Absolute and relative tolerance on logits and on the KV pool: the
# attention ops' own tolerances (tests/paged_attention_test.py:21), f32
# 2e-3 and bf16 3e-2. In f32 the two sides differ only in summation
# order; in bf16 the frameworks also round intermediates at different
# places, and the logits (magnitude about 1 here) are rounded to bf16.
TOLERANCES = {"float32": 2e-3, "bfloat16": 3e-2}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PS, NUM_PAGES, ROWS, BATCH, MAX_PAGES = 16, 16, 64, 4, 6
PAGES = [[3, 7, 1, 9, 10], [0, 5]]  # page 0 is a real page


def _steps():
    """Host-side inputs of each step, as the engine builds them."""
    rng = np.random.default_rng(4)
    bt = np.zeros((BATCH, MAX_PAGES), np.int32)
    for b, pages in enumerate(PAGES):
        bt[b, : len(pages)] = pages

    def slot(b, pos):
        return PAGES[b][pos // PS] * PS + pos % PS

    def prefill(chunks):  # chunks: [(seq, start, length)]
        tokens = np.zeros(ROWS, np.int32)
        positions = np.zeros(ROWS, np.int32)
        slots = np.full(ROWS, -1, np.int32)
        cu = np.zeros(BATCH + 1, np.int32)
        seq_lens = np.zeros(BATCH, np.int32)
        row = 0
        for i, (b, start, n) in enumerate(chunks):
            tokens[row : row + n] = rng.integers(0, 256, n)
            positions[row : row + n] = np.arange(start, start + n)
            slots[row : row + n] = [slot(b, p) for p in range(start, start + n)]
            row += n
            cu[i + 1] = row
            seq_lens[i] = start + n
        cu[len(chunks) + 1 :] = row  # zero-length padding sequences
        table = np.zeros_like(bt)
        table[: len(chunks)] = bt[[b for b, _, _ in chunks]]
        return ("prefill", tokens, positions, cu, seq_lens, table, slots)

    def decode(pos):  # rows 0, 1 active at these positions; rows 2, 3 idle
        tokens = np.zeros(BATCH, np.int32)
        tokens[:2] = rng.integers(0, 256, 2)
        positions = np.array([pos[0], pos[1], 0, 0], np.int32)
        seq_lens = np.array([pos[0] + 1, pos[1] + 1, 0, 0], np.int32)
        slots = np.array([slot(0, pos[0]), slot(1, pos[1]), -1, -1], np.int32)
        return ("decode", tokens, positions, seq_lens, bt, slots)

    return [
        prefill([(0, 0, 40), (1, 0, 21)]),  # two fresh prompts, 3 padding rows
        prefill([(1, 21, 1), (0, 40, 30)]),  # a decode row, then a 30-token chunk
        decode((70, 22)),
        decode((71, 23)),
    ]


def _run_jax(params, cfg, steps):
    params = jax_fuse(params)
    prefill = jax.jit(lambda p, *a: jax_prefill(p, cfg, *a[:3], ROWS, *a[3:]))
    decode = jax.jit(lambda p, *a: jax_decode_step(p, cfg, *a))
    kc, vc = jax_init_kv_caches(cfg, NUM_PAGES, PS)
    logits = []
    for kind, *arrays in steps:
        fn = prefill if kind == "prefill" else decode
        out, kc, vc = fn(params, *map(jnp.asarray, arrays), kc, vc)
        logits.append(np.asarray(out))
    return logits, np.asarray(kc, np.float32), np.asarray(vc, np.float32)


def _run_port(params, cfg, steps):
    params = fuse_llama_params(params)
    kc, vc = init_kv_caches(cfg, NUM_PAGES, PS, device="cpu")
    logits = []
    for kind, *arrays in steps:
        tensors = [torch.from_numpy(a) for a in arrays]
        if kind == "prefill":
            out, _, _ = llama_prefill(params, cfg, *tensors[:3], ROWS, *tensors[3:], kc, vc)
        else:
            out, _, _ = llama_decode_step(params, cfg, *tensors, kc, vc)
        logits.append(out.numpy())
    return logits, kc.float().numpy(), vc.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_logits_match_jax(dtype):
    jax_cfg = JaxLlamaConfig(**DIMS, dtype=JAX_DTYPES[dtype])
    cfg = LlamaConfig(**DIMS, dtype=TORCH_DTYPES[dtype])
    jax_params = jax_init_llama_params(0, jax_cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jax_params), cfg, device="cpu")
    assert params["layers"]["wq"].arrays["w"].dtype == torch.bfloat16
    assert params["embedding"].dtype == TORCH_DTYPES[dtype]

    steps = _steps()
    jax_logits, jax_kc, jax_vc = _run_jax(jax_params, jax_cfg, steps)
    logits, kc, vc = _run_port(params, cfg, steps)
    tol = TOLERANCES[dtype]
    for i, (ours, ref) in enumerate(zip(logits, jax_logits)):
        assert ours.dtype == np.float32 and ours.shape == ref.shape == (BATCH, DIMS["vocab_size"])
        np.testing.assert_allclose(ours, ref, atol=tol, rtol=tol, err_msg=f"step {i}")
    np.testing.assert_allclose(kc, jax_kc, atol=tol, rtol=tol)
    np.testing.assert_allclose(vc, jax_vc, atol=tol, rtol=tol)


def test_params_from_jax_is_bit_exact_for_bf16():
    cfg = JaxLlamaConfig(**DIMS)
    jax_params = jax.tree.map(np.asarray, jax_init_llama_params(1, cfg))
    params = params_from_jax(jax_params, LlamaConfig(**DIMS), device="cpu")
    ref = jax_params["layers"]["wq"].arrays["w"]
    ours = params["layers"]["wq"].arrays["w"]
    np.testing.assert_array_equal(ours.view(torch.int16).numpy().view(np.uint16), ref.view(np.uint16))
    np.testing.assert_array_equal(params["cos_sin_cache"].numpy(), jax_params["cos_sin_cache"])
