# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""The four speculative verify steps against the JAX package's.

Each family's JAX params are carried across bit for bit; the same two
steps go through both packages: a 32-row prefill of two prompts (20 and
12 tokens, no padding row) that fills the cache, then a verify step of the
engine's shape, 16 rows, ``max_seqlen_q`` 16, with zero-length padding
sequences: 5 and 3 query rows a sequence (8 padding rows), or 8 and 8 (no
padding row). Every row's logits are compared:

- Llama-3 shapes in f32, with int4 projections (group 128, f32
  activations) and over an int8 KV cache;
- Gemma-2 with both softcaps, layer 0's 24-token window (the verify rows
  at positions 20 to 24 cross it) and random norm weights;
- DeepSeek-V2 (one dense and one MoE layer, capacity factor 0.5, so that
  the step drops selections), padding rows included: they carry the JAX
  launcher's copies of a row of the last sequence, and take capacity;
- Mixtral (capacity factor 0.5) on the step without padding rows. On the
  padded step JAX's logits are NaN (its varlen launcher's padding rows
  spread through the dispatch einsum; ROADMAP Queue 3), the port's finite.

Where JAX's padding rows are NaN (its varlen launcher), the live rows are
compared and the port's padding rows must be finite. Tolerances: logits
at TOLERANCES (tests/test_torch_llama_steps.py:48), f32 2e-3 absolute and
relative; DeepSeek at its steps' 1e-4 (tests/test_torch_deepseek.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conch_tpu.models.deepseek as jax_ds
import conch_tpu.models.gemma as jax_gemma
import conch_tpu.models.llama as jax_llama
import conch_tpu.models.moe as jax_moe
import conch_tpu_torch.models.deepseek as ds
import conch_tpu_torch.models.gemma as gemma
import conch_tpu_torch.models.llama as llama
import conch_tpu_torch.models.moe as moe
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

TOLERANCES = {"float32": 2e-3}
DEEPSEEK_TOL = 1e-4
PS, NUM_PAGES, PREFILL_ROWS, VERIFY_ROWS, BATCH, MAX_PAGES = 16, 12, 32, 16, 4, 3
PAGES = [[3, 7, 1], [0, 5, 2]]  # page 0 is a real page
CONTEXT = (20, 12)
LLAMA_DIMS = {
    "vocab_size": 256, "hidden_size": 256, "intermediate_size": 512, "num_layers": 2, "num_heads": 4,
    "num_kv_heads": 1, "head_dim": 128,
}
GEMMA_DIMS = {
    "vocab_size": 128, "hidden_size": 128, "intermediate_size": 256, "num_layers": 2, "num_heads": 4,
    "num_kv_heads": 2, "head_dim": 128, "max_position": 512, "attn_logit_softcap": 50.0,
    "final_logit_softcap": 30.0, "gemma2": True, "sliding_window": 24, "query_pre_attn_scalar": 64.0,
}
DEEPSEEK_DIMS = {
    "vocab_size": 128, "hidden_size": 64, "num_layers": 2, "num_heads": 4, "kv_lora_rank": 32,
    "qk_rope_head_dim": 16, "qk_nope_head_dim": 32, "v_head_dim": 32, "n_routed_experts": 4,
    "n_shared_experts": 1, "num_experts_per_tok": 2, "moe_intermediate_size": 32, "intermediate_size": 64,
    "first_k_dense_replace": 1, "moe_capacity_factor": 0.5,
}
MIXTRAL_DIMS = {"vocab_size": 64, "hidden_size": 64, "intermediate_size": 128, "num_layers": 2, "num_heads": 2,
                "num_kv_heads": 1, "head_dim": 32, "max_position": 128}
MIXTRAL_MOE = {"num_experts": 4, "top_k": 2, "capacity_factor": 0.5}


def _slot(b: int, pos: int) -> int:
    return PAGES[b][pos // PS] * PS + pos % PS


def _steps(vocab: int, q_lens: tuple[int, int]) -> list[tuple]:
    """(kind, rows, arrays): the prefill of CONTEXT, then a verify step of
    ``q_lens`` rows at the next positions, as the engine builds them."""
    rng = np.random.default_rng(7)
    bt = np.zeros((BATCH, MAX_PAGES), np.int32)
    for b, pages in enumerate(PAGES):
        bt[b, : len(pages)] = pages

    def step(starts, lens, rows):
        total = sum(lens)
        tokens = np.zeros(rows, np.int32)
        tokens[:total] = rng.integers(0, vocab, total)
        positions = np.zeros(rows, np.int32)
        positions[:total] = np.concatenate([np.arange(s, s + n) for s, n in zip(starts, lens)])
        slots = np.full(rows, -1, np.int32)
        slots[:total] = [_slot(b, p) for b, (s, n) in enumerate(zip(starts, lens)) for p in range(s, s + n)]
        cu = np.array([0, lens[0], total, total, total], np.int32)
        seq_lens = np.array([starts[0] + lens[0], starts[1] + lens[1], 0, 0], np.int32)
        return (rows, tokens, positions, cu, seq_lens, bt, slots)

    return [("prefill", *step((0, 0), CONTEXT, PREFILL_ROWS)), ("verify", *step(CONTEXT, q_lens, VERIFY_ROWS))]


def _run_jax(params, cfg, prefill_fn, verify_fn, caches, steps) -> np.ndarray:
    """The verify step's logits, after the prefill."""
    kc, vc = caches
    for kind, rows, *arrays in steps:
        fn = prefill_fn if kind == "prefill" else verify_fn
        step = jax.jit(lambda p, *a, fn=fn, rows=rows: fn(p, cfg, *a[:3], rows, *a[3:]))
        logits, kc, vc = step(params, *map(jnp.asarray, arrays), kc, vc)
    return np.asarray(logits)


def _run_port(params, cfg, prefill_fn, verify_fn, caches, steps) -> np.ndarray:
    kc, vc = caches
    for kind, rows, *arrays in steps:
        t = [torch.from_numpy(a) for a in arrays]
        fn = prefill_fn if kind == "prefill" else verify_fn
        logits, kc_out, vc_out = fn(params, cfg, *t[:3], rows, *t[3:], kc, vc)
        assert kc_out is kc and vc_out is vc  # updated in place
    return logits.numpy()


def _compare(ours: np.ndarray, ref: np.ndarray, total: int, tol: float, rows: int = VERIFY_ROWS) -> None:
    """Every row's logits of shape (rows, vocab); the port's all finite; the
    live rows within ``tol`` of JAX's."""
    assert ours.shape == ref.shape == (rows, ref.shape[1]) and ours.dtype == np.float32
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours[:total], ref[:total], atol=tol, rtol=tol)


LLAMA_CASES = {"f32": ("bf16", None), "int4": ("int4", None), "kv-int8": ("bf16", "int8")}


@pytest.mark.parametrize("case", list(LLAMA_CASES))
def test_llama_verify_forward_matches_jax(case):
    quant_mode, cache = LLAMA_CASES[case]
    jd, td = (jnp.int8, torch.int8) if cache else (None, None)
    jax_cfg = jax_llama.LlamaConfig(**LLAMA_DIMS, dtype=jnp.float32)
    cfg = llama.LlamaConfig(**LLAMA_DIMS, dtype=torch.float32)
    tree = jax_llama.init_llama_params(0, jax_cfg, quant_mode)
    params = llama.fuse_llama_params(llama.params_from_jax(jax.tree.map(np.asarray, tree), cfg, device="cpu"))
    steps = _steps(cfg.vocab_size, (5, 3))
    ref = _run_jax(jax_llama.fuse_llama_params(tree), jax_cfg, jax_llama.llama_prefill,
                   jax_llama.llama_verify_forward,
                   jax_llama.init_kv_caches(jax_cfg, NUM_PAGES, PS, cache_dtype=jd), steps)
    ours = _run_port(params, cfg, llama.llama_prefill, llama.llama_verify_forward,
                     llama.init_kv_caches(cfg, NUM_PAGES, PS, cache_dtype=td, device="cpu"), steps)
    _compare(ours, ref, 8, TOLERANCES["float32"])


def test_gemma_verify_forward_matches_jax():
    jax_cfg = jax_gemma.GemmaConfig(**GEMMA_DIMS, dtype=jnp.float32)
    cfg = gemma.GemmaConfig(**GEMMA_DIMS, dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jax_gemma.init_gemma_params(0, jax_cfg))
    rng = np.random.default_rng(1)
    layers = {n: (0.3 * rng.normal(size=w.shape)).astype(w.dtype) if n.endswith("_norm") else w
              for n, w in tree["layers"].items()}
    tree = {**tree, "layers": layers}
    params = llama.fuse_llama_params(gemma.gemma_params_from_jax(tree, cfg, device="cpu"))
    steps = _steps(cfg.vocab_size, (5, 3))
    ref = _run_jax(jax_llama.fuse_llama_params(jax.tree.map(jnp.asarray, tree)), jax_cfg, jax_gemma.gemma_prefill,
                   jax_gemma.gemma_verify_forward, jax_gemma.init_gemma_kv_caches(jax_cfg, NUM_PAGES, PS), steps)
    ours = _run_port(params, cfg, gemma.gemma_prefill, gemma.gemma_verify_forward,
                     gemma.init_gemma_kv_caches(cfg, NUM_PAGES, PS, device="cpu"), steps)
    _compare(ours, ref, 8, TOLERANCES["float32"])
    assert np.abs(ours).max() <= GEMMA_DIMS["final_logit_softcap"]


def test_deepseek_verify_forward_matches_jax_padding_rows_included():
    jax_cfg = jax_ds.DeepseekV2Config(**DEEPSEEK_DIMS, dtype=jnp.float32)
    cfg = ds.DeepseekV2Config(**DEEPSEEK_DIMS, dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jax_ds.init_deepseek_params(0, jax_cfg))
    rng = np.random.default_rng(1)
    for stack in ("layers_dense", "layers_moe"):
        tree[stack] = {n: rng.normal(1.0, 0.3, size=w.shape).astype(w.dtype) if n.endswith("_norm") else w
                       for n, w in tree[stack].items()}
    params = ds.fuse_deepseek_params(ds.deepseek_params_from_jax(tree, cfg, device="cpu"))
    steps = _steps(cfg.vocab_size, (5, 3))
    jax_caches = (jax_ds.init_deepseek_kv_cache(jax_cfg, NUM_PAGES, PS), jnp.zeros((0,), jnp.float32))
    ref = _run_jax(jax_ds.fuse_deepseek_params(jax.tree.map(jnp.asarray, tree)), jax_cfg, jax_ds.deepseek_prefill,
                   jax_ds.deepseek_verify_forward, jax_caches, steps)
    caches = (ds.init_deepseek_kv_cache(cfg, NUM_PAGES, PS, device="cpu"), torch.zeros((0,)))
    ours = _run_port(params, cfg, ds.deepseek_prefill, ds.deepseek_verify_forward, caches, steps)
    assert np.isfinite(ref).all()
    _compare(ours, ref, VERIFY_ROWS, DEEPSEEK_TOL)


@pytest.fixture(scope="module")
def mixtral():
    """(JAX params, JAX config, the port's params, config), fused."""
    jax_cfg = jax_moe.MoEConfig(llama=jax_llama.LlamaConfig(**MIXTRAL_DIMS, dtype=jnp.float32), **MIXTRAL_MOE)
    cfg = moe.MoEConfig(llama=llama.LlamaConfig(**MIXTRAL_DIMS, dtype=torch.float32), **MIXTRAL_MOE)
    tree = jax.tree.map(np.asarray, jax_moe.init_moe_params(0, jax_cfg))
    params = llama.fuse_llama_params(moe.moe_params_from_jax(tree, cfg, device="cpu"))
    return jax_llama.fuse_llama_params(jax.tree.map(jnp.asarray, tree)), jax_cfg, params, cfg


def _mixtral_run(mixtral, q_lens):
    jax_params, jax_cfg, params, cfg = mixtral
    steps = _steps(cfg.llama.vocab_size, q_lens)
    ref = _run_jax(jax_params, jax_cfg, jax_moe.mixtral_prefill, jax_moe.mixtral_verify_forward,
                   jax_moe.init_moe_kv_caches(jax_cfg, NUM_PAGES, PS), steps)
    ours = _run_port(params, cfg, moe.mixtral_prefill, moe.mixtral_verify_forward,
                     moe.init_moe_kv_caches(cfg, NUM_PAGES, PS, device="cpu"), steps)
    return ours, ref


def test_mixtral_verify_forward_matches_jax_without_padding_rows(mixtral):
    ours, ref = _mixtral_run(mixtral, (8, 8))
    _compare(ours, ref, VERIFY_ROWS, TOLERANCES["float32"])


def test_mixtral_verify_forward_padded_step_is_finite_where_jax_is_nan(mixtral):
    ours, ref = _mixtral_run(mixtral, (5, 3))
    assert np.isnan(ref).all()  # ROADMAP Queue 3: JAX's dispatch einsum spreads the padding rows' NaN
    assert ours.shape == ref.shape and np.isfinite(ours).all()
