# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""The models over int8 and fp8 (e4m3) KV caches, step by step: the port's
prefill and decode steps against the JAX package's, for Llama, Gemma-2 and
DeepSeek-V2 at tiny sizes.

JAX params are carried across (``params_from_jax`` and its Gemma and
DeepSeek counterparts) and fused on both sides. Each family runs one
prefill of two fresh prompts (40 and 21 tokens, padding rows and
zero-length padding sequences) and two decode steps with idle rows, over
caches of ``int8`` or ``float8_e4m3fn`` made by each side's cache init at
the model's ``kv_cache_scale`` (1/16), so the store quantizes and the
attention kernels dequantize (``_kv_cache_quant``; DeepSeek's latent cache
through ``reshape_and_cache_mla`` and K11's ``kv_scale``). f32
activations, as the JAX package's step tests run. Tolerance on the logits:
2e-3, absolute and relative (tests/paged_attention_test.py:21), 1e-4 for
DeepSeek's (its f32 step test's). The caches must agree byte for byte but
for codes that a 1-ulp difference of the two sides' f32 keys puts across
a rounding boundary: at most one code step, on at most 0.1% of the
entries. One exception, e4m3 K/V caches past layer 0: the JAX attention
kernels round q and p to bf16 over an e4m3 cache (``kv_mxu_dtype``), the
port's K3/K7 keep f32, so layer 0's attention output differs by about
2^-9 relative, and the next layer's keys and values cross e4m3 rounding
boundaries (3 mantissa bits) on about 1.1% of the entries (Llama here);
rounding q and p to bf16 in a copy of the port's plain attention brings
that to 0.004% and the logits to 1.7e-6. So there the caches are held to
at most 2% of codes differing, beside the logits at 2e-3.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import conch_tpu.models.deepseek as jax_ds
import conch_tpu.models.gemma as jax_gemma
import conch_tpu.models.llama as jax_llama
import conch_tpu_torch.models.deepseek as ds
import conch_tpu_torch.models.gemma as gemma
import conch_tpu_torch.models.llama as llama
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

PS, NUM_PAGES, ROWS, BATCH, MAX_PAGES = 16, 12, 64, 4, 5
PAGES = [[3, 7, 1, 9], [0, 5]]  # page 0 is a real page
CACHES = {"int8": (jnp.int8, torch.int8), "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
LLAMA_DIMS = {
    "vocab_size": 128, "hidden_size": 128, "intermediate_size": 256, "num_layers": 2, "num_heads": 4,
    "num_kv_heads": 1, "head_dim": 128,
}
GEMMA_DIMS = {
    **LLAMA_DIMS, "num_kv_heads": 2, "max_position": 512, "attn_logit_softcap": 50.0, "final_logit_softcap": 30.0,
    "gemma2": True, "sliding_window": 24, "query_pre_attn_scalar": 64.0,
}
DEEPSEEK_DIMS = {
    "vocab_size": 128, "hidden_size": 64, "num_layers": 2, "num_heads": 4, "kv_lora_rank": 32,
    "qk_rope_head_dim": 16, "qk_nope_head_dim": 32, "v_head_dim": 32, "n_routed_experts": 4,
    "n_shared_experts": 1, "num_experts_per_tok": 2, "moe_intermediate_size": 32, "intermediate_size": 64,
    "first_k_dense_replace": 1,
}


def _steps(vocab):
    """Host-side inputs of each step, as the engine builds them."""
    rng = np.random.default_rng(5)
    bt = np.zeros((BATCH, MAX_PAGES), np.int32)
    for b, pages in enumerate(PAGES):
        bt[b, : len(pages)] = pages

    def slot(b, pos):
        return PAGES[b][pos // PS] * PS + pos % PS

    tokens = np.zeros(ROWS, np.int32)
    positions = np.zeros(ROWS, np.int32)
    slots = np.full(ROWS, -1, np.int32)
    tokens[:61] = rng.integers(0, vocab, 61)
    positions[:61] = np.concatenate([np.arange(40), np.arange(21)])
    slots[:61] = [slot(0, p) for p in range(40)] + [slot(1, p) for p in range(21)]
    cu = np.array([0, 40, 61, 61, 61], np.int32)
    seq_lens = np.array([40, 21, 0, 0], np.int32)
    steps = [("prefill", tokens, positions, cu, seq_lens, bt, slots)]
    for pos in ((40, 21), (41, 22)):  # rows 0, 1 active; rows 2, 3 idle
        dec_tokens = np.zeros(BATCH, np.int32)
        dec_tokens[:2] = rng.integers(0, vocab, 2)
        steps.append((
            "decode", dec_tokens, np.array([pos[0], pos[1], 0, 0], np.int32),
            np.array([pos[0] + 1, pos[1] + 1, 0, 0], np.int32), bt,
            np.array([slot(0, pos[0]), slot(1, pos[1]), -1, -1], np.int32),
        ))
    return steps


def _run_jax(params, cfg, prefill_fn, decode_fn, caches):
    prefill = jax.jit(lambda p, *a: prefill_fn(p, cfg, *a[:3], ROWS, *a[3:]))
    decode = jax.jit(lambda p, *a: decode_fn(p, cfg, *a))
    kc, vc = caches
    logits = []
    for kind, *arrays in _steps(cfg.vocab_size):
        fn = prefill if kind == "prefill" else decode
        out, kc, vc = fn(params, *map(jnp.asarray, arrays), kc, vc)
        logits.append(np.asarray(out))
    return logits, [np.asarray(kc), np.asarray(vc)]


def _run_port(params, cfg, prefill_fn, decode_fn, caches):
    kc, vc = caches
    logits = []
    for kind, *arrays in _steps(cfg.vocab_size):
        t = [torch.from_numpy(a) for a in arrays]
        if kind == "prefill":
            out, _, _ = prefill_fn(params, cfg, *t[:3], ROWS, *t[3:], kc, vc)
        else:
            out, _, _ = decode_fn(params, cfg, *t, kc, vc)
        logits.append(out.numpy())
    return logits, [kc, vc]


def _codes(x) -> np.ndarray:
    """A quantized cache's codes as int32 (e4m3: its ordinal among the
    positive codes, signed, so one code step is one unit)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn) if x.dtype == torch.float8_e4m3fn else x.numpy()
    x = np.asarray(x)
    if x.dtype == ml_dtypes.float8_e4m3fn:
        bits = x.view(np.uint8).astype(np.int32)
        return np.where(bits & 0x80, -(bits & 0x7F), bits & 0x7F)
    return x.astype(np.int32)


def _compare(port, ref, tol, rounded_past_layer0=False):
    """Logits at ``tol``; each cache layer's codes within one step on at
    most 0.1% of entries, or, past layer 0 of a cache that the JAX kernels
    read through bf16 (``rounded_past_layer0``), differing on at most 2%."""
    (logits, caches), (jax_logits, jax_caches) = port, ref
    for i, (ours, want) in enumerate(zip(logits, jax_logits)):
        assert ours.shape == want.shape == (BATCH, want.shape[1]) and np.isfinite(ours).all()
        np.testing.assert_allclose(ours, want, atol=tol, rtol=tol, err_msg=f"step {i}")
    for ours, want in zip(caches, jax_caches):
        if ours.numel() == 0:
            continue
        a, b = _codes(ours), _codes(want)
        assert np.abs(a).max() > 0 and a.shape == b.shape
        for layer, diff in enumerate(np.abs(a - b)):
            share = (diff > 0).mean()
            if rounded_past_layer0 and layer > 0:
                assert share <= 2e-2, (layer, share)
            else:
                assert diff.max() <= 1 and share <= 1e-3, (layer, diff.max(), share)


@pytest.mark.parametrize("cache", list(CACHES))
def test_llama_steps_over_quantized_caches_match_jax(cache):
    jd, td = CACHES[cache]
    jax_cfg = jax_llama.LlamaConfig(**LLAMA_DIMS, dtype=jnp.float32)
    cfg = llama.LlamaConfig(**LLAMA_DIMS, dtype=torch.float32)
    assert cfg.kv_cache_scale == jax_cfg.kv_cache_scale == 1 / 16
    tree = jax_llama.init_llama_params(0, jax_cfg)
    params = llama.fuse_llama_params(llama.params_from_jax(jax.tree.map(np.asarray, tree), cfg, device="cpu"))
    ref = _run_jax(jax_llama.fuse_llama_params(tree), jax_cfg, jax_llama.llama_prefill, jax_llama.llama_decode_step,
                   jax_llama.init_kv_caches(jax_cfg, NUM_PAGES, PS, cache_dtype=jd))
    port = _run_port(params, cfg, llama.llama_prefill, llama.llama_decode_step,
                     llama.init_kv_caches(cfg, NUM_PAGES, PS, cache_dtype=td, device="cpu"))
    assert port[1][0].dtype == td
    _compare(port, ref, 2e-3, rounded_past_layer0=cache == "fp8")


@pytest.mark.parametrize("cache", list(CACHES))
def test_gemma_steps_over_quantized_caches_match_jax(cache):
    """Gemma-2: softcaps 50 and 30, layer 0 local with a 24-token window
    (the 40-token prompt crosses it), layer 1 global; random norm weights."""
    jd, td = CACHES[cache]
    jax_cfg = jax_gemma.GemmaConfig(**GEMMA_DIMS, dtype=jnp.float32)
    cfg = gemma.GemmaConfig(**GEMMA_DIMS, dtype=torch.float32)
    assert cfg.kv_cache_scale == jax_cfg.kv_cache_scale == 1 / 16
    tree = jax.tree.map(np.asarray, jax_gemma.init_gemma_params(0, jax_cfg))
    rng = np.random.default_rng(1)
    layers = {n: (0.3 * rng.normal(size=w.shape)).astype(w.dtype) if n.endswith("_norm") else w
              for n, w in tree["layers"].items()}
    tree = {**tree, "layers": layers}
    params = llama.fuse_llama_params(gemma.gemma_params_from_jax(tree, cfg, device="cpu"))
    ref = _run_jax(jax_llama.fuse_llama_params(jax.tree.map(jnp.asarray, tree)), jax_cfg, jax_gemma.gemma_prefill,
                   jax_gemma.gemma_decode_step, jax_gemma.init_gemma_kv_caches(jax_cfg, NUM_PAGES, PS, cache_dtype=jd))
    port = _run_port(params, cfg, gemma.gemma_prefill, gemma.gemma_decode_step,
                     gemma.init_gemma_kv_caches(cfg, NUM_PAGES, PS, cache_dtype=td, device="cpu"))
    assert port[1][0].dtype == td
    _compare(port, ref, 2e-3, rounded_past_layer0=cache == "fp8")


@pytest.mark.parametrize("cache", list(CACHES))
def test_deepseek_steps_over_quantized_caches_match_jax(cache):
    """DeepSeek-V2 (one dense, one MoE layer) over an int8 or e4m3 latent
    cache: stored round(x / kv_cache_scale), saturating, read by K11 with
    kv_scale folded in."""
    jd, td = CACHES[cache]
    jax_cfg = jax_ds.DeepseekV2Config(**DEEPSEEK_DIMS, dtype=jnp.float32)
    cfg = ds.DeepseekV2Config(**DEEPSEEK_DIMS, dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jax_ds.init_deepseek_params(0, jax_cfg))
    params = ds.fuse_deepseek_params(ds.deepseek_params_from_jax(tree, cfg, device="cpu"))
    jax_caches = (jax_ds.init_deepseek_kv_cache(jax_cfg, NUM_PAGES, PS, dtype=jd), jnp.zeros((0,), jnp.float32))
    ref = _run_jax(jax_ds.fuse_deepseek_params(jax.tree.map(jnp.asarray, tree)), jax_cfg, jax_ds.deepseek_prefill,
                   jax_ds.deepseek_decode_step, jax_caches)
    caches = (ds.init_deepseek_kv_cache(cfg, NUM_PAGES, PS, dtype=td, device="cpu"), torch.zeros((0,)))
    port = _run_port(params, cfg, ds.deepseek_prefill, ds.deepseek_decode_step, caches)
    assert port[1][0].dtype == td
    _compare(port, ref, 1e-4)
