# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Port int8 and fp8 (e4m3) KV caches against the JAX package: the store
(K2's module), paged and varlen attention (K3's and K7's) and MLA (K11's).

The same numpy inputs go through the JAX ops (the Pallas kernels in
interpret mode) and the port's ops on ``device="cpu"``:

- the dequantization scales on bf16-free f32 caches (``kv_cache_dtype``
  "auto"), which the port once dropped: f32, batch 2, QH 4 / KH 1 / D 128,
  page 16, seq_lens [37, 50], k_scale 2, v_scale 3, and for varlen 5
  causal query rows (cu_seqlens_q [0, 2, 5]) and q_scale 1.5, at 2e-3
  (tests/paged_attention_test.py:21);
- the quantized stores, stacked (K2) and per layer, byte for byte, with
  values past the int8 and e4m3 ranges and exact halves (round half to
  even);
- K3 and K7 over int8 and e4m3 caches with k_scale != v_scale (the scales
  of tests/paged_attention_test.py:95-99 and
  tests/varlen_attention_test.py:148-150; for int8 divided by 32, so the
  codes use the int8 range), bf16 queries at 3e-2 (also
  tests/int8_kv_cache_test.py:58), f32 queries over int8 at 2e-3, f16
  queries over int8 at the attention tests' f16 tolerances (K3 5e-3, K7
  2e-3) and over e4m3 at 3e-2 (the JAX kernels compute there in bf16);
  the stores from f16 keys byte for byte too; and a
  softcap-plus-window case at Gemma-2's head size 256 (against the JAX
  golden reference, to keep the file's interpret-mode compiles few);
- K11 over int8 and e4m3 latent caches at tests/mla_attention_test.py:83's
  2e-4, the caches written by both sides' quantizing store and compared
  byte for byte first.

The quantized caches are built through the store (``quantize_store``),
which clips: the JAX side reads e4m3 through ``cast_kv``, which maps the
NaN codes 0x7F / 0xFF to a finite value where the card reads NaN, so no
input holds them. Idle rows sit last, as ``test_torch_paged_attention.py``
explains; the JAX varlen kernel leaves its padding rows uninitialized
(NaN in interpret mode), so varlen outputs are compared on the real rows
and the port's padding rows are held to zeros, as in
``test_torch_varlen_attention.py``.
"""

import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from conch_tpu.ops.attention import mla_attention as jax_mla
from conch_tpu.ops.attention import paged_attention as jax_paged
from conch_tpu.ops.attention import varlen_attention as jax_varlen
from conch_tpu.ops.cache import reshape_and_cache as jax_write
from conch_tpu.ops.cache import reshape_and_cache_mla as jax_cache_mla
from conch_tpu.ops.cache import reshape_and_cache_stacked as jax_write_stacked
from conch_tpu.reference.attention.attention import paged_attention as jax_paged_ref
from conch_tpu.reference.attention.attention import varlen_attention as jax_varlen_ref
from conch_tpu_torch.kernels.cache.reshape_and_cache import quantize_store
from conch_tpu_torch.ops.attention import mla_attention, paged_attention, varlen_attention
from conch_tpu_torch.ops.cache import reshape_and_cache, reshape_and_cache_mla, reshape_and_cache_stacked
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

PS = 16
CACHE_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
KV_STRINGS = {"int8": "int8", "fp8": "fp8_e4m3"}
TOLERANCES = {"float32": 2e-3, "bfloat16": 3e-2}
# f16 queries over int8: the JAX attention tests' f16 tolerances, K3's
# (paged, 5e-3) and K7's (varlen, 2e-3). Over e4m3 the JAX kernels compute
# in bf16 whatever the queries' dtype (``kv_mxu_dtype``: q and p rounded to
# bf16), so there the bf16 tolerance holds.
F16_TOLERANCES = {"paged": 5e-3, "varlen": 2e-3}


def tolerance(op: str, cache: str, dtype: str) -> float:
    if dtype == "float16" and cache == "int8":
        return F16_TOLERANCES[op]
    return TOLERANCES["bfloat16" if dtype == "float16" else dtype]
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
# (k_scale, v_scale) of the JAX tests' fp8 cases; int8 divides them by 32.
PAGED_SCALES, VARLEN_SCALES = (1.5, 0.75), (1.25, 0.5)


def to_jax(t: torch.Tensor):
    """A torch tensor as a JAX array of the same dtype and bytes."""
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn))
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def as_bytes(x) -> np.ndarray:
    """The raw bytes of a quantized torch or JAX cache."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy() if x.dtype == torch.float8_e4m3fn else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype == ml_dtypes.float8_e4m3fn else x


def scales_for(cache: str, scales: tuple[float, float]) -> tuple[float, float]:
    return scales if cache == "fp8" else (scales[0] / 32, scales[1] / 32)


def block_table(rng, seq_lens, max_pages):
    """Distinct shuffled pages per sequence, entries past them 0; the pool size."""
    num_pages = sum(-(-n // PS) for n in seq_lens) + 2
    perm = iter(rng.permutation(np.arange(1, num_pages)).tolist())
    bt = np.zeros((len(seq_lens), max_pages), np.int32)
    for b, n in enumerate(seq_lens):
        for p in range(-(-n // PS)):
            bt[b, p] = next(perm)
    return bt, num_pages


def quantized_pool(rng, shape, scale, cache):
    """A (L, P, KH, ps, D) pool of N(0, 1) values through the quantizing store."""
    return quantize_store(torch.from_numpy(rng.normal(size=shape).astype(np.float32)), scale, CACHE_DTYPES[cache])


# -- the dropped scales ------------------------------------------------------


@pytest.mark.parametrize("op", ["paged", "varlen"])
def test_scales_apply_on_auto_caches(op):
    """``kv_cache_dtype="auto"`` with k_scale 2 and v_scale 3 (q_scale 1.5 on
    varlen): the JAX ops apply them; the port once gave the unscaled
    output, off by 4.06 (paged) and 6.64 (varlen) on these inputs."""
    rng = np.random.default_rng(61)
    kc = rng.normal(size=(8, 1, PS, 128)).astype(np.float32)
    vc = rng.normal(size=(8, 1, PS, 128)).astype(np.float32)
    bt = np.array([[0, 1, 2, 0], [3, 4, 5, 6]], np.int32)
    sl = np.array([37, 50], np.int32)
    ks, vs, qs = np.array([2.0], np.float32), np.array([3.0], np.float32), np.array([1.5], np.float32)
    if op == "paged":
        q = rng.normal(size=(2, 4, 128)).astype(np.float32)
        ref = jax_paged(*map(jnp.asarray, (q, kc, vc, bt, sl)), k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        out = paged_attention(*map(torch.from_numpy, (q, kc, vc, bt, sl)), k_scale=torch.from_numpy(ks),
                              v_scale=torch.from_numpy(vs))
        plain = paged_attention(*map(torch.from_numpy, (q, kc, vc, bt, sl)))
    else:
        q = rng.normal(size=(5, 4, 128)).astype(np.float32)
        cu = np.array([0, 2, 5], np.int32)
        ref = jax_varlen(*map(jnp.asarray, (q, kc, vc, cu)), 3, jnp.asarray(sl), 50, jnp.asarray(bt), causal=True,
                         q_scale=jnp.asarray(qs), k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        args = (*map(torch.from_numpy, (q, kc, vc, cu)), 3, torch.from_numpy(sl), 50, torch.from_numpy(bt))
        out = varlen_attention(*args, causal=True, q_scale=torch.from_numpy(qs), k_scale=torch.from_numpy(ks),
                               v_scale=torch.from_numpy(vs))
        plain = varlen_attention(*args, causal=True)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-3, rtol=2e-3)
    assert np.abs(plain.numpy() - ref).max() > 1.0  # the scales matter on these inputs


# -- the quantizing store ----------------------------------------------------


def _store_inputs(rng, t, kh, d):
    """Keys and values of N(0, 2) with values past either range and exact
    halves of a code at scale 1/16 (x / scale = 2.5, 3.5, -0.5)."""
    k = (rng.normal(size=(t, kh, d)) * 2).astype(np.float32)
    v = (rng.normal(size=(t, kh, d)) * 2).astype(np.float32)
    k[0, 0, :6] = [100.0, -100.0, 2.5 / 16, 3.5 / 16, -0.5 / 16, 27.0]
    v[1, 0, :4] = [-30.0, 30.0, 1.5 / 16, -2.5 / 16]
    return k, v


@pytest.mark.parametrize("kind", ["stacked", "per_layer"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("cache", ["int8", "fp8"])
def test_quantized_store_matches_jax(cache, dtype, kind):
    """Decode-shaped write (one token per 8-entry window, as the JAX stacked
    kernel takes it), an idle slot, page 0 in use; the whole pool byte for
    byte."""
    rng = np.random.default_rng(62)
    layers, pages, kh, d = 3, 6, 2, 128
    k, v = _store_inputs(rng, 5, kh, d)
    slots = np.array([0 * PS + 5, 3 * PS + 15, -1, 4 * PS + 8, 1 * PS + 1], np.int32)
    cdt, jd, td = CACHE_DTYPES[cache], JAX_DTYPES[dtype], TORCH_DTYPES[dtype]
    kc0 = quantized_pool(rng, (layers, pages, kh, PS, d), 1 / 16, cache)
    vc0 = quantized_pool(rng, (layers, pages, kh, PS, d), 1 / 16, cache)
    scale = np.array([1 / 16], np.float32)
    quant = {"kv_cache_dtype": KV_STRINGS[cache], "k_scale": jnp.asarray(scale), "v_scale": jnp.asarray(scale)}
    tk, tv = torch.from_numpy(k).to(td), torch.from_numpy(v).to(td)
    kc, vc = kc0.clone(), vc0.clone()
    tquant = {**quant, "k_scale": torch.from_numpy(scale), "v_scale": torch.from_numpy(scale)}
    if kind == "stacked":
        jk, jv = jax_write_stacked(to_jax(tk), to_jax(tv), to_jax(kc0), to_jax(vc0), jnp.asarray(slots),
                                   jnp.asarray(2, jnp.int32), **quant)
        reshape_and_cache_stacked(tk, tv, kc, vc, torch.from_numpy(slots), 2, **tquant)
    else:
        jk, jv = jax_write(to_jax(tk), to_jax(tv), to_jax(kc0[2]), to_jax(vc0[2]), jnp.asarray(slots), **quant)
        reshape_and_cache(tk, tv, kc[2], vc[2], torch.from_numpy(slots), **tquant)
        kc, vc = kc[2], vc[2]
    assert kc.dtype == vc.dtype == cdt
    np.testing.assert_array_equal(as_bytes(kc), as_bytes(jk))
    np.testing.assert_array_equal(as_bytes(vc), as_bytes(jv))
    row = kc[0, 0, 5, :6] if kind == "per_layer" else kc[2, 0, 0, 5, :6]
    # 27 * 16 = 432 lies halfway between e4m3's 416 and 448: the even one.
    expect = [127, -128, 2, 4, 0, 127] if cache == "int8" else [448.0, -448.0, 2.5, 3.5, -0.5, 448.0]
    assert row.float().tolist() == expect


# -- K3 and K7 over quantized caches -----------------------------------------


def _paged_case(rng, cache, dtype, seq_lens, qh, kh, d, gain=1.0, layers=2):
    bt, num_pages = block_table(rng, seq_lens, 16)
    ks, vs = scales_for(cache, PAGED_SCALES)
    kc = quantized_pool(rng, (layers, num_pages, kh, PS, d), ks, cache)
    vc = quantized_pool(rng, (layers, num_pages, kh, PS, d), vs, cache)
    q = torch.from_numpy((rng.normal(size=(len(seq_lens), qh, d)) * gain).astype(np.float32)).to(TORCH_DTYPES[dtype])
    return q, kc, vc, torch.from_numpy(bt), torch.tensor(seq_lens, dtype=torch.int32), (ks, vs)


# f32 queries over int8 (exact on both sides) at 2e-3; bf16 queries over
# e4m3 (the JAX kernel rounds q and p to bf16 there) at 3e-2. Each case
# costs a JAX interpret-mode compile of about 12 s; bf16 over int8 is held
# in the softcap case below and in tests/test_torch_kv_quant_models.py.
# f16 queries over both (``F16_TOLERANCES``).
CASES = [("int8", "float32"), ("fp8", "bfloat16"), ("int8", "float16"), ("fp8", "float16")]


@pytest.mark.parametrize("cache,dtype", CASES)
def test_paged_attention_quantized_matches_jax(cache, dtype):
    """QH 8 / KH 2 / D 128, a 2-layer pool read at layer 1, an idle row last."""
    q, kc, vc, bt, sl, (ks, vs) = _paged_case(np.random.default_rng(63), cache, dtype, [40, 77, 17, 0], 8, 2, 128)
    kw = {"kv_cache_dtype": KV_STRINGS[cache], "layer_idx": 1}
    ref = jax_paged(to_jax(q), to_jax(kc), to_jax(vc), to_jax(bt), to_jax(sl), k_scale=jnp.asarray([ks], jnp.float32),
                    v_scale=jnp.asarray([vs], jnp.float32), **{**kw, "layer_idx": jnp.asarray(1, jnp.int32)})
    out = paged_attention(q, kc, vc, bt, sl, k_scale=torch.tensor([ks]), v_scale=torch.tensor([vs]), **kw)
    assert out.dtype == q.dtype and torch.isfinite(out).all() and not out[-1].any()
    tol = tolerance("paged", cache, dtype)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol)
    swapped = paged_attention(q, kc, vc, bt, sl, k_scale=torch.tensor([vs]), v_scale=torch.tensor([ks]), **kw)
    assert (swapped.float() - out.float()).abs().max() > 10 * tol  # a k/v scale swap shows


def _varlen_case(rng, cache, dtype, q_lens, seq_lens, rows, qh, kh, d, gain=1.0):
    bt, num_pages = block_table(rng, seq_lens, 16)
    ks, vs = scales_for(cache, VARLEN_SCALES)
    kc = quantized_pool(rng, (2, num_pages, kh, PS, d), ks, cache)
    vc = quantized_pool(rng, (2, num_pages, kh, PS, d), vs, cache)
    q = torch.from_numpy((rng.normal(size=(rows, qh, d)) * gain).astype(np.float32)).to(TORCH_DTYPES[dtype])
    cu = torch.from_numpy(np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32))
    return q, kc, vc, cu, torch.tensor(seq_lens, dtype=torch.int32), torch.from_numpy(bt), (ks, vs)


@pytest.mark.parametrize("cache,dtype", CASES)
def test_varlen_attention_quantized_matches_jax(cache, dtype):
    """A chunked continuation, a fresh prompt and a mixed-in decode row,
    causal, then padding rows; q_scale 1.25."""
    q_lens, seq_lens = [16, 24, 1], [48, 24, 40]
    q, kc, vc, cu, sl, bt, (ks, vs) = _varlen_case(np.random.default_rng(64), cache, dtype, q_lens, seq_lens, 48, 8,
                                                   2, 128)
    scales = {"q_scale": 1.25, "k_scale": ks, "v_scale": vs}
    ref = jax_varlen(to_jax(q), to_jax(kc), to_jax(vc), to_jax(cu), 24, to_jax(sl), 48, to_jax(bt), causal=True,
                     kv_cache_dtype=KV_STRINGS[cache], layer_idx=jnp.asarray(1, jnp.int32),
                     **{n: jnp.asarray([s], jnp.float32) for n, s in scales.items()})
    out = varlen_attention(q, kc, vc, cu, 24, sl, 48, bt, causal=True, kv_cache_dtype=KV_STRINGS[cache], layer_idx=1,
                           **{n: torch.tensor([s]) for n, s in scales.items()})
    total = int(cu[-1])
    assert out.dtype == q.dtype and torch.isfinite(out).all() and not out[total:].any()
    tol = tolerance("varlen", cache, dtype)
    np.testing.assert_allclose(out[:total].float().numpy(), np.asarray(ref, np.float32)[:total], atol=tol, rtol=tol)


@pytest.mark.parametrize("cache", ["int8", "fp8"])
def test_softcap_window_quantized_matches_jax(cache):
    """Gemma-2's head size 256 with softcap 50 and a 24-token window, bf16
    queries scaled so the logits reach the cap: decode (lengths past the
    window, an idle row last) and a causal prefill step, against the JAX
    package's golden reference (``conch_tpu.reference.attention``, as its
    own softcap and window tests hold the kernels; the Pallas kernels'
    quantized branches are held above)."""
    rng = np.random.default_rng(65)
    common = {"scale": 1 / 16, "softcap": 50.0, "window_size": 24}
    q, kc, vc, bt, sl, (ks, vs) = _paged_case(rng, cache, "bfloat16", [40, 17, 0], 4, 2, 256, gain=12.0, layers=1)
    # The golden reference takes no idle row; the port's is held to zeros.
    ref = jax_paged_ref(to_jax(q[:-1]), to_jax(kc[0]), to_jax(vc[0]), bt[:-1].numpy(), sl[:-1].numpy(), k_scale=ks,
                        v_scale=vs, **common)
    out = paged_attention(q, kc[0], vc[0], bt, sl, kv_cache_dtype=KV_STRINGS[cache], k_scale=torch.tensor([ks]),
                          v_scale=torch.tensor([vs]), **common)
    assert torch.isfinite(out).all() and not out[-1].any()
    np.testing.assert_allclose(out[:-1].float().numpy(), ref, atol=3e-2, rtol=3e-2)

    q, kc, vc, cu, sl, bt, (ks, vs) = _varlen_case(rng, cache, "bfloat16", [12, 5], [40, 5], 24, 4, 2, 256, gain=12.0)
    ref = jax_varlen_ref(to_jax(q), to_jax(kc[1]), to_jax(vc[1]), cu.numpy(), sl.numpy(), bt.numpy(), causal=True,
                         k_scale=ks, v_scale=vs, **common)
    out = varlen_attention(q, kc[1], vc[1], cu, 12, sl, 40, bt, causal=True, kv_cache_dtype=KV_STRINGS[cache],
                           k_scale=torch.tensor([ks]), v_scale=torch.tensor([vs]), **common)
    assert torch.isfinite(out).all() and not out[17:].any()
    np.testing.assert_allclose(out[:17].float().numpy(), ref, atol=3e-2, rtol=3e-2)


def test_kv_cache_dtype_must_name_the_caches():
    rng = np.random.default_rng(66)
    q, kc, vc, bt, sl, _ = _paged_case(rng, "int8", "float32", [5, 20], 4, 1, 128)
    with pytest.raises(ValueError, match="fp8"):
        paged_attention(q, kc, vc, bt, sl, kv_cache_dtype="fp8", layer_idx=0)
    with pytest.raises(ValueError, match="Unsupported"):
        paged_attention(q, kc, vc, bt, sl, kv_cache_dtype="int4", layer_idx=0)
    k = torch.zeros(2, 1, 128)
    with pytest.raises(ValueError, match="int8"):
        reshape_and_cache_stacked(k, k, kc.float(), vc.float(), torch.zeros(2, dtype=torch.int32), 0,
                                  kv_cache_dtype="int8")


# -- K11 over quantized latent caches ---------------------------------------

LATENT, ROPE, PACKED, HEADS = 128, 64, 256, 8
MLA_CASES = {"decode": ([1, 1, 1], [33, 200, 7], 4), "prefill": ([40, 9, 1], [40, 121, 64], 51)}


@pytest.mark.parametrize("case", list(MLA_CASES))
@pytest.mark.parametrize("cache", ["int8", "fp8"])
def test_mla_attention_quantized_matches_jax(cache, case):
    """8 heads, packed 256 (latent 128 + rope 64 + 64 pad), f32 queries,
    kv_scale 1/16 for int8 and 1/2 for e4m3; padding rows after a real last
    sequence. The stores agree byte for byte, the outputs at 2e-4."""
    q_lens, seq_lens, rows = MLA_CASES[case]
    rng = np.random.default_rng(67)
    bt, num_pages = block_table(rng, seq_lens, 16)
    kv_scale = 1 / 16 if cache == "int8" else 0.5
    kv = (rng.normal(size=(sum(seq_lens), PACKED)) * 2).astype(np.float32)
    kv[:, LATENT + ROPE :] = 0.0
    slots = np.array([bt[b, p // PS] * PS + p % PS for b, n in enumerate(seq_lens) for p in range(n)], np.int32)
    cdt = CACHE_DTYPES[cache]
    jax_cache = jax_cache_mla(jnp.asarray(kv), to_jax(torch.zeros((num_pages, PS, PACKED), dtype=cdt)),
                              jnp.asarray(slots), scale=kv_scale)
    cache_t = torch.zeros((num_pages, PS, PACKED), dtype=cdt)
    reshape_and_cache_mla(torch.from_numpy(kv), cache_t, torch.from_numpy(slots), scale=kv_scale)
    np.testing.assert_array_equal(as_bytes(cache_t), as_bytes(jax_cache))
    q = rng.normal(size=(rows, HEADS, PACKED)).astype(np.float32)
    q[..., LATENT + ROPE :] = 0.0
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    kw = {"scale": 1 / math.sqrt(192), "latent": LATENT, "kv_scale": kv_scale}
    ref = jax_mla(jnp.asarray(q), jax_cache, jnp.asarray(cu), max(q_lens), jnp.asarray(seq_lens, jnp.int32),
                  jnp.asarray(bt), **kw)
    out = mla_attention(torch.from_numpy(q), cache_t, torch.from_numpy(cu), max(q_lens),
                        torch.tensor(seq_lens, dtype=torch.int32), torch.from_numpy(bt), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)
