# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""The port's top-k / top-p filter (``conch_tpu_torch.serving.sampling.
top_k_top_p_filter``) held to the exact kept set.

Rows are 4 x vocab f32 logits, N(0, 3^2) from a numpy seed, at Gemma-2's
vocabulary (256000) and Llama-3's (128256), temperature 1, no top-k. In a
row sorted by value, a token's exact mass before it is the f64 probability
of the tokens with larger values (tied tokens share it). The rule:

- a token whose mass before it is below ``top_p - 1e-6`` is kept;
- a token whose mass before it is above ``top_p + 1e-6`` is dropped;
- at ``top_p = 1.0`` every token is kept.

JAX's ``_sample_tokens`` is held to the same rule at 0.9 and 0.5 (its
filtered logits read where it draws); its f32 cumulative sum drops tokens
at 1.0 and 0.999, which the port does not copy. The f32 pass the port ran
before breaks the rule at 1.0, so the rule is seen to catch it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.serving import sampling as jax_sampling
from conch_tpu_torch.serving.sampling import sample_tokens, top_k_top_p_filter
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

VOCABS = [256000, 128256]
TOP_PS = [1.0, 0.999, 0.9, 0.5]
MARGIN = 1e-6
ROWS = 4


def _logits(vocab: int) -> np.ndarray:
    return (3.0 * np.random.default_rng(vocab).normal(size=(ROWS, vocab))).astype(np.float32)


def _mass_before(row: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The row's token order by descending value and each sorted token's
    exact mass before it (f64; ties share their group's)."""
    order = np.argsort(-row, kind="stable")
    v = row[order].astype(np.float64)
    p = np.exp(v - v[0])
    p /= p.sum()
    before = np.concatenate([[0.0], np.cumsum(p)[:-1]])
    first = np.searchsorted(-v, -v, side="left")  # each token's tie group's first position
    return order, before[first]


def _check_rule(filtered: np.ndarray, logits: np.ndarray, top_p: float) -> list[int]:
    """Assert the kept-set rule row by row; returns each row's kept count."""
    kept_counts = []
    for r in range(logits.shape[0]):
        order, before = _mass_before(logits[r])
        kept = np.isfinite(filtered[r][order])
        must_keep, must_drop = before < top_p - MARGIN, before > top_p + MARGIN
        assert kept[must_keep].all(), (r, top_p, int((~kept[must_keep]).sum()))
        assert not kept[must_drop].any(), (r, top_p, int(kept[must_drop].sum()))
        kept_counts.append(int(kept.sum()))
    return kept_counts


def _port_filter(logits: np.ndarray, top_p: float) -> np.ndarray:
    t = torch.from_numpy(logits)
    return top_k_top_p_filter(t, torch.zeros(ROWS, dtype=torch.int64), torch.full((ROWS,), top_p)).numpy()


@pytest.mark.parametrize("top_p", TOP_PS)
@pytest.mark.parametrize("vocab", VOCABS)
def test_top_p_filter_keeps_the_exact_set(vocab, top_p):
    logits = _logits(vocab)
    filtered = _port_filter(logits, top_p)
    kept = _check_rule(filtered, logits, top_p)
    if top_p == 1.0:
        assert kept == [vocab] * ROWS
    assert np.array_equal(filtered[np.isfinite(filtered)], logits[np.isfinite(filtered)])


@pytest.mark.parametrize("top_p", [0.9, 0.5])
@pytest.mark.parametrize("vocab", VOCABS)
def test_jax_filter_keeps_the_same_set(vocab, top_p, monkeypatch):
    """JAX's filter (the logits ``_sample_tokens`` hands to its draw) meets
    the rule on the same rows, and keeps the port's set."""
    logits = _logits(vocab)
    seen = []

    def categorical(key, scaled, axis=-1):
        seen.append(np.asarray(scaled))
        return jnp.zeros(scaled.shape[0], jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    with jax.disable_jit():
        jax_sampling.sample_tokens(jnp.asarray(logits), jax.random.PRNGKey(0), jnp.ones(ROWS), top_p=top_p)
    _check_rule(seen[0], logits, top_p)
    assert np.array_equal(np.isfinite(seen[0]), np.isfinite(_port_filter(logits, top_p)))


def _f32_filter(logits: np.ndarray, top_p: float) -> np.ndarray:
    """The top-p pass as the port ran it before: softmax and cumulative sum in f32."""
    s = torch.from_numpy(logits)
    sorted_desc = s.sort(dim=-1, descending=True).values
    cumprobs = torch.softmax(sorted_desc, dim=-1).cumsum(dim=-1)
    cutoff_idx = (cumprobs < top_p).sum(dim=-1).clamp(max=s.shape[-1] - 1)
    cutoff_val = sorted_desc.gather(-1, cutoff_idx[:, None])
    return s.masked_fill(s < cutoff_val, float("-inf")).numpy()


@pytest.mark.parametrize("vocab", VOCABS)
def test_f32_top_p_pass_breaks_the_rule(vocab):
    logits = _logits(vocab)
    with pytest.raises(AssertionError):
        _check_rule(_f32_filter(logits, 1.0), logits, 1.0)


def test_sample_tokens_draws_from_the_filtered_set():
    """Seeded draws at top_p 0.5 over a 128256-token row land in the kept
    set, and greedy rows take the argmax."""
    logits = _logits(128256)
    kept = np.isfinite(_port_filter(logits, 0.5))
    temperature = torch.tensor([1.0, 1.0, 0.0, 1.0])
    for seed in range(4):
        gen = torch.Generator().manual_seed(seed)
        toks = sample_tokens(torch.from_numpy(logits), gen, temperature, top_p=0.5).numpy()
        assert toks.dtype == np.int32
        assert all(kept[r, toks[r]] for r in range(ROWS))
        assert toks[2] == logits[2].argmax()
