# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Token sampling: greedy, temperature, top-k, top-p (counterpart of
``conch_tpu/serving/sampling.py``), drawn from an explicit ``torch.Generator``.

The JAX package draws with ``jax.random`` keys; the two give different
numbers from one seed, so only greedy outputs compare token for token.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration, the JAX package's fields.

    ``n > 1`` asks for parallel sampling: the engine prefills the prompt
    once and forks ``n`` sequences that share its full KV pages (the
    partial tail page is copied a sibling). ``repetition_penalty`` divides
    the positive logits of every prompt and output token and multiplies
    the others; ``logit_bias`` adds to the logits of its tokens;
    ``logprobs`` records each sampled token's log-probability under the
    rule-adjusted, unscaled logits. ``guided`` is a ``serving.guided.TokenFSM``
    (identity-hashed, so it can sit in this frozen dataclass): the engine
    masks every token it disallows; the request finishes with EOS once the
    match is complete and cannot extend.
    """

    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => disabled
    top_p: float = 1.0
    n: int = 1  # completions per prompt (the engine checks n >= 1)
    max_tokens: int = 64
    min_tokens: int = 0  # eos/stop tokens are suppressed until this many
    stop_token_ids: tuple[int, ...] = ()
    repetition_penalty: float = 1.0  # > 1 discourages tokens already seen
    logit_bias: tuple[tuple[int, float], ...] = ()  # (token, additive bias)
    logprobs: bool = False  # record each sampled token's log-probability
    guided: object | None = None  # serving.guided.TokenFSM


def top_k_top_p_filter(scaled: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """``scaled`` (batch, vocab) f32 with the tokens each row's filters drop
    set to -inf: those below the row's k-th largest value (``top_k`` 0
    keeps all), then those after the smallest prefix of the sorted row whose
    probability reaches ``top_p`` (1.0 keeps all). Ties with a threshold
    are kept.

    The top-p pass (the softmax of the sorted row and its cumulative sum)
    runs in f64: an f32 softmax of a 256000-token row sums to up to
    1.00003, so its cumulative sum reached ``top_p`` thousands of tokens
    early. A row with ``top_p`` of 1.0 or more keeps every token the top-k
    pass kept, as the f64 mass before the last token may round to 1.
    """
    vocab = scaled.shape[-1]
    # One descending sort serves the top-k threshold and the top-p cutoff.
    sorted_desc = scaled.sort(dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k, vocab)
    kth = sorted_desc.gather(-1, (k - 1).clamp(0, vocab - 1)[:, None])
    scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    sorted_desc = sorted_desc.masked_fill(sorted_desc < kth, float("-inf"))
    cumprobs = torch.softmax(sorted_desc.double(), dim=-1).cumsum(dim=-1)
    # Keep the smallest prefix with cumulative probability >= top_p.
    cutoff_idx = (cumprobs < top_p.double()[:, None]).sum(dim=-1).clamp(max=vocab - 1)
    cutoff_idx = torch.where(top_p >= 1.0, vocab - 1, cutoff_idx)
    cutoff_val = sorted_desc.gather(-1, cutoff_idx[:, None])
    return scaled.masked_fill(scaled < cutoff_val, float("-inf"))


def sample_tokens(
    logits: torch.Tensor,  # (batch, vocab) f32
    generator: torch.Generator,
    temperature: torch.Tensor,  # (batch,) 0 => greedy
    top_k: torch.Tensor | int = 0,
    top_p: torch.Tensor | float | None = None,
) -> torch.Tensor:
    """Sample next tokens (batch,) int32; temperature-0 rows take the argmax.

    ``top_k``/``top_p`` are per-row (scalars broadcast); 0 / 1.0 disable
    the filter for that row (``top_k_top_p_filter``).
    """
    batch = logits.shape[0]
    device = logits.device
    top_k = torch.as_tensor(top_k, dtype=torch.int64, device=device).expand(batch)
    top_p = torch.as_tensor(1.0 if top_p is None else top_p, dtype=torch.float32, device=device).expand(batch)
    temperature = temperature.to(device=device, dtype=torch.float32)
    greedy = logits.argmax(dim=-1)

    scaled = top_k_top_p_filter(logits / temperature.clamp_min(1e-6)[:, None], top_k, top_p)
    sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1, generator=generator)[:, 0]
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)
