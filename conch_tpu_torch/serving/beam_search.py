# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Beam search over the paged KV engine, an offline API (counterpart of
``conch_tpu/serving/beam_search.py``).

Synchronized step-level beam search with shared pages: beams that continue
one parent share its full KV pages by refcount (decode never rewrites a
full page), and only the partial tail page is copied on the device for
each extra child, the forking that parallel sampling uses, applied every
step. The prompt is prefilled once.

The candidate rule is the JAX package's: the log-softmax of each live
beam's logits in f32, then f64; each live beam proposes its top
``2 * beam_width`` tokens in a stable descending order (ties by token id);
candidates rank by cumulative logprob; scanning best-first, an EOS
candidate retires its hypothesis (EOS included in its tokens) and the
others become live beams until ``beam_width`` exist. The score is
``cum_logprob / len(tokens) ** length_penalty``; the top ``beam_width``
hypotheses return best-first. The order comes from one stable
``torch.sort`` of the f64 rows on the logits' device, which gives
``np.argsort(-row, kind="stable")``'s order, ties included.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from conch_tpu_torch.serving.engine import _bucket


@dataclass
class BeamHypothesis:
    tokens: list[int]
    score: float


@dataclass
class _Beam:
    tokens: list[int] = field(default_factory=list)  # generated tokens
    pages: list[int] = field(default_factory=list)
    cum: float = 0.0


def _ranked(logits: torch.Tensor, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Each row's ``k`` best tokens and their logprobs (f64), best first:
    the f32 log-softmax widened to f64, sorted descending and stable."""
    lp = torch.log_softmax(logits.float(), dim=-1).double()
    values, order = torch.sort(lp, dim=-1, descending=True, stable=True)
    return order[:, :k].cpu().numpy(), values[:, :k].cpu().numpy()


def _prefill_prompt(engine, prompt: list[int], pages: list[int]) -> torch.Tensor:
    """Chunk-prefill ``prompt`` into ``pages`` (the engine's prefill step,
    one sequence, the rest zero-length); returns the last token's logits."""
    ecfg = engine.ecfg
    ps = ecfg.page_size
    bpad = ecfg.max_batch_size
    start = 0
    last = None
    while start < len(prompt):
        take = min(ecfg.max_prefill_tokens, len(prompt) - start)
        total_pad = _bucket(take)
        tokens = np.zeros(total_pad, np.int32)
        tokens[:take] = prompt[start : start + take]
        positions = np.zeros(total_pad, np.int32)
        positions[:take] = np.arange(start, start + take)
        slots = np.full(total_pad, -1, np.int32)
        slots[:take] = [pages[p // ps] * ps + p % ps for p in range(start, start + take)]
        cu = np.zeros(bpad + 1, np.int32)
        cu[1:] = take
        sl = np.zeros(bpad, np.int32)
        sl[0] = start + take
        bt = np.zeros((bpad, ecfg.max_pages_per_seq), np.int32)
        bt[0, : len(pages)] = pages
        logits, _, _ = engine._prefill_fn(
            engine.params, engine.config,
            token_ids=engine._tensor(tokens),
            positions=engine._tensor(positions),
            cu_seqlens_q=engine._tensor(cu),
            max_seqlen_q=total_pad,
            seq_lens=engine._tensor(sl),
            block_tables=engine._tensor(bt),
            slot_mapping=engine._tensor(slots),
            k_caches=engine.k_caches,
            v_caches=engine.v_caches,
        )
        last = logits[:1]
        start += take
    return last


def _fork_pages(engine, src_pages: list[int], kv_len: int) -> list[int]:
    """Share the full pages by refcount; copy the partial tail page."""
    ps = engine.ecfg.page_size
    full = kv_len // ps
    partial = kv_len % ps
    for page in src_pages[:full]:
        engine.allocator.fork(page)
    new_pages = list(src_pages[:full])
    if partial:
        engine._reclaim(1)
        fresh = engine.allocator.allocate()
        engine._copy_page(src_pages[full], fresh)
        new_pages.append(fresh)
    return new_pages


def beam_search(
    engine,
    prompt: list[int],
    beam_width: int,
    max_tokens: int,
    length_penalty: float = 1.0,
    eos_token_id: int | None = None,
) -> list[BeamHypothesis]:
    """Beam search for one prompt on an idle engine.

    Returns up to ``beam_width`` hypotheses, best-first. The engine's KV
    pool, prefill and decode steps and page allocator are used directly:
    no request may be in flight, and rolling-KV engines raise (ring pages
    cannot be shared between beams), as do a ``beam_width`` above the
    engine's ``max_batch_size`` and a prompt plus ``max_tokens`` past the
    page cap.
    """
    if engine.running or engine.waiting:
        msg = "beam_search needs an idle engine (offline API)"
        raise ValueError(msg)
    if engine._cap_tokens is not None:
        msg = "beam_search is incompatible with rolling_kv (shared ring pages)"
        raise ValueError(msg)
    ecfg = engine.ecfg
    if beam_width > ecfg.max_batch_size:
        msg = f"beam_width {beam_width} exceeds max_batch_size {ecfg.max_batch_size}"
        raise ValueError(msg)
    ps = ecfg.page_size
    eos = eos_token_id if eos_token_id is not None else ecfg.eos_token_id
    cap_tokens = ecfg.max_pages_per_seq * ps
    if len(prompt) + max_tokens + 1 > cap_tokens:
        msg = f"prompt+max_tokens exceeds the {cap_tokens}-token page cap"
        raise ValueError(msg)

    n_pages = -(-(len(prompt) + 1) // ps)
    engine._reclaim(n_pages)
    prompt_pages = [engine.allocator.allocate() for _ in range(n_pages)]
    order, values = _ranked(_prefill_prompt(engine, prompt, prompt_pages), beam_width + 1)

    finished: list[BeamHypothesis] = []

    def hyp_score(cum: float, length: int) -> float:
        return cum / max(length, 1) ** length_penalty

    # Seed beams from the prompt's top tokens (the KV covers the prompt).
    beams: list[_Beam] = []
    for tok, cum in zip(order[0].tolist(), values[0].tolist()):
        if tok == eos:
            finished.append(BeamHypothesis([tok], hyp_score(cum, 1)))
            continue
        if len(beams) == beam_width:
            continue
        pages = list(prompt_pages) if not beams else _fork_pages(engine, prompt_pages, len(prompt))
        beams.append(_Beam(tokens=[tok], pages=pages, cum=cum))
    if not beams:  # every seed was EOS
        for page in prompt_pages:
            engine.allocator.free(page)
        return sorted(finished, key=lambda h: -h.score)[:beam_width]

    bpad = ecfg.max_batch_size
    for _ in range(max_tokens - 1):
        # One synchronized decode over the live beams (each writes its last
        # token into its own partial page).
        tokens = np.zeros(bpad, np.int32)
        positions = np.zeros(bpad, np.int32)
        seq_lens = np.zeros(bpad, np.int32)
        slots = np.full(bpad, -1, np.int32)
        bt = np.zeros((bpad, ecfg.max_pages_per_seq), np.int32)
        for i, b in enumerate(beams):
            pos = len(prompt) + len(b.tokens) - 1
            if pos // ps >= len(b.pages):
                engine._reclaim(1)
                b.pages.append(engine.allocator.allocate())
            tokens[i] = b.tokens[-1]
            positions[i] = pos
            seq_lens[i] = pos + 1
            slots[i] = b.pages[pos // ps] * ps + pos % ps
            bt[i, : len(b.pages)] = b.pages
        logits, _, _ = engine._decode_fn(
            engine.params, engine.config,
            token_ids=engine._tensor(tokens),
            positions=engine._tensor(positions),
            seq_lens=engine._tensor(seq_lens),
            block_tables=engine._tensor(bt),
            slot_mapping=engine._tensor(slots),
            k_caches=engine.k_caches,
            v_caches=engine.v_caches,
        )

        # Rank (beam, token) candidates by cumulative logprob.
        k = min(2 * beam_width, logits.shape[-1])
        order, values = _ranked(logits[: len(beams)], k)
        cand = []
        for i, b in enumerate(beams):
            cand.extend((b.cum + lp, i, t) for t, lp in zip(order[i].tolist(), values[i].tolist()))
        cand.sort(key=lambda c: -c[0])

        new_live: list[tuple[float, int, int]] = []
        for cum, i, tok in cand:
            if tok == eos:
                finished.append(BeamHypothesis(beams[i].tokens + [tok], hyp_score(cum, len(beams[i].tokens) + 1)))
                continue
            if len(new_live) < beam_width:
                new_live.append((cum, i, tok))
        # Reassign pages: the first child inherits, extras fork, the childless free.
        children_of: dict[int, int] = {}
        next_beams = []
        for cum, i, tok in new_live:
            parent = beams[i]
            kv_len = len(prompt) + len(parent.tokens)  # this step's write included
            if children_of.get(i, 0) == 0:
                pages = list(parent.pages)
            else:
                pages = _fork_pages(engine, parent.pages, kv_len)
            children_of[i] = children_of.get(i, 0) + 1
            next_beams.append(_Beam(tokens=parent.tokens + [tok], pages=pages, cum=cum))
        for i, b in enumerate(beams):
            if children_of.get(i, 0) == 0:
                for page in b.pages:
                    engine.allocator.free(page)
        beams = next_beams
        if not beams:
            break

    for b in beams:
        finished.append(BeamHypothesis(list(b.tokens), hyp_score(b.cum, len(b.tokens))))
        for page in b.pages:
            engine.allocator.free(page)
    return sorted(finished, key=lambda h: -h.score)[:beam_width]
