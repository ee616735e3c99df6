# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Continuous-batching LLM serving engine over paged KV caches (counterpart
of ``conch_tpu/serving/engine.py``, single device).

Host-side scheduling in plain Python around device steps of fixed row
counts, as in the JAX package:

- decode: (max_batch_size,) rows; idle rows run with seq_len 0 and slot
  -1 (no cache write, zero attention output);
- prefill: token counts padded to power-of-two buckets, long prompts
  chunk-prefilled across steps (varlen attention with q_len < seq_len),
  padding rows with slot -1 and zero-length padding sequences;
- mixed batching: running decodes join a prefill step, one token each;
- automatic prefix caching of full prompt pages, LIFO preemption with
  recompute, and admission gated on free pages;
- multi-step greedy decode: K decode steps per dispatch with on-device
  argmax feedback, the host applying eos/stop/max_tokens afterwards and
  discarding overshoot;
- rolling KV for models whose every layer is sliding-window (Mistral):
  each sequence holds a ring of ``ceil((window + max_prefill_tokens) /
  page_size) + 1`` pages, position p at ring slot p % (ring pages x
  page_size), whatever its length; K3 and K7 read the ring
  (``config.kv_ring_pages``);
- prompt-lookup speculative decoding (greedy-exact, no draft model): the
  trailing n-gram's latest earlier match drafts up to N tokens, one
  verify step (``verify_fn``: every row's logits) checks them, and the
  longest correct prefix plus one token from the model is kept;
- parallel sampling (``n > 1``): the prompt is prefilled once, its full
  pages shared by refcount and its partial tail page copied a sibling;
- the logit rules (``min_tokens``, the repetition penalty, the logit
  bias) and logprobs under the rule-adjusted, unscaled logits;
- multi-LoRA (``lora=``, ``add_request(lora_id=...)``): every step carries
  one adapter id a token row, -1 on padding rows; the prefix cache is
  keyed by adapter;
- guided decoding (``SamplingParams(guided=TokenFSM)``, ``serving/guided.py``):
  after the other logit rules, each guided row's disallowed tokens go to
  -inf by one host-built (rows, vocab) bool mask a step and one
  ``torch.where``; the FSM state is walked from ``output_tokens``.

The KV pool is one stacked (L, P, KH, ps, D) tensor pair updated in place
by the model (the JAX engine donates it through its jitted steps); a
model config with ``kv_cache_layout == "mla"`` (DeepSeek) gets one packed
latent cache (L, P, ps, kv_packed_dim) instead, and ``v_caches`` is an
empty placeholder threaded through the steps untouched. The model is
Llama by default; ``prefill_fn``/``decode_fn`` swap the family
(``models.gemma.gemma_prefill``/``gemma_decode_step``,
``models.deepseek.deepseek_prefill``/``deepseek_decode_step``,
``models.moe.mixtral_prefill``/``mixtral_decode_step`` with a
``MoEConfig``), as in the JAX engine.

Beam search (``serving/beam_search.py``) and the OpenAI-compatible HTTP
server (``serving/server.py``) drive this engine from outside. The page
allocator is ``native.NativeBlockAllocator`` (C++, built at first use) when
``CONCH_ENABLE_CPP_EXT=1``, else ``BlockAllocator``. Tensor parallelism
(``mesh``) comes with ROADMAP Queue 1 item 8; asking for it raises.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field

import numpy as np
import torch

from conch_tpu_torch.models.deepseek import deepseek_decode_step, fuse_deepseek_params
from conch_tpu_torch.models.llama import fuse_llama_params, llama_decode_step, llama_prefill, llama_verify_forward
from conch_tpu_torch import envs
from conch_tpu_torch.platforms import resolve_device
from conch_tpu_torch.serving.block_allocator import BlockAllocator
from conch_tpu_torch.serving.sampling import SamplingParams, sample_tokens


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILLING = "prefilling"
    RUNNING = "running"
    FINISHED = "finished"


@dataclass
class Request:
    request_id: int
    prompt: list[int]
    sampling: SamplingParams
    state: RequestState = RequestState.WAITING
    pages: list[int] = field(default_factory=list)
    num_computed: int = 0  # tokens already prefilled (incl. recompute after preemption)
    output_tokens: list[int] = field(default_factory=list)
    # log P(sampled token) under the rule-adjusted, unscaled logits, only
    # with sampling.logprobs; index-aligned with output_tokens (tokens
    # survive preemption, recompute only appends).
    output_logprobs: list[float] = field(default_factory=list)
    num_preemptions: int = 0
    # Parallel sampling: siblings carry the id of the request that
    # prefilled the shared prompt; the parent remembers that it spawned its
    # group (a preemption's recompute must not spawn it again).
    parent_id: int | None = None
    siblings_spawned: bool = False
    # Multi-LoRA: index into the engine's stacked adapter set, -1: the base model.
    lora_id: int = -1
    # Guided decoding: (output tokens walked, FSM state after them).
    guided_cache: tuple[int, int] = (0, 0)

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.output_tokens)

    def token_at(self, pos: int) -> int:
        """Token at an absolute position, over prompt + generated tokens
        (generated tokens are re-prefilled after a preemption)."""
        if pos < len(self.prompt):
            return self.prompt[pos]
        return self.output_tokens[pos - len(self.prompt)]


@dataclass
class EngineConfig:
    page_size: int = 16
    num_pages: int = 512
    max_batch_size: int = 8
    max_pages_per_seq: int = 64
    max_prefill_tokens: int = 512
    eos_token_id: int | None = None
    seed: int = 0
    # Full prompt pages are registered by their token prefix and shared
    # (refcounted) across requests; finished requests' prefix pages stay in
    # an LRU pool and are evicted only under memory pressure.
    enable_prefix_caching: bool = True
    # Prompt-lookup speculative decoding: draft up to N tokens by matching
    # the trailing n-gram against the sequence's own history, verify them in
    # one step, keep the longest correct prefix plus one token. 0 disables;
    # applies only when every running request is plain greedy.
    num_speculative_tokens: int = 0
    speculative_ngram: int = 2
    # Running decodes join prefill steps (one token each, first from the
    # token budget), so they keep streaming while long prompts chunk.
    mixed_batching: bool = True
    # K greedy decode steps per dispatch when every running request is
    # plain greedy; finish rules are applied on the host afterwards and
    # overshoot is discarded (its KV sits past the rewound seq_len). 1
    # disables.
    multi_step_decode: int = 8
    # Rolling KV buffer for sliding-window models (Mistral-style): cap each
    # sequence's KV at a ring of ceil((sliding_window + max_prefill_tokens)
    # / page_size) + 1 pages; position p lives at ring slot p % cap_tokens.
    # Outputs equal the unbounded cache's: the window never reads an
    # overwritten slot. Needs the model's sliding_window > 0 and prefix
    # caching off (ring pages are rewritten in place); LLMEngine checks.
    rolling_kv: bool = False


def _make_allocator(num_pages: int):
    """The native C++ allocator under ``CONCH_ENABLE_CPP_EXT=1`` (built at
    first use; a failed build raises), else the Python one."""
    if envs.CONCH_ENABLE_CPP_EXT:
        from conch_tpu_torch import native

        return native.NativeBlockAllocator(num_pages)
    return BlockAllocator(num_pages)


def _bucket(n: int, floor: int = 16) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


class LLMEngine:
    """Continuous-batching engine serving one model on one device.

    ``params`` come from ``init_llama_params``/``params_from_jax`` (or the
    Gemma counterparts, with ``prefill_fn=gemma_prefill`` and
    ``decode_fn=gemma_decode_step``, the DeepSeek ones, with
    ``prefill_fn=deepseek_prefill`` and ``decode_fn=deepseek_decode_step``,
    or Mixtral's ``init_moe_params``/``moe_params_from_jax`` with a
    ``MoEConfig``, ``prefill_fn=mixtral_prefill`` and
    ``decode_fn=mixtral_decode_step``; the HF converters of
    ``models.hf`` give each family's params) and must lie on ``device``
    (None: CUDA; without a CUDA device the engine raises unless
    ``device="cpu"``). The model functions take ``(params, config, ...)``
    with the Llama steps' arguments. Projections that share an input are
    fused once here, by model family as in the JAX engine:
    ``fuse_deepseek_params`` for DeepSeek, ``fuse_llama_params`` (QKV and
    gate|up; Llama and Gemma share the layer schema, and Mixtral's expert
    stacks are raw tensors, so only its wq|wk|wv fuse) otherwise; pieces
    that cannot fuse stay as they are. ``rolling_kv`` needs a model config
    with a ``sliding_window``, which ``MoEConfig`` lacks, so Mixtral raises
    as in the JAX engine.

    ``verify_fn`` is the speculative verify step (``llama_verify_forward``
    by default; ``gemma_verify_forward``, ``deepseek_verify_forward`` or
    ``mixtral_verify_forward`` beside the other families' steps; a custom
    ``decode_fn`` with ``num_speculative_tokens`` needs one). ``lora`` is a
    stacked adapter set on ``device`` (``models.lora.stack_lora_adapters``
    or ``lora_from_jax``); each request picks one by ``lora_id``.
    """

    def __init__(
        self,
        params: dict,
        model_config,
        engine_config: EngineConfig,
        cache_dtype: torch.dtype | None = None,
        prefill_fn=None,
        decode_fn=None,
        verify_fn=None,
        mesh=None,
        lora=None,
        device: str | torch.device | None = None,
    ):
        if mesh is not None:
            msg = "tensor-parallel serving (mesh) is not ported yet (ROADMAP Queue 1, item 8)"
            raise NotImplementedError(msg)
        if engine_config.num_speculative_tokens > 0 and decode_fn is not None and verify_fn is None:
            msg = (
                "speculative decoding with a custom decode_fn needs a matching "
                "verify_fn (e.g. models.gemma.gemma_verify_forward)"
            )
            raise ValueError(msg)
        self.device = resolve_device(device)
        if params["embedding"].device.type != self.device.type:
            msg = f"params lie on {params['embedding'].device}, the engine runs on {self.device}"
            raise ValueError(msg)
        self.ecfg = engine_config
        # Rolling KV: _page_cap bounds each sequence's page list; _cap_tokens
        # (_page_cap * page_size) is the ring's modulus, None without a ring.
        self._page_cap = engine_config.max_pages_per_seq
        self._cap_tokens: int | None = None
        if engine_config.rolling_kv:
            model_config = self._ring_config(model_config, engine_config)
            self._page_cap = model_config.kv_ring_pages
            self._cap_tokens = self._page_cap * engine_config.page_size
        self.config = model_config
        fuse = fuse_deepseek_params if decode_fn is deepseek_decode_step else fuse_llama_params
        self.params = fuse(params)
        self._prefill_fn = prefill_fn or llama_prefill
        self._decode_fn = decode_fn or llama_decode_step
        self._verify_fn = verify_fn or llama_verify_forward
        self.lora = lora
        self.allocator = _make_allocator(engine_config.num_pages)
        dtype = cache_dtype or model_config.dtype
        if getattr(model_config, "kv_cache_layout", "kv") == "mla":
            cache_shape = (
                model_config.num_layers, engine_config.num_pages, engine_config.page_size,
                model_config.kv_packed_dim,
            )
            self.k_caches = torch.zeros(cache_shape, dtype=dtype, device=self.device)
            self.v_caches = torch.zeros((0,), dtype=dtype, device=self.device)
        else:
            cache_shape = (
                model_config.num_layers, engine_config.num_pages, model_config.num_kv_heads,
                engine_config.page_size, model_config.head_dim,
            )
            self.k_caches = torch.zeros(cache_shape, dtype=dtype, device=self.device)
            self.v_caches = torch.zeros(cache_shape, dtype=dtype, device=self.device)
        self.waiting: list[Request] = []
        self.running: list[Request] = []
        self._next_id = 0
        self._generator = torch.Generator(device=self.device).manual_seed(engine_config.seed)
        # Prefix cache: full-page token prefix -> page id, the reverse map,
        # and the LRU order of cache-held pages (the cache owns one reference).
        self._prefix_map: dict[tuple[int, ...], int] = {}
        self._page_key: dict[int, tuple[int, ...]] = {}
        self._cached_lru: dict[int, None] = {}
        # Parallel sampling groups: parent request id -> sibling ids.
        self._group: dict[int, list[int]] = {}
        self.prefix_cache_hits = 0  # tokens served from cache (stats)
        self.spec_tokens_drafted = 0
        self.spec_tokens_accepted = 0

    @staticmethod
    def _ring_config(model_config, engine_config: EngineConfig):
        """``model_config`` with ``kv_ring_pages`` set to the ring's pages:
        the window plus the largest write burst (a prefill chunk), plus one
        page of alignment slop. Raises, as the JAX engine does, for a model
        without a window, a config without ``kv_ring_pages`` (Gemma-2's
        global layers need the whole history), prefix caching, or a pool or
        table too small for the ring."""
        window = getattr(model_config, "sliding_window", 0)
        if window <= 0:
            msg = "rolling_kv requires a model with sliding_window > 0"
            raise ValueError(msg)
        if not hasattr(model_config, "kv_ring_pages"):
            msg = (
                f"{type(model_config).__name__} does not support rolling KV "
                "(no kv_ring_pages field: every layer must be sliding-window)"
            )
            raise ValueError(msg)
        if engine_config.enable_prefix_caching:
            msg = (
                "rolling_kv is incompatible with prefix caching (ring pages "
                "are rewritten in place); set enable_prefix_caching=False"
            )
            raise ValueError(msg)
        ps = engine_config.page_size
        slack = max(engine_config.max_prefill_tokens, engine_config.num_speculative_tokens + 1)
        cap_pages = -(-(window + slack) // ps) + 1
        if cap_pages > min(engine_config.max_pages_per_seq, engine_config.num_pages):
            msg = (
                f"rolling_kv needs max_pages_per_seq (and the pool) >= "
                f"{cap_pages} pages (window {window} + write burst {slack})"
            )
            raise ValueError(msg)
        return dataclasses.replace(model_config, kv_ring_pages=cap_pages)

    # -- public API --------------------------------------------------------

    def add_request(self, prompt: list[int], sampling: SamplingParams | None = None, lora_id: int | None = None) -> int:
        ps = self.ecfg.page_size
        cap_pages = min(self.ecfg.max_pages_per_seq, self.ecfg.num_pages)
        # Rolling KV: any prompt the rope cache covers fits (prefill wraps
        # the ring); positions past max_position would reuse its last row.
        if self._cap_tokens is None:
            if len(prompt) + 1 > cap_pages * ps:
                msg = (
                    f"prompt of {len(prompt)} tokens can never fit: engine caps a "
                    f"sequence at {cap_pages} pages x {ps} slots"
                )
                raise ValueError(msg)
        else:
            max_pos = getattr(self.config, "max_position", None)
            if max_pos is not None and len(prompt) + 1 > max_pos:
                msg = f"prompt of {len(prompt)} tokens exceeds the model's rope range (max_position {max_pos})"
                raise ValueError(msg)
        sampling = sampling or SamplingParams()
        if sampling.n < 1:
            msg = f"sampling.n must be >= 1, got {sampling.n}"
            raise ValueError(msg)
        if sampling.guided is not None:
            if self.ecfg.eos_token_id is None:
                msg = "guided decoding requires eos_token_id (the FSM finishes by emitting EOS)"
                raise ValueError(msg)
            fsm_vocab = sampling.guided.transitions.shape[1]
            if fsm_vocab != self.config.vocab_size:
                msg = (
                    f"guided FSM was built over a vocab of {fsm_vocab} tokens, "
                    f"model vocab is {self.config.vocab_size}"
                )
                raise ValueError(msg)
        if lora_id is None:
            lora_id = -1
        else:
            num_adapters = 0 if self.lora is None else int(self.lora["scales"].shape[0])
            if not 0 <= lora_id < num_adapters:
                msg = f"lora_id {lora_id} out of range: engine holds {num_adapters} adapters"
                raise ValueError(msg)
        rid = self._next_id
        self._next_id += 1
        self.waiting.append(Request(rid, list(prompt), sampling, lora_id=lora_id))
        return rid

    def stats(self) -> dict:
        """Serving counters, the JAX engine's keys."""
        return {
            "running": len(self.running),
            "waiting": len(self.waiting),
            "free_pages": self.allocator.num_free,
            "total_pages": self.ecfg.num_pages,
            "cached_prefix_pages": len(self._cached_lru),
            "prefix_cache_hit_tokens": self.prefix_cache_hits,
            "spec_tokens_drafted": self.spec_tokens_drafted,
            "spec_tokens_accepted": self.spec_tokens_accepted,
        }

    def abort_request(self, request_id: int) -> bool:
        """Cancel a live request and free its pages at once; pages the
        prefix cache holds stay (the cache owns its own reference, as on a
        normal finish). Aborting a parallel-sampling parent aborts its whole
        group. False if the id is unknown or already finished."""
        for sib_id in self._group.get(request_id, []):
            self.abort_request(sib_id)
        for i, r in enumerate(self.waiting):
            if r.request_id == request_id:
                self.waiting.pop(i)
                r.state = RequestState.FINISHED
                return True
        for r in self.running:
            if r.request_id == request_id:
                for page in r.pages:
                    self.allocator.free(page)
                r.pages = []
                r.state = RequestState.FINISHED
                self.running = [x for x in self.running if x.request_id != request_id]
                return True
        return False

    def generate(
        self, prompts: list[list[int]], sampling: SamplingParams | None = None, lora_ids: list | None = None
    ) -> list:
        """Offline batch generation: one output token list per prompt, or,
        with ``sampling.n > 1``, a list of ``n`` output lists per prompt (the
        parent's first). ``lora_ids`` picks an adapter per prompt (None: the
        base model)."""
        lora_ids = lora_ids or [None] * len(prompts)
        ids = [self.add_request(p, sampling, lora_id=lid) for p, lid in zip(prompts, lora_ids)]
        results: dict[int, list[int]] = {}
        while self.waiting or self.running:
            for req in self.step():
                results[req.request_id] = req.output_tokens
        if sampling is not None and sampling.n > 1:
            # .get: a parent cut before its prefill never spawned its group,
            # and an aborted sibling has no output.
            return [[results[i], *(results.get(s, []) for s in self._group.get(i, []))] for i in ids]
        return [results[i] for i in ids]

    def step(self) -> list[Request]:
        """Run one engine step; returns the requests that finished in it."""
        self._admit()
        if not self.running:
            return []
        prefilling = [r for r in self.running if r.state == RequestState.PREFILLING]
        if prefilling:
            batch = prefilling
            if self.ecfg.mixed_batching:
                decodes = self._ensure_decode_pages([r for r in self.running if r.state == RequestState.RUNNING])
                # Page growth may have preempted a prefilling request.
                batch = decodes + [r for r in prefilling if r.state == RequestState.PREFILLING]
            self._run_prefill(batch)
        else:
            decodable = [r for r in self.running if r.state == RequestState.RUNNING]
            # Speculation and the multi-step decode advance by the raw
            # argmax: every request must be plain greedy with no logit rule
            # pending and no logprobs to record.
            all_plain_greedy = all(
                r.sampling.temperature <= 0.0
                and r.sampling.repetition_penalty == 1.0
                and not r.sampling.logit_bias
                and not r.sampling.logprobs
                and r.sampling.guided is None
                and len(r.output_tokens) >= r.sampling.min_tokens
                for r in decodable
            )
            k = self.ecfg.multi_step_decode
            if self.ecfg.num_speculative_tokens > 0 and all_plain_greedy:
                self._run_spec_decode(decodable)
            elif k > 1 and all_plain_greedy:
                self._run_multi_step_decode(decodable, k)
            else:
                self._run_decode(self._ensure_decode_pages(decodable))

        finished = [r for r in self.running if r.state == RequestState.FINISHED]
        for req in finished:
            for page in req.pages:
                self.allocator.free(page)
            req.pages = []
        self.running = [r for r in self.running if r.state != RequestState.FINISHED]
        return finished

    # -- scheduling --------------------------------------------------------

    def _prefix_lookup(self, req: Request) -> list[int]:
        """Longest chain of cached full-prefix pages usable by ``req``
        (always leaving >= 1 token to prefill so logits are produced)."""
        if not self.ecfg.enable_prefix_caching:
            return []
        ps = self.ecfg.page_size
        shared: list[int] = []
        for k in range(1, min((req.total_len - 1) // ps, self.ecfg.max_pages_per_seq) + 1):
            # Keys carry the adapter id: LoRA on wk / wv changes a page's KV.
            page = self._prefix_map.get((req.lora_id, *(req.token_at(p) for p in range(k * ps))))
            if page is None:
                break
            shared.append(page)
        return shared

    def _register_prefix_pages(self, req: Request) -> None:
        """Publish ``req``'s computed full prompt pages into the prefix cache
        (the cache takes one reference per page)."""
        if not self.ecfg.enable_prefix_caching:
            return
        ps = self.ecfg.page_size
        for k in range(1, len(req.prompt) // ps + 1):
            page = req.pages[k - 1]
            key = (req.lora_id, *req.prompt[: k * ps])
            if key in self._prefix_map:
                continue
            self._prefix_map[key] = page
            self._page_key[page] = key
            self.allocator.fork(page)
            self._cached_lru[page] = None

    def _reclaim(self, n: int) -> None:
        """Evict LRU prefix-cache pages until ``n`` pages are allocatable."""
        while not self.allocator.can_allocate(n) and self._cached_lru:
            page = next(iter(self._cached_lru))
            del self._cached_lru[page]
            del self._prefix_map[self._page_key.pop(page)]
            self.allocator.free(page)

    def _admit(self) -> None:
        # Reserve pages for the tokens to prefill (prompt, plus generated
        # tokens recomputed after a preemption) + one page of decode
        # headroom; decode growth allocates page by page. Cached full-prefix
        # pages are shared instead of recomputed.
        ps = self.ecfg.page_size
        while self.waiting and len(self.running) < self.ecfg.max_batch_size:
            req = self.waiting[0]
            pages_needed = min(-(-(req.total_len + 1) // ps), self._page_cap)
            if pages_needed > self.ecfg.num_pages:
                # Grew past the whole pool (preempted, can never recompute).
                self.waiting.pop(0)
                req.state = RequestState.FINISHED
                self.running.append(req)
                continue
            shared = self._prefix_lookup(req)
            fresh_needed = pages_needed - len(shared)
            # Hold the shared pages BEFORE reclaiming, or _reclaim could
            # evict the very pages the lookup returned.
            for page in shared:
                self.allocator.fork(page)
                if page in self._cached_lru:
                    self._cached_lru[page] = self._cached_lru.pop(page)  # LRU touch
            self._reclaim(fresh_needed)
            if not self.allocator.can_allocate(fresh_needed):
                for page in shared:
                    self.allocator.free(page)
                break
            self.waiting.pop(0)
            req.pages = shared + [self.allocator.allocate() for _ in range(fresh_needed)]
            req.num_computed = len(shared) * ps
            self.prefix_cache_hits += req.num_computed
            req.state = RequestState.PREFILLING
            self.running.append(req)

    def _preempt_one(self) -> bool:
        """Preempt the youngest live request: free its pages and requeue it
        at the front of the waiting queue for recompute."""
        for victim in reversed(self.running):
            if victim.state in (RequestState.RUNNING, RequestState.PREFILLING):
                for page in victim.pages:
                    self.allocator.free(page)
                victim.pages = []
                victim.num_computed = 0
                victim.num_preemptions += 1
                victim.state = RequestState.WAITING
                self.running.remove(victim)
                self.waiting.insert(0, victim)
                return True
        return False

    def _ensure_decode_pages(self, reqs: list[Request], extra: dict[int, int] | None = None) -> list[Request]:
        """Grow each sequence's pages to cover its next KV write (plus
        ``extra`` slots); preempt younger requests when the pool runs dry.
        Returns the requests that still hold enough pages to step."""
        ps = self.ecfg.page_size
        extra = extra or {}
        ready = []
        for r in reqs:
            if r.state != RequestState.RUNNING:
                continue  # preempted by an earlier request's growth in this pass
            needed = -(-(r.total_len + extra.get(r.request_id, 0)) // ps)
            ok = True
            while len(r.pages) < min(needed, self._page_cap):
                self._reclaim(1)
                if self.allocator.can_allocate(1):
                    r.pages.append(self.allocator.allocate())
                    continue
                if not self._preempt_one() or r.state == RequestState.WAITING:
                    ok = False
                    break
            if ok and r.state == RequestState.RUNNING:
                ready.append(r)
        # A request ready early may have been preempted later in the pass;
        # coverage clamps at the page cap so a capped request still steps
        # (and finishes at_cap) instead of being filtered forever.
        cap_tokens = self._page_cap * ps
        return [
            r for r in ready
            if r.state == RequestState.RUNNING
            and len(r.pages) * ps >= min(r.total_len + extra.get(r.request_id, 0), cap_tokens)
        ]

    def _slot(self, req: Request, pos: int) -> int:
        if self._cap_tokens is not None:
            pos = pos % self._cap_tokens  # rolling KV: the ring slot
        return req.pages[pos // self.ecfg.page_size] * self.ecfg.page_size + pos % self.ecfg.page_size

    def _block_table(self, reqs: list[Request]) -> np.ndarray:
        """(max_batch_size, max_pages_per_seq) table; rows and entries past
        the requests' pages are 0."""
        bt = np.zeros((self.ecfg.max_batch_size, self.ecfg.max_pages_per_seq), dtype=np.int32)
        for i, r in enumerate(reqs):
            bt[i, : len(r.pages)] = r.pages
        return bt

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _lora_kwargs(self, per_row: list[int], n_pad: int) -> dict:
        """The step's multi-LoRA arguments: the stacked adapters and one
        adapter id a row (padding rows -1: no adapter); none without LoRA."""
        if self.lora is None:
            return {}
        ids = np.full(n_pad, -1, dtype=np.int32)
        ids[: len(per_row)] = per_row
        return {"lora": self.lora, "lora_ids": self._tensor(ids)}

    def _ragged_step(self, fn, chunks: list[tuple[Request, int, list[int]]]):
        """One varlen step of ``fn`` (prefill or verify) over ``chunks``:
        (request, first position, the tokens from there). Rows are padded
        to ``_bucket(total)`` (slot -1), the batch to max_batch_size with
        zero-length sequences, ``max_seqlen_q`` to ``_bucket(max q_len)``.
        Returns (logits, total rows, q_lens)."""
        tokens, positions, slots, q_lens, seq_lens, loras = [], [], [], [], [], []
        for r, start, toks in chunks:
            tokens.extend(toks)
            positions.extend(range(start, start + len(toks)))
            slots.extend(self._slot(r, p) for p in range(start, start + len(toks)))
            q_lens.append(len(toks))
            seq_lens.append(start + len(toks))
            loras.extend([r.lora_id] * len(toks))
        total = len(tokens)
        total_pad = _bucket(total)
        bpad = self.ecfg.max_batch_size
        tokens_arr = np.zeros(total_pad, dtype=np.int32)
        tokens_arr[:total] = tokens
        positions_arr = np.zeros(total_pad, dtype=np.int32)
        positions_arr[:total] = positions
        slots_arr = np.full(total_pad, -1, dtype=np.int32)
        slots_arr[:total] = slots
        cu = np.zeros(bpad + 1, dtype=np.int32)
        cu[1 : len(chunks) + 1] = np.cumsum(q_lens)
        cu[len(chunks) + 1 :] = total  # zero-length padding sequences
        sl = np.zeros(bpad, dtype=np.int32)
        sl[: len(chunks)] = seq_lens
        logits, _, _ = fn(
            self.params, self.config,
            token_ids=self._tensor(tokens_arr),
            positions=self._tensor(positions_arr),
            cu_seqlens_q=self._tensor(cu),
            max_seqlen_q=_bucket(max(q_lens)),
            seq_lens=self._tensor(sl),
            block_tables=self._tensor(self._block_table([r for r, _, _ in chunks])),
            slot_mapping=self._tensor(slots_arr),
            k_caches=self.k_caches,
            v_caches=self.v_caches,
            **self._lora_kwargs(loras, total_pad),
        )
        return logits, total, q_lens

    # -- device steps ------------------------------------------------------

    def _run_prefill(self, reqs: list[Request]) -> None:
        budget = self.ecfg.max_prefill_tokens
        batch: list[tuple[Request, int]] = []  # (request, chunk_len)
        for r in reqs:
            take = min(r.total_len - r.num_computed, budget)
            if take <= 0:
                continue
            batch.append((r, take))
            budget -= take
            if budget <= 0:
                break
        if not batch:
            return
        chunks = [
            (r, r.num_computed, [r.token_at(p) for p in range(r.num_computed, r.num_computed + take)])
            for r, take in batch
        ]
        logits, _, _ = self._ragged_step(self._prefill_fn, chunks)

        # Advance chunk progress; sample for requests whose tokens are all
        # computed (a completed prompt, or a mixed-in decode row).
        done_rows, fresh_prompt_rows = [], set()
        for i, (r, take) in enumerate(batch):
            was_prefilling = r.state == RequestState.PREFILLING
            r.num_computed += take
            if r.num_computed >= r.total_len:
                done_rows.append(i)
                if was_prefilling:
                    fresh_prompt_rows.add(i)
        if done_rows:
            sampled = self._sample(logits, [batch[i][0] for i in done_rows], rows=done_rows)
            for i, tok in zip(done_rows, sampled):
                r = batch[i][0]
                if i in fresh_prompt_rows:  # not mixed-in decode rows
                    self._register_prefix_pages(r)
                if r.sampling.n > 1 and r.parent_id is None and not r.siblings_spawned:
                    self._spawn_siblings(r, logits[i])
                r.output_tokens.append(int(tok))
                r.state = RequestState.RUNNING
                self._maybe_finish(r)

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy KV page ``src`` to ``dst`` in every layer on the device: the
        stacked K and V pools, or DeepSeek's one packed latent cache (the
        JAX engine's jitted XLA scatter; indexed copies here)."""
        for cache in (self.k_caches, self.v_caches):
            if cache.numel():
                cache[:, dst] = cache[:, src]

    def _spawn_siblings(self, parent: Request, logits_row: torch.Tensor) -> None:
        """Parallel sampling: fork ``n - 1`` siblings off the freshly
        prefilled parent. Full prompt pages are shared by refcount (decode
        never writes a full page); the partial tail page is copied for each
        sibling, which writes its own continuation there. Each running
        sibling draws its first token from the parent's last-row logits.
        Siblings that cannot fork (batch full, pool dry, or rolling KV, whose
        ring pages are rewritten in place) go to the waiting queue and
        recompute the prompt as an ordinary prefill, as in the JAX engine."""
        parent.siblings_spawned = True
        ps = self.ecfg.page_size
        compute_len = parent.total_len  # the prompt's length at spawn time
        full, partial = divmod(compute_len, ps)
        group = self._group.setdefault(parent.request_id, [])
        ready: list[Request] = []
        for _ in range(parent.sampling.n - 1):
            rid = self._next_id
            self._next_id += 1
            sib = Request(rid, list(parent.prompt), parent.sampling, parent_id=parent.request_id, lora_id=parent.lora_id)
            group.append(rid)
            can_fork = len(self.running) < self.ecfg.max_batch_size and self._cap_tokens is None
            if can_fork:
                self._reclaim(1 if partial else 0)
                can_fork = self.allocator.can_allocate(1 if partial else 0)
            if can_fork:
                for page in parent.pages[:full]:
                    self.allocator.fork(page)
                sib.pages = list(parent.pages[:full])
                if partial:
                    fresh = self.allocator.allocate()
                    sib.pages.append(fresh)
                    self._copy_page(parent.pages[full], fresh)
                sib.num_computed = compute_len
                sib.state = RequestState.RUNNING
                self.running.append(sib)
                ready.append(sib)
            else:
                self.waiting.append(sib)
        if ready:
            tiled = logits_row[None].expand(len(ready), -1)
            toks = self._sample(tiled, ready, rows=list(range(len(ready))))
            for sib, tok in zip(ready, toks):
                sib.output_tokens.append(int(tok))
                self._maybe_finish(sib)

    def _run_decode(self, reqs: list[Request]) -> None:
        if not reqs:
            return
        bpad = self.ecfg.max_batch_size
        tokens = np.zeros(bpad, dtype=np.int32)
        positions = np.zeros(bpad, dtype=np.int32)
        seq_lens = np.zeros(bpad, dtype=np.int32)
        slots = np.full(bpad, -1, dtype=np.int32)
        for i, r in enumerate(reqs):
            pos = r.total_len - 1  # position of the newest (already sampled) token
            tokens[i] = r.output_tokens[-1]
            positions[i] = pos
            seq_lens[i] = r.total_len
            slots[i] = self._slot(r, pos)
        logits, _, _ = self._decode_fn(
            self.params, self.config,
            token_ids=self._tensor(tokens),
            positions=self._tensor(positions),
            seq_lens=self._tensor(seq_lens),
            block_tables=self._tensor(self._block_table(reqs)),
            slot_mapping=self._tensor(slots),
            k_caches=self.k_caches,
            v_caches=self.v_caches,
            **self._lora_kwargs([r.lora_id for r in reqs], bpad),
        )
        sampled = self._sample(logits, reqs, rows=list(range(len(reqs))))
        for r, tok in zip(reqs, sampled):
            r.output_tokens.append(int(tok))
            r.num_computed = r.total_len - 1  # KV covers all but the new token
            self._maybe_finish(r)

    def _multi_step_greedy(
        self, tokens: torch.Tensor, positions: torch.Tensor, active: torch.Tensor, limit: torch.Tensor,
        bt: torch.Tensor, k: int, lora_kwargs: dict | None = None,
    ) -> torch.Tensor:
        """K greedy decode steps with on-device argmax feedback; (k, batch)
        tokens. Same masking as the JAX package's ``make_multi_step_scan``:
        seq_lens clamp at each row's owned pages (``limit``), writes past
        them get slot -1, and idle rows run with seq_len 0 and slot -1;
        under rolling KV the write slots wrap at the ring (the engine passes
        an unbounded ``limit`` for a fully grown ring). ``lora_kwargs``
        (``_lora_kwargs``) goes to every step."""
        ps = self.ecfg.page_size
        rows = torch.arange(bt.shape[0], device=bt.device)
        out = []
        for _ in range(k):
            seq_lens = torch.where(active, torch.minimum(positions + 1, limit), 0).to(torch.int32)
            wpos = positions % self._cap_tokens if self._cap_tokens is not None else positions
            page_idx = (wpos // ps).clamp(max=bt.shape[1] - 1).long()
            slots = bt[rows, page_idx] * ps + wpos % ps
            slots = torch.where(active & (positions < limit), slots, -1).to(torch.int32)
            logits, _, _ = self._decode_fn(
                self.params, self.config, tokens, positions, seq_lens, bt, slots, self.k_caches, self.v_caches,
                **(lora_kwargs or {}),
            )
            tokens = logits.argmax(dim=-1).to(torch.int32)
            positions = positions + 1
            out.append(tokens)
        return torch.stack(out)

    def _run_multi_step_decode(self, reqs: list[Request], k: int) -> None:
        """K greedy decode steps in one dispatch; the host applies finish
        rules per token and discards overshoot (KV past a finish sits beyond
        the rewound seq_len: masked by attention, overwritten later)."""
        reqs = self._ensure_decode_pages(reqs, extra={r.request_id: k - 1 for r in reqs})
        if not reqs:
            return
        bpad = self.ecfg.max_batch_size
        tokens = np.zeros(bpad, dtype=np.int32)
        positions = np.zeros(bpad, dtype=np.int32)
        active = np.zeros(bpad, dtype=bool)
        limit = np.zeros(bpad, dtype=np.int32)
        for i, r in enumerate(reqs):
            tokens[i] = r.output_tokens[-1]
            positions[i] = r.total_len - 1
            active[i] = True
            if self._cap_tokens is not None and len(r.pages) >= self._page_cap:
                limit[i] = 2**30  # a fully grown ring: writes wrap, never past the table
            else:
                limit[i] = len(r.pages) * self.ecfg.page_size
        toks = self._multi_step_greedy(
            self._tensor(tokens), self._tensor(positions), self._tensor(active), self._tensor(limit),
            self._tensor(self._block_table(reqs)), k, self._lora_kwargs([r.lora_id for r in reqs], bpad),
        ).cpu().numpy()
        for i, r in enumerate(reqs):
            for step in range(k):
                r.output_tokens.append(int(toks[step, i]))
                self._maybe_finish(r)
                if r.state == RequestState.FINISHED:
                    break
            r.num_computed = r.total_len - 1

    def _draft(self, req: Request) -> list[int]:
        """Prompt-lookup draft: the continuation of the latest earlier
        occurrence of the trailing n-gram in the sequence's own history, at
        most ``num_speculative_tokens`` tokens, the tokens still owed and
        the room left under the page cap (rolling KV: the ring wraps, so
        only the draft limit)."""
        n, limit = self.ecfg.speculative_ngram, self.ecfg.num_speculative_tokens
        hist = req.prompt + req.output_tokens
        if len(hist) <= n:
            return []
        pattern = hist[-n:]
        if self._cap_tokens is None:
            room = self.ecfg.max_pages_per_seq * self.ecfg.page_size - req.total_len - 1
        else:
            room = limit
        limit = min(limit, req.sampling.max_tokens - len(req.output_tokens), max(room, 0))
        for start in range(len(hist) - n - 1, -1, -1):
            if hist[start : start + n] == pattern:
                return hist[start + n : start + n + limit]
        return []

    def _run_spec_decode(self, reqs: list[Request]) -> None:
        """Greedy decode with prompt-lookup speculation: one verify step over
        [last token] + draft a sequence; the longest correct draft prefix is
        kept plus one token from the model. KV written for rejected
        positions sits past the rewound seq_len: masked by attention,
        overwritten by later steps."""
        drafts = {r.request_id: self._draft(r) for r in reqs}
        reqs = self._ensure_decode_pages(reqs, extra={r.request_id: len(drafts[r.request_id]) for r in reqs})
        if not reqs:
            return
        chunks = [(r, r.total_len - 1, [r.output_tokens[-1], *drafts[r.request_id]]) for r in reqs]
        logits, total, q_lens = self._ragged_step(self._verify_fn, chunks)
        preds = logits[:total].argmax(dim=-1).cpu().numpy()
        offset = 0
        for r, qn in zip(reqs, q_lens):
            d = drafts[r.request_id]
            row_preds = preds[offset : offset + qn]
            offset += qn
            accepted = 0
            while accepted < len(d) and row_preds[accepted] == d[accepted]:
                accepted += 1
            self.spec_tokens_accepted += accepted
            self.spec_tokens_drafted += len(d)
            for tok in [*d[:accepted], int(row_preds[accepted])]:
                r.output_tokens.append(int(tok))
                self._maybe_finish(r)
                if r.state == RequestState.FINISHED:
                    break
            r.num_computed = r.total_len - 1

    def _sample(self, logits: torch.Tensor, reqs: list[Request], rows: list[int]) -> np.ndarray:
        """Sample ``reqs``' next tokens from ``logits`` rows ``rows`` after
        the logit rules; record each logprob the request asks for: the
        sampled token's ``log_softmax`` in f32 under the rule-adjusted
        logits, before the temperature, as the JAX engine does."""
        temps = np.zeros(logits.shape[0], dtype=np.float32)
        top_ks = np.zeros(logits.shape[0], dtype=np.int64)
        top_ps = np.ones(logits.shape[0], dtype=np.float32)
        for row, r in zip(rows, reqs):
            temps[row] = r.sampling.temperature
            top_ks[row] = r.sampling.top_k
            top_ps[row] = r.sampling.top_p
        logits = self._apply_logit_rules(logits, reqs, rows)
        toks = sample_tokens(
            logits, self._generator, self._tensor(temps), top_k=self._tensor(top_ks), top_p=self._tensor(top_ps)
        )
        lp_rows = [row for row, r in zip(rows, reqs) if r.sampling.logprobs]
        if lp_rows:
            index = self._tensor(np.asarray(lp_rows, dtype=np.int64))
            lsm = torch.log_softmax(logits[index].float(), dim=-1)
            vals = lsm.gather(-1, toks[index].long()[:, None])[:, 0].cpu().tolist()
            for r, v in zip((r for r in reqs if r.sampling.logprobs), vals):
                r.output_logprobs.append(float(v))
        return toks.cpu().numpy()[rows]

    def _apply_logit_rules(self, logits: torch.Tensor, reqs: list[Request], rows: list[int]) -> torch.Tensor:
        """The JAX engine's logit rules, in its order, each one indexed
        write over host-built index lists (a copy of ``logits`` only when a
        rule applies): ``min_tokens`` sets eos and the stop tokens to -inf;
        the repetition penalty divides the positive logits of every prompt
        and output token and multiplies the others; the logit bias is added
        (repeated tokens add up); last, the guided masks
        (``_apply_guided_masks``)."""
        sup_r, sup_c = [], []
        pen_r, pen_c, pen_v = [], [], []
        bias_r, bias_c, bias_v = [], [], []
        eos = self.ecfg.eos_token_id
        for row, r in zip(rows, reqs):
            s = r.sampling
            if len(r.output_tokens) < s.min_tokens:
                for tok in ({eos} if eos is not None else set()) | set(s.stop_token_ids):
                    sup_r.append(row)
                    sup_c.append(tok)
            if s.repetition_penalty != 1.0:
                for tok in set(r.prompt) | set(r.output_tokens):
                    pen_r.append(row)
                    pen_c.append(tok)
                    pen_v.append(s.repetition_penalty)
            for tok, bias in s.logit_bias:
                bias_r.append(row)
                bias_c.append(tok)
                bias_v.append(bias)
        if not (sup_r or pen_r or bias_r):
            return self._apply_guided_masks(logits, reqs, rows)
        logits = logits.clone()

        def index(rr, cc):
            return self._tensor(np.asarray(rr, dtype=np.int64)), self._tensor(np.asarray(cc, dtype=np.int64))

        if sup_r:
            logits[index(sup_r, sup_c)] = float("-inf")
        if pen_r:
            at = index(pen_r, pen_c)
            seen = logits[at]
            pv = self._tensor(np.asarray(pen_v, dtype=np.float32))
            logits[at] = torch.where(seen > 0, seen / pv, seen * pv)
        if bias_r:
            logits.index_put_(index(bias_r, bias_c), self._tensor(np.asarray(bias_v, dtype=np.float32)), accumulate=True)
        return self._apply_guided_masks(logits, reqs, rows)

    def _guided_state(self, req: Request) -> int:
        """The request's FSM state, walked from ``output_tokens`` with an
        O(1) incremental cache (a recompute that shortened them walks again
        from the start)."""
        fsm = req.sampling.guided
        n_cached, state = req.guided_cache
        if n_cached > len(req.output_tokens):
            n_cached, state = 0, fsm.start_state
        state = fsm.walk(req.output_tokens[n_cached:], state)
        req.guided_cache = (len(req.output_tokens), state)
        return state

    def _apply_guided_masks(self, logits: torch.Tensor, reqs: list[Request], rows: list[int]) -> torch.Tensor:
        """Guided decoding, as the JAX engine: the tokens a guided row's FSM
        disallows go to -inf, by one (rows, vocab) bool mask built on the
        host, moved once, and one ``torch.where`` (a new tensor: the caller's
        logits stay as they were). EOS is legal only in accepting states;
        where a state cannot extend (a complete fixed-length match, or a
        dead state) EOS is the only legal token and is set to 0.0, above the
        -inf that ``min_tokens`` gave it, so no row is all -inf."""
        pairs = [(row, r) for row, r in zip(rows, reqs) if r.sampling.guided is not None]
        if not pairs:
            return logits
        eos = self.ecfg.eos_token_id
        vocab = logits.shape[-1]
        mask_rows = np.zeros((len(pairs), vocab), dtype=bool)
        idx_rows = np.empty(len(pairs), dtype=np.int64)
        forced: list[int] = []  # rows where EOS is the only legal token
        for i, (row, r) in enumerate(pairs):
            fsm = r.sampling.guided
            state = self._guided_state(r)
            idx_rows[i] = row
            if state >= 0:
                allowed = fsm.allowed[state].copy()
                can_extend = bool(allowed.any())
                if fsm.accepting[state]:
                    allowed[eos] = True
                if not can_extend:
                    allowed[:] = False
                    allowed[eos] = True
                    forced.append(row)
            else:  # a dead state (the masks never let a request reach one)
                allowed = np.zeros(vocab, dtype=bool)
                allowed[eos] = True
                forced.append(row)
            mask_rows[i] = allowed
        rr = self._tensor(idx_rows)
        masked = torch.where(self._tensor(mask_rows), logits[rr], float("-inf"))
        logits = logits.index_put((rr,), masked)
        if forced:
            logits[self._tensor(np.asarray(forced, dtype=np.int64)), eos] = 0.0
        return logits

    def _maybe_finish(self, req: Request) -> None:
        eos = self.ecfg.eos_token_id
        last = req.output_tokens[-1] if req.output_tokens else None
        hit_stop = last is not None and (last == eos or last in req.sampling.stop_token_ids)
        if hit_stop and len(req.output_tokens) < req.sampling.min_tokens:
            hit_stop = False  # suppressed at sampling; belt and braces here
            if req.sampling.guided is not None and last == eos:
                # A guided request finishes when its FSM cannot extend the
                # match: min_tokens cannot force tokens the constraint
                # forbids (the state walked without the final EOS).
                fsm = req.sampling.guided
                state = fsm.walk(req.output_tokens[:-1])
                if state < 0 or not bool(fsm.allowed[state].any()):
                    hit_stop = True
        out_of_len = len(req.output_tokens) >= req.sampling.max_tokens
        # Rolling KV: the length is never page-bound (the ring wraps) but is
        # rope-bound.
        if self._cap_tokens is None:
            at_cap = req.total_len >= self.ecfg.max_pages_per_seq * self.ecfg.page_size
        else:
            max_pos = getattr(self.config, "max_position", None)
            at_cap = max_pos is not None and req.total_len >= max_pos
        if hit_stop or out_of_len or at_cap:
            req.state = RequestState.FINISHED
