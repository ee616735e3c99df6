# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Mixture-of-Experts layer and the Mixtral family on the port's ops
(counterpart of ``conch_tpu/models/moe.py``).

Routing is GShard/Switch-style over a static capacity: a (T, E, C)
dispatch one-hot and combine tensor (``make_dispatch``), then dense
einsums, as in the JAX package: ``tec,th->ech`` gathers each expert's
tokens, the experts run a batched SwiGLU ``(E, C, H) x (E, H, F)``, and
``tec,ech->th`` weighs their outputs back. Every expert's weights are
read in every step, so a step costs the whole expert stack whatever the
routing. Overflow tokens (past ``capacity``) fall through the residual
connection. The einsums and the SwiGLU between them are plain PyTorch
(cuBLAS on the card), as the JAX package leaves them to XLA; the
activation is ``silu(gate.f32) * up.f32`` rounded once, so K6 (which
rounds ``silu(gate)`` first) is not used.

Mixtral is Llama attention (K2, K3, K4, K5, K7, and K1 / K1b / K1c / K8
for quantized attention projections) with ``moe_ffn`` in place of the
gated MLP (``_forward_layers``'s ``mlp_fn``). Its params keep the JAX
layout: the attention projections stacked ``QuantizedLinear``s, the
router (L, H, E) f32 and the expert stacks ``w_gate`` / ``w_up``
(L, E, H, F) and ``w_down`` (L, E, F, H) in the config's dtype, so
``moe_params_from_jax`` carries a JAX tree across unchanged. The
capacity is counted over the step's padded rows, padding rows included,
as in the JAX package: padding rows route and take capacity too.

``mixtral_verify_forward`` gives every row's logits for speculative
decoding. Its padding rows stay finite: K7 writes zeros past
``cu_seqlens_q[batch]``, where the JAX package's varlen launcher leaves
NaN that its dispatch einsum spreads to every row (ROADMAP Queue 3, PR
22). Multi-LoRA reaches the attention projections through Llama's shared
layers (``lora``/``lora_ids``); the experts take no adapter. The training
forward and step (``moe_dense_forward``, ``make_moe_train_step``) and
expert parallelism (``ep_axis``) are later work (ROADMAP Queue 1, item 8).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

from conch_tpu_torch.models.linear import quantize_linear
from conch_tpu_torch.models.llama import (
    QUANT_MODES,
    LlamaConfig,
    LoraStep,
    _check_unported,
    _cos_sin_cache,
    _quant_kwargs,
    decode_forward,
    init_kv_caches,
    prefill_forward,
    stack_layers,
    tree_from_jax,
)
from conch_tpu_torch.platforms import resolve_device


@dataclass(frozen=True)
class MoEConfig:
    """Mixtral-style decoder config: Llama attention + sparse MoE MLP."""

    llama: LlamaConfig = field(default_factory=LlamaConfig)
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 2.0

    @staticmethod
    def mixtral_8x7b() -> MoEConfig:
        return MoEConfig(
            llama=LlamaConfig(
                vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_layers=32, num_heads=32,
                num_kv_heads=8, head_dim=128, rope_theta=1e6, max_position=32768,
            ),
            num_experts=8,
            top_k=2,
        )

    @staticmethod
    def tiny(**overrides) -> MoEConfig:
        llama_keys = {k: overrides.pop(k) for k in list(overrides) if hasattr(LlamaConfig(), k)}
        return MoEConfig(llama=LlamaConfig(**llama_keys), **overrides)

    def capacity(self, num_tokens: int) -> int:
        """Static per-expert token capacity for a step of ``num_tokens`` rows."""
        cap = math.ceil(num_tokens * self.top_k / self.num_experts * self.capacity_factor)
        return max(1, min(cap, num_tokens))

    # Engine-facing attributes: the engine sizes the KV pool off the model
    # config, and MoE attention geometry is the inner Llama config's.
    @property
    def num_layers(self) -> int:
        return self.llama.num_layers

    @property
    def num_kv_heads(self) -> int:
        return self.llama.num_kv_heads

    @property
    def head_dim(self) -> int:
        return self.llama.head_dim

    @property
    def dtype(self) -> torch.dtype:
        return self.llama.dtype

    @property
    def vocab_size(self) -> int:
        return self.llama.vocab_size


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: descending, and among equal
    values the lower index first (a stable sort promises that order;
    ``torch.topk`` on CUDA does not)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route_topk(router_logits: torch.Tensor, top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing with Mixtral's renormalized softmax.

    Returns (weights (T, k) f32 summing to 1 per token, experts (T, k)
    int32). Slot 0 is the argmax (the lower index at a tie), then in
    descending order: the slot order ranks capacity in ``make_dispatch``.
    """
    vals, idx = _top_k(router_logits.float(), top_k)
    return torch.softmax(vals, dim=-1), idx.to(torch.int32)


def make_dispatch(
    weights: torch.Tensor,  # (T, k) f32
    experts: torch.Tensor,  # (T, k) int
    num_experts: int,
    capacity: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Build the (T, E, C) dispatch one-hot and combine tensors (f32).

    Position-in-expert is an exclusive cumsum of each expert's selection
    mask over tokens (earlier tokens win capacity, matching GShard), and
    k-slots are ranked in order: a token's second-choice expert sees it
    after every token's first choice at that expert.

    The JAX package walks the k slots one at a time, starting each from the
    tokens its earlier slots admitted. Here one cumsum runs over the
    selections in slot-major order, which counts the earlier slots'
    dropped selections too; that changes no outcome: an expert that dropped
    a selection is full, so every later selection of it is dropped either
    way, and below capacity both counts agree. A token's k experts are
    distinct, so each (token, expert, position) gets at most one term.
    """
    t, k = weights.shape
    mask = F.one_hot(experts.t().reshape(-1).long(), num_experts).to(torch.int32)  # (k*T, E)
    pos = torch.cumsum(mask, dim=0, dtype=torch.int32) - mask  # exclusive
    keep = mask * (pos < capacity)
    pos_onehot = F.one_hot((pos * keep).sum(dim=1).long(), capacity).to(torch.float32).view(k, t, 1, capacity)
    sel = keep.to(torch.float32).view(k, t, num_experts, 1)
    dispatch = (sel * pos_onehot).sum(dim=0)
    combine = (sel * weights.t().to(torch.float32)[:, :, None, None] * pos_onehot).sum(dim=0)
    return dispatch, combine


def moe_experts(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """The experts' batched SwiGLU on their gathered tokens: (E, C, H) ->
    (E, C, H), in x's dtype, the activation ``silu(gate) * up`` in f32 and
    rounded once, as the JAX package computes it."""
    gate = torch.einsum("ech,ehf->ecf", x, w_gate)
    up = torch.einsum("ech,ehf->ecf", x, w_up)
    act = (F.silu(gate.float()) * up.float()).to(x.dtype)
    return torch.einsum("ecf,efh->ech", act, w_down)


def moe_ffn(
    hidden: torch.Tensor,  # (T, H)
    router_w: torch.Tensor,  # (H, E)
    w_gate: torch.Tensor,  # (E, H, F)
    w_up: torch.Tensor,  # (E, H, F)
    w_down: torch.Tensor,  # (E, F, H)
    top_k: int,
    capacity: int,
    ep_axis: str | None = None,
    routing: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Sparse SwiGLU MoE feed-forward as dense einsums, in ``hidden``'s dtype.

    The router logits are ``hidden.float() @ router_w.float()`` (on the
    card this needs TF32 off, PyTorch's default, or near ties flip);
    ``routing`` (weights, experts), when given, replaces ``route_topk``.
    The dispatch and combine tensors are cast to the compute dtype before
    their einsums, as in the JAX package, so in bf16 the combine weights
    are rounded to bf16.
    """
    if ep_axis is not None:
        msg = "expert parallelism (ep_axis) is not ported yet (ROADMAP Queue 1, item 8)"
        raise NotImplementedError(msg)
    compute_dtype = hidden.dtype
    if routing is None:
        routing = route_topk(hidden.float() @ router_w.float(), top_k)
    weights, experts = routing
    dispatch, combine = make_dispatch(weights, experts, router_w.shape[1], capacity)
    x = torch.einsum("tec,th->ech", dispatch.to(compute_dtype), hidden)
    y = moe_experts(x, w_gate, w_up, w_down)
    return torch.einsum("tec,ech->th", combine.to(compute_dtype), y)


def moe_ffn_reference(
    hidden: torch.Tensor,
    router_w: torch.Tensor,
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    top_k: int,
) -> torch.Tensor:
    """Naive per-token oracle (no capacity drops) for parity tests, in f32
    on the CPU; returned in ``hidden``'s dtype on its device."""
    h = hidden.detach().cpu().float()
    logits = h @ router_w.detach().cpu().float()
    wg, wu, wd = (w.detach().cpu().float() for w in (w_gate, w_up, w_down))
    out = torch.zeros_like(h)
    for t in range(h.shape[0]):
        order = torch.argsort(-logits[t], stable=True)[:top_k]
        sel = torch.exp(logits[t][order] - logits[t][order].max())
        sel = sel / sel.sum()
        for w, e in zip(sel, order.tolist()):
            g = h[t] @ wg[e]
            u = h[t] @ wu[e]
            act = g / (1 + torch.exp(-g)) * u
            out[t] += w * (act @ wd[e])
    return out.to(device=hidden.device, dtype=hidden.dtype)


def load_balance_loss(router_logits: torch.Tensor, experts: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Switch-Transformer auxiliary load-balancing loss (for training)."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    frac_tokens = F.one_hot(experts[:, 0].long(), num_experts).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return num_experts * (frac_tokens * frac_probs).sum()


def init_moe_params(
    seed: int, config: MoEConfig, quant_mode: str = "bf16", group_size: int = 128,
    device: str | torch.device | None = None,
) -> dict:
    """Random-initialize Mixtral params on ``device`` (None: CUDA).

    Weights are drawn on the device from a ``torch.Generator`` seeded with
    ``seed`` (normal, std 0.02), so a full-width model never passes
    through the host. The attention projections (wq, wk, wv, wo) are
    stacked on a leading layer axis and stored in ``quant_mode`` as
    ``init_llama_params`` stores them (quantized from each layer's float32
    draw; int4 and int8 at ``group_size``). The router is (L, H, E) f32;
    the expert stacks (L, E, H, F) / (L, E, F, H) are in ``config.dtype``,
    each expert's matrix drawn in f32 on its own (about 235 MB at
    Mixtral-8x7B's widths) and written into the stack. ``lm_head`` is bf16
    dense in every mode, as in the JAX package; norms are ones.
    """
    c = config.llama
    if quant_mode not in QUANT_MODES:
        msg = f"Unknown quantization mode: {quant_mode}"
        raise ValueError(msg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    h, inter, n_layers, n_experts = c.hidden_size, c.intermediate_size, c.num_layers, config.num_experts
    q_dim = c.num_heads * c.head_dim
    kv_dim = c.num_kv_heads * c.head_dim

    def normal(*shape: int) -> torch.Tensor:
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * 0.02

    quant_kwargs = _quant_kwargs(quant_mode, group_size, 64)

    def stacked(k_dim: int, n_dim: int):
        return stack_layers(lambda _: quantize_linear(normal(k_dim, n_dim), quant_mode, **quant_kwargs), n_layers)

    def experts(k_dim: int, n_dim: int) -> torch.Tensor:
        stack = torch.empty((n_layers, n_experts, k_dim, n_dim), dtype=c.dtype, device=device)
        for layer in range(n_layers):
            for e in range(n_experts):
                stack[layer, e] = normal(k_dim, n_dim)
        return stack

    layers = {
        "wq": stacked(h, q_dim),
        "wk": stacked(h, kv_dim),
        "wv": stacked(h, kv_dim),
        "wo": stacked(q_dim, h),
        "router": normal(n_layers, h, n_experts),
        "w_gate": experts(h, inter),
        "w_up": experts(h, inter),
        "w_down": experts(inter, h),
        "input_norm": torch.ones((n_layers, h), dtype=c.dtype, device=device),
        "post_attn_norm": torch.ones((n_layers, h), dtype=c.dtype, device=device),
    }
    return {
        "embedding": normal(c.vocab_size, h).to(c.dtype),
        "layers": layers,
        "final_norm": torch.ones((h,), dtype=c.dtype, device=device),
        "lm_head": quantize_linear(normal(h, c.vocab_size), "bf16"),
        "cos_sin_cache": _cos_sin_cache(c, device),
    }


def moe_params_from_jax(numpy_tree: dict, config: MoEConfig, device: str | torch.device | None = None) -> dict:
    """Carry a JAX Mixtral param tree (``conch_tpu.models.moe.init_moe_params``
    output, arrays turned into numpy) over to the port's params, bit for
    bit (``tree_from_jax``)."""
    c = config.llama
    params = tree_from_jax(numpy_tree, device)
    if tuple(params["cos_sin_cache"].shape) != (c.max_position, c.head_dim):
        msg = f"cos_sin_cache {tuple(params['cos_sin_cache'].shape)} does not match the config"
        raise ValueError(msg)
    want = (c.num_layers, c.hidden_size, config.num_experts)
    if tuple(params["layers"]["router"].shape) != want:
        msg = f"router {tuple(params['layers']['router'].shape)} does not match the config's {want}"
        raise ValueError(msg)
    return params


def init_moe_kv_caches(
    config: MoEConfig, num_pages: int, page_size: int, cache_dtype: torch.dtype | None = None,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stacked (L, P, KH, ps, D) key/value caches for the attention half."""
    return init_kv_caches(config.llama, num_pages, page_size, cache_dtype, device)


def _moe_mlp_fn(config: MoEConfig, capacity: int):
    def mlp_fn(layers: dict, layer: int, mlp_in: torch.Tensor) -> torch.Tensor:
        return moe_ffn(
            mlp_in, layers["router"][layer], layers["w_gate"][layer], layers["w_up"][layer],
            layers["w_down"][layer], config.top_k, capacity,
        )

    return mlp_fn


def _attention_lora(lora: dict | None, lora_ids: torch.Tensor | None) -> LoraStep | None:
    """The step's LoRA for Mixtral's attention; raises for an adapter on an
    MLP projection, which the MoE feed-forward has no place for."""
    if lora is not None and any(n in lora["layers"] for n in ("w_gate", "w_up", "w_down")):
        msg = "Mixtral's experts take no LoRA adapter: target wq, wk, wv or wo only"
        raise ValueError(msg)
    return LoraStep.make(lora, lora_ids)


def mixtral_decode_step(
    params: dict,
    config: MoEConfig,
    token_ids: torch.Tensor,  # (batch,)
    positions: torch.Tensor,  # (batch,) int32
    seq_lens: torch.Tensor,  # (batch,) int32; 0 = idle row
    block_tables: torch.Tensor,  # (batch, max_pages) int32
    slot_mapping: torch.Tensor,  # (batch,) int32, -1 = no write
    k_caches: torch.Tensor,  # updated in place
    v_caches: torch.Tensor,
    tp_axis: str | None = None,
    lora: dict | None = None,
    lora_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step; the contract of ``llama_decode_step``. The experts'
    capacity is ``config.capacity(batch)``, idle rows included."""
    _check_unported(config.llama, tp_axis)
    logits = decode_forward(
        params, config.llama, token_ids, positions, seq_lens, block_tables, slot_mapping, k_caches, v_caches,
        mlp_fn=_moe_mlp_fn(config, config.capacity(token_ids.shape[0])), lora=_attention_lora(lora, lora_ids),
    )
    return logits, k_caches, v_caches


def mixtral_prefill(
    params: dict,
    config: MoEConfig,
    token_ids: torch.Tensor,  # (total_tokens,)
    positions: torch.Tensor,  # (total_tokens,) int32
    cu_seqlens_q: torch.Tensor,  # (batch+1,) int32
    max_seqlen_q: int,
    seq_lens: torch.Tensor,  # (batch,) int32
    block_tables: torch.Tensor,  # (batch, max_pages) int32
    slot_mapping: torch.Tensor,  # (total_tokens,) int32, -1 = padding
    k_caches: torch.Tensor,  # updated in place
    v_caches: torch.Tensor,
    tp_axis: str | None = None,
    lora: dict | None = None,
    lora_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill forward; the contract of ``llama_prefill``. The experts'
    capacity is ``config.capacity(total_tokens)``, padding rows included;
    a padding row's attention output is zero (K7 and its plain version
    write zeros past ``cu_seqlens_q[batch]``), so it routes its token's
    embedding through the layers."""
    _check_unported(config.llama, tp_axis)
    logits = prefill_forward(
        params, config.llama, token_ids, positions, cu_seqlens_q, max_seqlen_q, seq_lens, block_tables,
        slot_mapping, k_caches, v_caches, mlp_fn=_moe_mlp_fn(config, config.capacity(token_ids.shape[0])),
        lora=_attention_lora(lora, lora_ids),
    )
    return logits, k_caches, v_caches


def mixtral_verify_forward(
    params: dict,
    config: MoEConfig,
    token_ids: torch.Tensor,  # (total_tokens,)
    positions: torch.Tensor,  # (total_tokens,) int32
    cu_seqlens_q: torch.Tensor,  # (batch+1,) int32
    max_seqlen_q: int,
    seq_lens: torch.Tensor,  # (batch,) int32
    block_tables: torch.Tensor,  # (batch, max_pages) int32
    slot_mapping: torch.Tensor,  # (total_tokens,) int32, -1 = padding
    k_caches: torch.Tensor,  # updated in place
    v_caches: torch.Tensor,
    tp_axis: str | None = None,
    lora: dict | None = None,
    lora_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Speculative verification: ``mixtral_prefill`` with logits for EVERY
    row (the contract of ``llama_verify_forward``). Padding rows route and
    take capacity as in prefill; their attention output is zero, so every
    row's logits are finite (the JAX package's are NaN on a padded step)."""
    _check_unported(config.llama, tp_axis)
    logits = prefill_forward(
        params, config.llama, token_ids, positions, cu_seqlens_q, max_seqlen_q, seq_lens, block_tables,
        slot_mapping, k_caches, v_caches, mlp_fn=_moe_mlp_fn(config, config.capacity(token_ids.shape[0])),
        lora=_attention_lora(lora, lora_ids), every_row=True,
    )
    return logits, k_caches, v_caches
