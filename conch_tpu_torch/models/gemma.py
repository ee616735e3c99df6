# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Gemma-family transformer on the port's ops (counterpart of ``conch_tpu/models/gemma.py``).

Llama's layer (``models/llama.py``: ``attention_block``, ``mlp_block``,
the stacked (L, P, KH, ps, D) pool updated in place), with Gemma's
differences:

- Gemma RMS norm, ``(1 + w)`` weighting, f32 throughout (K10a);
- GeGLU MLP, tanh-approximate GeLU gate (K10b);
- the embedding scaled by sqrt(hidden_size), rounded to the model dtype;
- the attention scale ``query_pre_attn_scalar ** -0.5`` and an optional
  logit softcap, in the K3/K7 kernels;
- tied embedding and lm head, with an optional final logit softcap;
- Gemma-2 (``gemma2=True``): sandwich norms (``post_attn_norm`` on the
  attention output and ``post_ff_norm`` on the MLP output, each before its
  residual add, ``pre_ff_norm`` before the MLP) and alternating local and
  global layers: even layer indices attend through a ``sliding_window``,
  odd ones see the whole sequence (HF convention). Gemma-1 uses
  ``post_attn_norm`` as the pre-MLP norm.

Where the JAX package scans layer pairs, the port loops over the layers in
Python; the window is ``sliding_window if layer % 2 == 0 else 0``. int8 and
float8_e4m3fn KV caches go as in Llama (``_kv_cache_quant``, with
``kv_cache_scale``). ``gemma_verify_forward`` gives every row's logits for
speculative decoding. The steps refuse LoRA adapters: the JAX package's
Gemma steps take none.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from conch_tpu_torch.models.linear import QuantizedLinear, quantize_linear
from conch_tpu_torch.models.llama import (
    QUANT_MODES,
    _kv_cache_quant,
    attention_block,
    init_kv_caches,
    mlp_block,
    stack_layers,
    tree_from_jax,
)
from conch_tpu_torch.ops.activation import gelu_tanh_and_mul, gelu_tanh_and_mul_parts
from conch_tpu_torch.ops.attention import paged_attention, varlen_attention
from conch_tpu_torch.ops.normalization import gemma_rms_norm
from conch_tpu_torch.platforms import resolve_device
from conch_tpu_torch.reference.embedding.rotary_embedding import compute_cos_sin_cache


@dataclass(frozen=True)
class GemmaConfig:
    """Gemma hyperparameters (defaults: a tiny debug model)."""

    vocab_size: int = 256
    hidden_size: int = 256
    intermediate_size: int = 512
    num_layers: int = 2
    num_heads: int = 4
    num_kv_heads: int = 1
    head_dim: int = 64
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    max_position: int = 8192
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    query_pre_attn_scalar: float | None = None  # defaults to head_dim
    gemma2: bool = False  # sandwich norms + alternating local (even) / global (odd) layers
    sliding_window: int = 0
    dtype: Any = torch.bfloat16
    # Static per-tensor scale for quantized (int8/fp8) KV caches, as Llama's.
    kv_cache_scale: float = 1.0 / 16

    def __post_init__(self) -> None:
        if self.gemma2:
            if self.sliding_window <= 0:
                msg = "gemma2=True requires a positive sliding_window (the local layers)"
                raise ValueError(msg)
            if self.num_layers % 2 != 0:
                msg = "gemma2 alternation needs an even num_layers"
                raise ValueError(msg)

    @staticmethod
    def gemma2_2b() -> GemmaConfig:
        return GemmaConfig(
            vocab_size=256128, hidden_size=2304, intermediate_size=9216, num_layers=26, num_heads=8,
            num_kv_heads=4, head_dim=256, attn_logit_softcap=50.0, final_logit_softcap=30.0,
            query_pre_attn_scalar=256.0, gemma2=True, sliding_window=4096,
        )

    def attn_scale(self) -> float:
        return (self.query_pre_attn_scalar or float(self.head_dim)) ** -0.5

    def window(self, layer: int) -> int:
        """The sliding window of ``layer``: Gemma-2's even layers, else 0."""
        return self.sliding_window if self.gemma2 and layer % 2 == 0 else 0


def _norm_names(config: GemmaConfig) -> tuple[str, ...]:
    extra = ("pre_ff_norm", "post_ff_norm") if config.gemma2 else ()
    return ("input_norm", "post_attn_norm", *extra)


def init_gemma_params(
    seed: int, config: GemmaConfig, quant_mode: str = "bf16", group_size: int = 128,
    device: str | torch.device | None = None,
) -> dict:
    """Random-initialize Gemma params on ``device`` (None: CUDA), in the JAX
    package's schema: the tied ``embedding`` (vocab, H), per-layer stacked
    projections and norm weights, ``final_norm`` and ``cos_sin_cache``.

    Weights are drawn on the device from a ``torch.Generator`` seeded with
    ``seed`` (normal, std 0.02), one layer at a time. The projections are
    bf16 dense (``quant_mode="bf16"``) or quantized on the device from each
    float32 draw, as the JAX package's ``init_gemma_params`` does: ``"int4"``
    and ``"int8"`` at ``group_size``, ``"nf4"`` at blocksize 64 (K12q),
    ``"w8a8"``. The logits stay the tied bf16 embedding in every mode. Norm
    weights are zero, so ``(1 + w)`` is 1, as in the JAX package.
    """
    if quant_mode not in QUANT_MODES:
        msg = f"Unknown quantization mode: {quant_mode}"
        raise ValueError(msg)
    quant_kwargs = {"group_size": group_size} if quant_mode in ("int4", "int8") else {}
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    h, inter, n_layers = config.hidden_size, config.intermediate_size, config.num_layers
    q_dim = config.num_heads * config.head_dim
    kv_dim = config.num_kv_heads * config.head_dim

    def normal(*shape: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return (torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * 0.02).to(dtype)

    def stacked(k_dim: int, n_dim: int) -> QuantizedLinear:
        return stack_layers(lambda _: quantize_linear(normal(k_dim, n_dim), quant_mode, **quant_kwargs), n_layers)

    layers: dict[str, Any] = {
        "wq": stacked(h, q_dim),
        "wk": stacked(h, kv_dim),
        "wv": stacked(h, kv_dim),
        "wo": stacked(q_dim, h),
        "w_gate": stacked(h, inter),
        "w_up": stacked(h, inter),
        "w_down": stacked(inter, h),
    }
    for name in _norm_names(config):
        layers[name] = torch.zeros((n_layers, h), dtype=config.dtype, device=device)
    return {
        "embedding": normal(config.vocab_size, h, dtype=config.dtype),  # tied: logits = hidden @ embedding.T
        "layers": layers,
        "final_norm": torch.zeros((h,), dtype=config.dtype, device=device),
        "cos_sin_cache": compute_cos_sin_cache(config.rope_theta, config.head_dim, config.max_position, device=device),
    }


def gemma_params_from_jax(numpy_tree: dict, config: GemmaConfig, device: str | torch.device | None = None) -> dict:
    """Carry a JAX Gemma param tree (``conch_tpu.models.gemma.init_gemma_params``
    output, arrays turned into numpy) over to the port's params, bit for bit
    (``tree_from_jax``); Gemma-2's ``pre_ff_norm`` and ``post_ff_norm`` must
    be there."""
    params = tree_from_jax(numpy_tree, device)
    missing = [n for n in _norm_names(config) if n not in params["layers"]]
    if missing:
        msg = f"Gemma params lack the norms {missing}"
        raise ValueError(msg)
    if params["cos_sin_cache"].shape != (config.max_position, config.head_dim):
        msg = f"cos_sin_cache {tuple(params['cos_sin_cache'].shape)} does not match the config"
        raise ValueError(msg)
    return params


def init_gemma_kv_caches(
    config: GemmaConfig, num_pages: int, page_size: int, cache_dtype: torch.dtype | None = None,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Allocate stacked (L, P, KH, ps, D) key/value caches on ``device``."""
    return init_kv_caches(config, num_pages, page_size, cache_dtype, device)


def _check_unported(tp_axis, lora) -> None:
    if tp_axis is not None:
        msg = "tensor parallelism is not ported yet (ROADMAP Queue 1, item 8)"
        raise NotImplementedError(msg)
    if lora is not None:
        msg = "Gemma takes no LoRA adapters (the JAX package's Gemma steps have none); LoRA serves the Llama family"
        raise NotImplementedError(msg)


def _embed(params: dict, config: GemmaConfig, token_ids: torch.Tensor) -> torch.Tensor:
    """Embedding rows times sqrt(hidden_size), the factor rounded to the
    model dtype first, as the JAX package does."""
    hidden = params["embedding"][token_ids.long()]
    factor = torch.tensor(config.hidden_size**0.5, dtype=hidden.dtype).item()
    return hidden * factor


def _gemma_layers(
    params: dict,
    config: GemmaConfig,
    hidden: torch.Tensor,
    positions: torch.Tensor,
    slot_mapping: torch.Tensor,
    k_caches: torch.Tensor,
    v_caches: torch.Tensor,
    attn_fn,
    decode: bool,
    kv_quant: tuple[str, float | None],
) -> torch.Tensor:
    """Run every layer on ``hidden`` (T, H), the caches updated in place.
    ``attn_fn(q, kc, vc, layer)`` picks the layer's window; ``kv_quant``
    (``_kv_cache_quant``) says how the store quantizes."""
    layers = params["layers"]
    eps = config.rms_norm_eps
    for layer in range(k_caches.shape[0]):
        attn_in = gemma_rms_norm(hidden, layers["input_norm"][layer], eps)
        attn_h = attention_block(
            params, layer, attn_in, positions, slot_mapping, k_caches, v_caches, attn_fn, decode,
            config.num_heads, config.head_dim, kv_quant,
        )
        if config.gemma2:
            hidden = hidden + gemma_rms_norm(attn_h, layers["post_attn_norm"][layer], eps)
            mlp_in = gemma_rms_norm(hidden, layers["pre_ff_norm"][layer], eps)
            mlp_out = mlp_block(layers, layer, mlp_in, gelu_tanh_and_mul, gelu_tanh_and_mul_parts)
            hidden = hidden + gemma_rms_norm(mlp_out, layers["post_ff_norm"][layer], eps)
        else:
            hidden = hidden + attn_h
            mlp_in = gemma_rms_norm(hidden, layers["post_attn_norm"][layer], eps)
            hidden = hidden + mlp_block(layers, layer, mlp_in, gelu_tanh_and_mul, gelu_tanh_and_mul_parts)
    return hidden


def _tied_logits(hidden: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """``hidden @ embedding.T`` accumulated in f32 with f32 output, as JAX's
    ``jnp.dot(..., preferred_element_type=f32)``. On the card a bf16 product
    writes f32 directly (``torch.mm(..., out_dtype=torch.float32)``), so the
    (vocab, H) embedding is never copied; the CPU casts both sides."""
    if hidden.is_cuda and hidden.dtype != torch.float32:
        return torch.mm(hidden, embedding.T, out_dtype=torch.float32)
    return torch.matmul(hidden.float(), embedding.T.float())


def _final_logits(params: dict, config: GemmaConfig, hidden: torch.Tensor) -> torch.Tensor:
    hidden = gemma_rms_norm(hidden, params["final_norm"], config.rms_norm_eps)
    logits = _tied_logits(hidden, params["embedding"])
    if config.final_logit_softcap > 0.0:
        logits = config.final_logit_softcap * torch.tanh(logits / config.final_logit_softcap)
    return logits


def _ragged_hidden(
    params, config, token_ids, positions, cu_seqlens_q, max_seqlen_q, seq_lens, block_tables, slot_mapping,
    k_caches, v_caches,
) -> torch.Tensor:
    """Prefill's and verify's trunk over a ragged step (K7 with the softcap
    and each layer's window): every row's hidden state, the caches updated
    in place."""
    hidden = _embed(params, config, token_ids)
    kv_quant = _kv_cache_quant(config, k_caches.dtype)
    kv_dtype, kv_scale = kv_quant

    def attn_fn(q, kc, vc, layer):
        return varlen_attention(
            q, kc, vc, cu_seqlens_q, max_seqlen_q, seq_lens, max_seqlen_q, block_tables, causal=True,
            scale=config.attn_scale(), softcap=config.attn_logit_softcap, kv_cache_dtype=kv_dtype,
            k_scale=kv_scale, v_scale=kv_scale, window_size=config.window(layer), layer_idx=layer,
        )

    return _gemma_layers(params, config, hidden, positions, slot_mapping, k_caches, v_caches, attn_fn, False, kv_quant)


def gemma_prefill(
    params: dict,
    config: GemmaConfig,
    token_ids: torch.Tensor,  # (total_tokens,)
    positions: torch.Tensor,  # (total_tokens,) int32
    cu_seqlens_q: torch.Tensor,  # (batch+1,) int32
    max_seqlen_q: int,
    seq_lens: torch.Tensor,  # (batch,) int32
    block_tables: torch.Tensor,  # (batch, max_pages) int32
    slot_mapping: torch.Tensor,  # (total_tokens,) int32, -1 = padding
    k_caches: torch.Tensor,  # (L, P, KH, ps, D), updated in place
    v_caches: torch.Tensor,
    tp_axis: str | None = None,
    lora: dict | None = None,
    lora_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill (or chunked-prefill) forward pass.

    Returns (last-token logits per sequence (batch, vocab) f32, k_caches,
    v_caches); the caches are the arguments, updated in place.
    """
    _check_unported(tp_axis, lora)
    hidden = _ragged_hidden(
        params, config, token_ids, positions, cu_seqlens_q, max_seqlen_q, seq_lens, block_tables, slot_mapping,
        k_caches, v_caches,
    )
    last_rows = (cu_seqlens_q[1:] - 1).long()
    return _final_logits(params, config, hidden[last_rows]), k_caches, v_caches


def gemma_verify_forward(
    params: dict,
    config: GemmaConfig,
    token_ids: torch.Tensor,  # (total_tokens,)
    positions: torch.Tensor,  # (total_tokens,) int32
    cu_seqlens_q: torch.Tensor,  # (batch+1,) int32
    max_seqlen_q: int,
    seq_lens: torch.Tensor,  # (batch,) int32
    block_tables: torch.Tensor,  # (batch, max_pages) int32
    slot_mapping: torch.Tensor,  # (total_tokens,) int32, -1 = padding
    k_caches: torch.Tensor,  # (L, P, KH, ps, D), updated in place
    v_caches: torch.Tensor,
    tp_axis: str | None = None,
    lora: dict | None = None,
    lora_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Speculative-decoding verification: ``gemma_prefill`` with logits for
    EVERY row ((total_tokens, vocab) f32; the softcap, the alternating
    window and the tied head as in prefill), so that the engine checks each
    drafted token in one pass; rejected positions need no KV rollback."""
    _check_unported(tp_axis, lora)
    hidden = _ragged_hidden(
        params, config, token_ids, positions, cu_seqlens_q, max_seqlen_q, seq_lens, block_tables, slot_mapping,
        k_caches, v_caches,
    )
    return _final_logits(params, config, hidden), k_caches, v_caches


def gemma_decode_step(
    params: dict,
    config: GemmaConfig,
    token_ids: torch.Tensor,  # (batch,)
    positions: torch.Tensor,  # (batch,) int32
    seq_lens: torch.Tensor,  # (batch,) int32, lengths INCLUDING the new token; 0 = idle row
    block_tables: torch.Tensor,  # (batch, max_pages) int32
    slot_mapping: torch.Tensor,  # (batch,) int32, -1 = no write
    k_caches: torch.Tensor,  # updated in place
    v_caches: torch.Tensor,
    tp_axis: str | None = None,
    lora: dict | None = None,
    lora_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step for a batch of sequences.

    Returns (logits (batch, vocab) f32, k_caches, v_caches); the caches are
    the arguments, updated in place.
    """
    _check_unported(tp_axis, lora)
    hidden = _embed(params, config, token_ids)
    kv_quant = _kv_cache_quant(config, k_caches.dtype)
    kv_dtype, kv_scale = kv_quant

    def attn_fn(q, kc, vc, layer):
        return paged_attention(
            q, kc, vc, block_tables, seq_lens, scale=config.attn_scale(), softcap=config.attn_logit_softcap,
            kv_cache_dtype=kv_dtype, k_scale=kv_scale, v_scale=kv_scale, window_size=config.window(layer),
            layer_idx=layer,
        )

    hidden = _gemma_layers(
        params, config, hidden, positions, slot_mapping, k_caches, v_caches, attn_fn, True, kv_quant
    )
    return _final_logits(params, config, hidden), k_caches, v_caches
