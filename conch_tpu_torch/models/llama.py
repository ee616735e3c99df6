# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Llama-family transformer on the port's ops (counterpart of ``conch_tpu/models/llama.py``).

Decoder-only transformer: RMS norm (K4), NeoX RoPE (K5), GQA attention
over a stacked paged KV pool of shape (L, P, KH, ps, D) (decode: K2 write,
K3 attention; prefill: an indexed write, K7 attention), SwiGLU MLP (K6),
projections through ``QuantizedLinear`` (bf16 dense: ``torch.matmul``;
int4: K1; int8: K1b; nf4: K1c; w8a8: K8). int8 and float8_e4m3fn KV
caches are quantized on store with the static ``kv_cache_scale`` and
dequantized in the attention kernels (``_kv_cache_quant``, as in the JAX
package). Qwen2's q/k/v biases (``attention_bias``) are added in plain
PyTorch before RoPE, as the JAX package leaves the add to XLA; a
Mistral-style ``sliding_window`` reaches every layer's K3 and K7 calls,
and so does the rolling-KV ring (``kv_ring_pages``, set by the engine).
Where the JAX package scans the layers with ``lax.scan`` and donates the
caches, the port loops over the layers in Python and updates
the caches IN PLACE; ``llama_prefill`` and ``llama_decode_step`` still
return them, so call sites read alike.

Params are a dict of tensors in the JAX package's layout (per-layer
weights stacked on a leading layer axis), so ``params_from_jax`` carries
a JAX param tree across unchanged.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from conch_tpu_torch.models.linear import QuantizedLinear, quantize_linear
from conch_tpu_torch.models.lora import lora_delta, lora_selector
from conch_tpu_torch.ops.activation import silu_and_mul, silu_and_mul_parts
from conch_tpu_torch.ops.attention import paged_attention, varlen_attention
from conch_tpu_torch.ops.cache import reshape_and_cache, reshape_and_cache_stacked
from conch_tpu_torch.ops.embedding import rotary_embedding
from conch_tpu_torch.ops.normalization import rms_norm
from conch_tpu_torch.platforms import resolve_device
from conch_tpu_torch.reference.embedding.rotary_embedding import compute_cos_sin_cache


@dataclass(frozen=True)
class LlamaConfig:
    """Model hyperparameters (defaults: a tiny debug model)."""

    vocab_size: int = 256
    hidden_size: int = 256
    intermediate_size: int = 512
    num_layers: int = 2
    num_heads: int = 4
    num_kv_heads: int = 2
    head_dim: int = 64
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    max_position: int = 8192
    dtype: Any = torch.bfloat16
    # Static per-tensor scale for quantized (int8/fp8) KV caches: K/V are
    # stored as x / scale, rounded and clipped, and dequantized by folding
    # the scale into the attention scalars (``_kv_cache_quant``).
    kv_cache_scale: float = 1.0 / 16
    # Qwen2-style additive q/k/v projection biases ("bq"/"bk"/"bv" layer params).
    attention_bias: bool = False
    # Mistral-style sliding window on every layer (0 disables).
    sliding_window: int = 0
    # Rolling KV: each block-table row is a ring of this many pages, position
    # p at slot p % (kv_ring_pages * page_size). Set by the serving engine
    # (``EngineConfig.rolling_kv``); needs sliding_window > 0. 0 disables.
    kv_ring_pages: int = 0
    rope_scaling: tuple | None = None

    def rope_scaling_dict(self) -> dict | None:
        return dict(self.rope_scaling) if self.rope_scaling else None

    @staticmethod
    def qwen2_7b() -> LlamaConfig:
        return LlamaConfig(
            vocab_size=152064, hidden_size=3584, intermediate_size=18944, num_layers=28, num_heads=28,
            num_kv_heads=4, head_dim=128, rope_theta=1e6, rms_norm_eps=1e-6, max_position=32768,
            attention_bias=True,
        )

    @staticmethod
    def llama3_8b() -> LlamaConfig:
        return LlamaConfig(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336, num_layers=32, num_heads=32,
            num_kv_heads=8, head_dim=128, rope_theta=500000.0, rms_norm_eps=1e-5, max_position=8192,
        )

    @staticmethod
    def llama31_8b() -> LlamaConfig:
        return dataclasses.replace(
            LlamaConfig.llama3_8b(),
            max_position=131072,
            rope_scaling=(
                ("rope_type", "llama3"), ("factor", 8.0), ("low_freq_factor", 1.0),
                ("high_freq_factor", 4.0), ("original_max_position_embeddings", 8192),
            ),
        )

    @staticmethod
    def llama3_70b() -> LlamaConfig:
        return LlamaConfig(
            vocab_size=128256, hidden_size=8192, intermediate_size=28672, num_layers=80, num_heads=64,
            num_kv_heads=8, head_dim=128, rope_theta=500000.0, rms_norm_eps=1e-5, max_position=8192,
        )

    @staticmethod
    def tiny(**overrides) -> LlamaConfig:
        return LlamaConfig(**overrides)


def _cos_sin_cache(config: LlamaConfig, device: torch.device) -> torch.Tensor:
    return compute_cos_sin_cache(
        config.rope_theta, config.head_dim, config.max_position,
        rope_scaling=config.rope_scaling_dict(), device=device,
    )


QUANT_MODES = ("bf16", "dense", "none", "int4", "int8", "nf4", "w8a8")


def _quant_kwargs(quant_mode: str, group_size: int, blocksize: int, scale_dtype: torch.dtype = torch.bfloat16) -> dict:
    """The quantizer's arguments for a projection, as the JAX package passes
    them (int4: the scales' dtype too)."""
    if quant_mode == "int4":
        return {"group_size": group_size, "dtype": scale_dtype}
    if quant_mode == "int8":
        return {"group_size": group_size}
    if quant_mode == "nf4":
        return {"blocksize": blocksize}
    return {}


def init_llama_params(
    seed: int, config: LlamaConfig, quant_mode: str = "bf16", group_size: int = 128,
    device: str | torch.device | None = None, blocksize: int = 64, scale_dtype: torch.dtype = torch.bfloat16,
) -> dict:
    """Random-initialize Llama params on ``device`` (None: CUDA).

    Weights are drawn on the device from a ``torch.Generator`` seeded with
    ``seed`` (normal, std 0.02), one layer at a time, so a full-width model
    never passes through the host. Projections are stacked on a leading
    layer axis: bf16 dense for ``quant_mode="bf16"``, or quantized on the
    device from each float32 draw, as ``quantize_linear`` does it:
    ``"int4"`` (uint4b8, ``group_size``, scales in ``scale_dtype``: bf16
    as the JAX package's init, or f16 as a GPTQ checkpoint ships them
    beside an f16 ``config.dtype``), ``"int8"`` (uint8b128,
    ``group_size``), ``"nf4"`` (``blocksize``, K12q) or ``"w8a8"``.
    ``lm_head`` is stored in the same mode (nf4 at the default blocksize
    64, as in the JAX package), except for int4, where it stays bf16
    dense. Norms, the embedding and, with ``config.attention_bias``, the
    q/k/v biases ``bq``, ``bk``, ``bv`` (normal, std 0.02, drawn after
    the projections) are in ``config.dtype``.
    """
    _check_config(config)
    if quant_mode not in QUANT_MODES:
        msg = f"Unknown quantization mode: {quant_mode}"
        raise ValueError(msg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    h, inter, n_layers = config.hidden_size, config.intermediate_size, config.num_layers
    q_dim = config.num_heads * config.head_dim
    kv_dim = config.num_kv_heads * config.head_dim

    def normal(*shape: int, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        return (torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * 0.02).to(dtype)

    quant_kwargs = _quant_kwargs(quant_mode, group_size, blocksize, scale_dtype)

    def stacked(k_dim: int, n_dim: int) -> QuantizedLinear:
        return stack_layers(
            lambda _: quantize_linear(normal(k_dim, n_dim, dtype=torch.float32), quant_mode, **quant_kwargs), n_layers
        )

    layers = {
        "wq": stacked(h, q_dim),
        "wk": stacked(h, kv_dim),
        "wv": stacked(h, kv_dim),
        "wo": stacked(q_dim, h),
        "w_gate": stacked(h, inter),
        "w_up": stacked(h, inter),
        "w_down": stacked(inter, h),
        "input_norm": torch.ones((n_layers, h), dtype=config.dtype, device=device),
        "post_attn_norm": torch.ones((n_layers, h), dtype=config.dtype, device=device),
    }
    if config.attention_bias:
        for name, dim in (("bq", q_dim), ("bk", kv_dim), ("bv", kv_dim)):
            layers[name] = normal(n_layers, dim, dtype=config.dtype)
    embedding = normal(config.vocab_size, h, dtype=config.dtype)
    head_mode = "bf16" if quant_mode == "int4" else quant_mode
    head_kwargs = {"group_size": group_size} if head_mode == "int8" else {}
    return {
        "embedding": embedding,
        "layers": layers,
        "final_norm": torch.ones((h,), dtype=config.dtype, device=device),
        "lm_head": quantize_linear(normal(h, config.vocab_size, dtype=torch.float32), head_mode, **head_kwargs),
        "cos_sin_cache": _cos_sin_cache(config, device),
    }


def requantize_llama_params(params: dict, config: LlamaConfig, quant_mode: str, group_size: int = 128) -> dict:
    """Rebuild a dense (bf16) param tree in ``quant_mode`` ("int4", "int8",
    "nf4", "w8a8" or "bf16"), as ``init_llama_params`` would store it:
    each stacked projection quantized layer by layer on its device from
    the float32 values of its bf16 weights, ``lm_head`` in the same mode
    (bf16 for int4). Counterpart of
    ``conch_tpu.models.llama.requantize_llama_params``, which passes
    ``group_size`` to int4 and int8 and the defaults to the others."""
    if quant_mode not in QUANT_MODES:
        msg = f"Unknown quantization mode: {quant_mode}"
        raise ValueError(msg)
    kwargs = {"group_size": group_size} if quant_mode in ("int4", "int8") else {}

    def requant_stacked(ql: QuantizedLinear) -> QuantizedLinear:
        if ql.kind != "dense":
            msg = f"requantize needs dense params, got {ql.kind}"
            raise ValueError(msg)
        w = ql.arrays["w"]
        return stack_layers(lambda i: quantize_linear(w[i].to(torch.float32), quant_mode, **kwargs), w.shape[0])

    layers = dict(params["layers"])
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        layers[name] = requant_stacked(params["layers"][name])
    head = params["lm_head"]
    if head.kind != "dense":
        msg = f"requantize needs a dense lm_head, got {head.kind}"
        raise ValueError(msg)
    head_mode = "bf16" if quant_mode == "int4" else quant_mode
    head_kwargs = kwargs if head_mode in ("int4", "int8") else {}
    out = dict(params)
    out["layers"] = layers
    out["lm_head"] = quantize_linear(head.arrays["w"].to(torch.float32), head_mode, **head_kwargs)
    return out


def stack_layers(make: Callable[[int], QuantizedLinear], n_layers: int) -> QuantizedLinear:
    """Stack ``n_layers`` projections made one at a time by ``make(layer)``,
    layer 0 first, on a leading layer axis (so a full-width model holds one
    layer's draw at a time beside the stack)."""
    first = make(0)
    arrays = {
        name: torch.empty((n_layers, *a.shape), dtype=a.dtype, device=a.device) for name, a in first.arrays.items()
    }
    for layer in range(n_layers):
        piece = first if layer == 0 else make(layer)
        for name, a in piece.arrays.items():
            arrays[name][layer] = a
    return QuantizedLinear(first.kind, arrays, first.meta)


def _tensor_from_numpy(a: Any, device: torch.device) -> torch.Tensor:
    """numpy -> torch; bfloat16 (ml_dtypes) or uint16 arrays carry bf16 bits."""
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tree_from_jax(numpy_tree: dict, device: str | torch.device | None = None) -> dict:
    """Carry a JAX param tree (arrays turned into numpy) over to tensors on
    ``device``, any model family.

    The nesting is kept; a projection is any object with ``kind``,
    ``arrays`` and ``meta`` attributes (the JAX ``QuantizedLinear``).
    bf16 arrays travel as their 16-bit patterns
    (dtype ``bfloat16`` from ml_dtypes, or ``uint16``), because numpy has
    no bf16 of its own, and arrive bit for bit as ``torch.bfloat16``.
    """
    device = resolve_device(device)

    def convert(node: Any) -> Any:
        if hasattr(node, "kind") and hasattr(node, "arrays"):
            arrays = {k: _tensor_from_numpy(v, device) for k, v in node.arrays.items()}
            return QuantizedLinear(node.kind, arrays, dict(node.meta))
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _tensor_from_numpy(node, device)

    return convert(numpy_tree)


def params_from_jax(numpy_tree: dict, config: LlamaConfig, device: str | torch.device | None = None) -> dict:
    """Carry a JAX param tree (``conch_tpu.models.llama.init_llama_params``
    output, arrays turned into numpy) over to the port's params, bit for
    bit (``tree_from_jax``), Qwen2's biases among them."""
    _check_config(config)
    params = tree_from_jax(numpy_tree, device)
    if params["cos_sin_cache"].shape != (config.max_position, config.head_dim):
        msg = f"cos_sin_cache {tuple(params['cos_sin_cache'].shape)} does not match the config"
        raise ValueError(msg)
    if config.attention_bias != all(name in params["layers"] for name in ("bq", "bk", "bv")):
        msg = f"attention_bias={config.attention_bias} but the layers hold {sorted(params['layers'])}"
        raise ValueError(msg)
    return params


def init_kv_caches(
    config: LlamaConfig, num_pages: int, page_size: int, cache_dtype: torch.dtype | None = None,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Allocate stacked (L, P, KH, ps, D) key/value caches on ``device``."""
    cache_dtype = cache_dtype or config.dtype
    shape = (config.num_layers, num_pages, config.num_kv_heads, page_size, config.head_dim)
    device = resolve_device(device)
    return torch.zeros(shape, dtype=cache_dtype, device=device), torch.zeros(shape, dtype=cache_dtype, device=device)


_FUSION_GROUPS = (("wqkv", ("wq", "wk", "wv")), ("w_gateup", ("w_gate", "w_up")))


def fuse_llama_params(params: dict) -> dict:
    """Fuse QKV and gate|up into single wide-N projections (one-time).

    Returns a new params dict whose layer stack holds ``wqkv`` =
    [wq|wk|wv] and ``w_gateup`` = [w_gate|w_up]; the layer step slices the
    product instead. Pieces that cannot fuse are left as they are; Qwen2's
    biases stay separate and are added to the slices.
    """
    layers = dict(params["layers"])
    for fused_name, parts in _FUSION_GROUPS:
        if not all(isinstance(layers.get(p), QuantizedLinear) for p in parts):
            continue
        try:
            fused = QuantizedLinear.concat_n([layers[p] for p in parts])
        except ValueError:
            continue
        layers[fused_name] = fused
        for p in parts:
            del layers[p]
    return {**params, "layers": layers}


def _check_config(config: LlamaConfig) -> None:
    if config.kv_ring_pages > 0 and config.sliding_window <= 0:
        msg = "kv_ring_pages (rolling KV) requires sliding_window > 0"
        raise ValueError(msg)


def _check_unported(config: LlamaConfig, tp_axis) -> None:
    _check_config(config)
    if tp_axis is not None:
        msg = "tensor parallelism is not ported yet (ROADMAP Queue 1, item 8)"
        raise NotImplementedError(msg)


@dataclass(frozen=True)
class LoraStep:
    """One step's multi-LoRA: the stacked adapter set's ``layers``
    (``models/lora.py:stack_lora_adapters``) and the (T, A) scaled
    one-hot selector of the step's per-token adapter ids."""

    layers: dict
    sel: torch.Tensor

    @staticmethod
    def make(lora: dict | None, lora_ids: torch.Tensor | None) -> LoraStep | None:
        """None without adapters; raises if adapters come without ids."""
        if lora is None:
            return None
        if lora_ids is None:
            msg = "lora adapters were given but lora_ids is None"
            raise ValueError(msg)
        return LoraStep(lora["layers"], lora_selector(lora_ids, lora["scales"]))

    def targets(self, *names: str) -> bool:
        return any(n in self.layers for n in names)

    def add(self, name: str, layer: int, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """``y`` plus adapter ``name``'s delta on input ``x`` at ``layer``,
        added in f32 and cast back to y's dtype, as the JAX layer step does;
        ``y`` unchanged where no adapter targets ``name``."""
        ab = self.layers.get(name)
        if ab is None:
            return y
        return (y.float() + lora_delta(x, ab["a"][layer], ab["b"][layer], self.sel)).to(y.dtype)


def _kv_cache_quant(config, cache_dtype: torch.dtype) -> tuple[str, float | None]:
    """Map a KV-cache buffer dtype to (kv_cache_dtype string, scale) for
    reshape_and_cache and attention (quantize on store, folded dequant);
    ``config`` is any model config with a ``kv_cache_scale``."""
    if cache_dtype == torch.int8:
        return "int8", config.kv_cache_scale
    if cache_dtype == torch.float8_e4m3fn:
        return "fp8_e4m3", config.kv_cache_scale
    return "auto", None


def attention_block(
    params: dict,
    layer: int,
    x: torch.Tensor,
    positions: torch.Tensor,
    slot_mapping: torch.Tensor,
    k_caches: torch.Tensor,
    v_caches: torch.Tensor,
    attn_fn,
    decode: bool,
    num_heads: int,
    head_dim: int,
    kv_quant: tuple[str, float | None],
    lora: LoraStep | None = None,
) -> torch.Tensor:
    """One layer's attention on its normed input ``x`` (T, H), before the
    residual add: q/k/v (fused ``wqkv`` or separate; Qwen2's ``bq``, ``bk``,
    ``bv`` added in plain PyTorch in their dtype), NeoX RoPE (K5), the
    layer's K/V written into the caches in place (decode: the K2 kernel;
    prefill: an indexed write, as the JAX package's XLA scatter), quantized
    on store as ``kv_quant`` (``_kv_cache_quant``) says, then
    ``attn_fn(q, k_caches, v_caches, layer)`` and ``wo``. ``lora`` adds its
    deltas to the q, k, v slices (before the biases) and to ``wo``."""
    layers = params["layers"]
    t = x.shape[0]
    num_kv_heads = k_caches.shape[2]
    q_dim = num_heads * head_dim
    kv_dim = num_kv_heads * head_dim
    if "wqkv" in layers:
        qkv = layers["wqkv"].apply_stacked(x, layer)
        q, k, v = qkv[:, :q_dim], qkv[:, q_dim : q_dim + kv_dim], qkv[:, q_dim + kv_dim :]
    else:
        q, k, v = (layers[n].apply_stacked(x, layer) for n in ("wq", "wk", "wv"))
    if lora is not None:
        q, k, v = (lora.add(n, layer, x, y) for n, y in zip(("wq", "wk", "wv"), (q, k, v)))
    if "bq" in layers:  # Qwen2-style attention bias
        q = q + layers["bq"][layer].to(q.dtype)
        k = k + layers["bk"][layer].to(k.dtype)
        v = v + layers["bv"][layer].to(v.dtype)
    q, k = rotary_embedding(positions, q, k, head_dim, params["cos_sin_cache"])
    k = k.view(t, num_kv_heads, head_dim)
    v = v.view(t, num_kv_heads, head_dim)
    kv_dtype, kv_scale = kv_quant
    if decode:
        reshape_and_cache_stacked(
            k, v, k_caches, v_caches, slot_mapping, layer, kv_cache_dtype=kv_dtype, k_scale=kv_scale,
            v_scale=kv_scale,
        )
    else:
        reshape_and_cache(
            k, v, k_caches[layer], v_caches[layer], slot_mapping, kv_cache_dtype=kv_dtype, k_scale=kv_scale,
            v_scale=kv_scale,
        )
    attn_in = attn_fn(q.view(t, num_heads, head_dim), k_caches, v_caches, layer).reshape(t, q_dim)
    out = layers["wo"].apply_stacked(attn_in, layer)
    return out if lora is None else lora.add("wo", layer, attn_in, out)


def mlp_block(
    layers: dict, layer: int, x: torch.Tensor, act_fused, act_parts, lora: LoraStep | None = None
) -> torch.Tensor:
    """One layer's gated MLP on ``x``: ``w_down(act(gate, up))``, gate|up
    fused (``w_gateup``, the activation reads the halves in place) or
    separate. ``lora`` adds its deltas to w_gate, w_up and w_down; where an
    adapter targets w_gate or w_up, the fused output is split and the
    activation takes the parts (K6's parts form), as in the JAX package."""
    if "w_gateup" in layers:
        gu = layers["w_gateup"].apply_stacked(x, layer)
        if lora is not None and lora.targets("w_gate", "w_up"):
            inter = gu.shape[-1] // 2
            act = act_parts(lora.add("w_gate", layer, x, gu[:, :inter]), lora.add("w_up", layer, x, gu[:, inter:]))
        else:
            act = act_fused(gu)
    else:
        gate, up = (layers[n].apply_stacked(x, layer) for n in ("w_gate", "w_up"))
        if lora is not None:
            gate, up = lora.add("w_gate", layer, x, gate), lora.add("w_up", layer, x, up)
        act = act_parts(gate, up)
    out = layers["w_down"].apply_stacked(act, layer)
    return out if lora is None else lora.add("w_down", layer, act, out)


def _forward_layers(
    params: dict,
    config: LlamaConfig,
    hidden: torch.Tensor,
    positions: torch.Tensor,
    slot_mapping: torch.Tensor,
    k_caches: torch.Tensor,
    v_caches: torch.Tensor,
    attn_fn,
    decode: bool,
    kv_quant: tuple[str, float | None],
    mlp_fn: Callable[[dict, int, torch.Tensor], torch.Tensor] | None = None,
    lora: LoraStep | None = None,
) -> torch.Tensor:
    """Run every layer on ``hidden`` (T, H), the caches updated in place.

    ``mlp_fn(layers, layer, mlp_in) -> delta`` replaces the gated MLP
    (``mlp_block``), as ``mlp_fn`` does in the JAX package's layer step
    (Mixtral's MoE feed-forward, ``models/moe.py``); ``lora`` reaches the
    attention projections and, without ``mlp_fn``, the MLP's."""
    layers = params["layers"]
    eps = config.rms_norm_eps
    for layer in range(k_caches.shape[0]):
        attn_in = rms_norm(hidden, layers["input_norm"][layer], eps)
        hidden = hidden + attention_block(
            params, layer, attn_in, positions, slot_mapping, k_caches, v_caches, attn_fn, decode,
            config.num_heads, config.head_dim, kv_quant, lora,
        )
        mlp_in = rms_norm(hidden, layers["post_attn_norm"][layer], eps)
        if mlp_fn is None:
            hidden = hidden + mlp_block(layers, layer, mlp_in, silu_and_mul, silu_and_mul_parts, lora)
        else:
            hidden = hidden + mlp_fn(layers, layer, mlp_in)
    return hidden


def _logits(params: dict, config: LlamaConfig, hidden: torch.Tensor) -> torch.Tensor:
    hidden = rms_norm(hidden, params["final_norm"], config.rms_norm_eps)
    return params["lm_head"].apply(hidden).float()


def llama_prefill(
    params: dict,
    config: LlamaConfig,
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
    v_caches); the caches are the arguments, updated in place. ``lora`` (a
    stacked adapter set, ``models/lora.py``) with ``lora_ids`` (one adapter
    id a token row, -1: none) adds each row's adapter deltas.
    """
    _check_unported(config, tp_axis)
    logits = prefill_forward(
        params, config, token_ids, positions, cu_seqlens_q, max_seqlen_q, seq_lens, block_tables, slot_mapping,
        k_caches, v_caches, lora=LoraStep.make(lora, lora_ids),
    )
    return logits, k_caches, v_caches


def llama_verify_forward(
    params: dict,
    config: LlamaConfig,
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
    """Speculative-decoding verification: ``llama_prefill`` with the final
    norm and ``lm_head`` on EVERY row, so that the engine checks each
    drafted token in one pass. Returns ((total_tokens, vocab) f32 logits,
    k_caches, v_caches). Rows past ``cu_seqlens_q[batch]`` get zero
    attention (K7), so their logits are finite. KV written for rejected
    positions needs no rollback: attention masks entries past ``seq_len``
    and later steps overwrite them.
    """
    _check_unported(config, tp_axis)
    logits = prefill_forward(
        params, config, token_ids, positions, cu_seqlens_q, max_seqlen_q, seq_lens, block_tables, slot_mapping,
        k_caches, v_caches, lora=LoraStep.make(lora, lora_ids), every_row=True,
    )
    return logits, k_caches, v_caches


def prefill_forward(
    params: dict, config: LlamaConfig, token_ids: torch.Tensor, positions: torch.Tensor,
    cu_seqlens_q: torch.Tensor, max_seqlen_q: int, seq_lens: torch.Tensor, block_tables: torch.Tensor,
    slot_mapping: torch.Tensor, k_caches: torch.Tensor, v_caches: torch.Tensor, mlp_fn=None,
    lora: LoraStep | None = None, every_row: bool = False,
) -> torch.Tensor:
    """``llama_prefill``'s body: the last-token logits of each sequence (of
    every row with ``every_row``: the verify step), the caches updated in
    place; ``mlp_fn`` and ``lora`` as in ``_forward_layers``."""
    hidden = params["embedding"][token_ids.long()]
    kv_quant = _kv_cache_quant(config, k_caches.dtype)
    kv_dtype, kv_scale = kv_quant

    def attn_fn(q, kc, vc, layer):
        return varlen_attention(
            q, kc, vc, cu_seqlens_q, max_seqlen_q, seq_lens, max_seqlen_q, block_tables,
            causal=True, kv_cache_dtype=kv_dtype, k_scale=kv_scale, v_scale=kv_scale,
            window_size=config.sliding_window, ring_pages=config.kv_ring_pages, layer_idx=layer,
        )

    hidden = _forward_layers(
        params, config, hidden, positions, slot_mapping, k_caches, v_caches, attn_fn, False, kv_quant, mlp_fn, lora
    )
    if every_row:
        return _logits(params, config, hidden)
    last_rows = (cu_seqlens_q[1:] - 1).long()
    return _logits(params, config, hidden[last_rows])


def llama_decode_step(
    params: dict,
    config: LlamaConfig,
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

    Returns (logits (batch, vocab) f32, k_caches, v_caches); the caches
    are the arguments, updated in place. ``lora``/``lora_ids`` as in
    ``llama_prefill``.
    """
    _check_unported(config, tp_axis)
    logits = decode_forward(
        params, config, token_ids, positions, seq_lens, block_tables, slot_mapping, k_caches, v_caches,
        lora=LoraStep.make(lora, lora_ids),
    )
    return logits, k_caches, v_caches


def decode_forward(
    params: dict, config: LlamaConfig, token_ids: torch.Tensor, positions: torch.Tensor, seq_lens: torch.Tensor,
    block_tables: torch.Tensor, slot_mapping: torch.Tensor, k_caches: torch.Tensor, v_caches: torch.Tensor,
    mlp_fn=None, lora: LoraStep | None = None,
) -> torch.Tensor:
    """``llama_decode_step``'s body: the logits of each row, the caches
    updated in place; ``mlp_fn`` and ``lora`` as in ``_forward_layers``."""
    hidden = params["embedding"][token_ids.long()]
    kv_quant = _kv_cache_quant(config, k_caches.dtype)
    kv_dtype, kv_scale = kv_quant

    def attn_fn(q, kc, vc, layer):
        return paged_attention(
            q, kc, vc, block_tables, seq_lens, kv_cache_dtype=kv_dtype, k_scale=kv_scale, v_scale=kv_scale,
            window_size=config.sliding_window, ring_pages=config.kv_ring_pages, layer_idx=layer,
        )

    hidden = _forward_layers(
        params, config, hidden, positions, slot_mapping, k_caches, v_caches, attn_fn, True, kv_quant, mlp_fn, lora
    )
    return _logits(params, config, hidden)
