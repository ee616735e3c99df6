# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""HuggingFace checkpoint import: HF state dicts -> the port's param trees
(counterpart of ``conch_tpu/models/hf.py``).

Each converter takes a state dict of torch tensors (as
``model.state_dict()`` or ``load_safetensors_dir`` gives them) or of
numpy arrays, and builds the params of the port's model family on
``device`` (None: CUDA), in the layout ``init_*_params`` and the JAX
package's converters give. Tensors are taken as they come, so a bf16
checkpoint stays bit for bit; numpy arrays go through ``torch.from_numpy``.
Projections are quantized on the way in (``quant_mode``: the modes of
``models.linear.quantize_linear``) from their ``.float()`` values, as the
JAX package quantizes from f32; norms and embeddings are cast to the
config's dtype.

Layout notes:
- HF ``nn.Linear`` stores (out_features, in_features); the port's
  projections are (K, N) = (in, out), so every weight transposes.
- HF Llama RoPE is NeoX-style rotate-half, as the port's K5; heads are
  head-major in both, so q/k/v need no permutation.
- Tied embeddings (no ``lm_head.weight``) reuse ``embed_tokens``.
"""

from __future__ import annotations

import pathlib
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from conch_tpu_torch.models.linear import quantize_linear
from conch_tpu_torch.models.llama import _cos_sin_cache, stack_layers
from conch_tpu_torch.platforms import resolve_device
from conch_tpu_torch.reference.embedding.rotary_embedding import compute_cos_sin_cache


def load_safetensors_dir(path: str | pathlib.Path) -> dict[str, torch.Tensor]:
    """Load every ``*.safetensors`` shard under ``path`` into one dict of
    CPU tensors, in the checkpoint's dtypes."""
    from safetensors.torch import load_file

    path = pathlib.Path(path)
    shards = sorted(path.glob("*.safetensors"))
    if not shards:
        msg = f"no .safetensors files under {path}"
        raise FileNotFoundError(msg)
    state: dict[str, torch.Tensor] = {}
    for shard in shards:
        state.update(load_file(str(shard)))
    return state


def _tensor(x: Any, device: torch.device) -> torch.Tensor:
    """A state-dict entry as a tensor on ``device``: torch tensors as they
    come, numpy arrays through ``torch.from_numpy``."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


class _Reader:
    """Reads one state dict onto one device: projections quantized from
    f32, other tensors cast, per-layer entries stacked."""

    def __init__(self, state: Mapping[str, Any], device, dtype: torch.dtype, quant_mode: str, group_size: int):
        self.state = state
        self.device = resolve_device(device)
        self.dtype = dtype
        self.quant_mode = quant_mode
        self.group_size = group_size

    def get(self, name: str) -> torch.Tensor:
        return _tensor(self.state[name], self.device)

    def proj(self, name: str, mode: str | None = None):
        """(out, in) -> a (K, N) projection in ``mode`` (default: the reader's)."""
        mode = mode or self.quant_mode
        kwargs = {"group_size": self.group_size} if mode in ("int4", "int8") else {}
        return quantize_linear(self.get(name).float().t().contiguous(), mode, **kwargs)

    def cast(self, name: str, dtype: torch.dtype | None = None) -> torch.Tensor:
        """A copy in ``dtype`` (default: the config's), never the state's own tensor."""
        return self.get(name).to(dtype or self.dtype, copy=True)

    def stacked_proj(self, n_layers: int, fmt: str):
        return stack_layers(lambda i: self.proj(fmt.format(i)), n_layers)

    def stacked(self, n_layers: int, fmt: str) -> torch.Tensor:
        return torch.stack([self.get(fmt.format(i)).to(self.dtype) for i in range(n_layers)])

    def experts(self, n_layers: int, n_experts: int, fmt: str) -> torch.Tensor:
        """(L, E, in, out) stack of ``fmt.format(layer, expert)`` (out, in) weights."""
        return torch.stack([
            torch.stack([self.get(fmt.format(i, e)).t().to(self.dtype) for e in range(n_experts)])
            for i in range(n_layers)
        ])

    def head_key(self) -> str:
        return "lm_head.weight" if "lm_head.weight" in self.state else "model.embed_tokens.weight"


_ATTENTION = (("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"), ("wv", "self_attn.v_proj"),
              ("wo", "self_attn.o_proj"))
_MLP = (("w_gate", "mlp.gate_proj"), ("w_up", "mlp.up_proj"), ("w_down", "mlp.down_proj"))
_NORMS = (("input_norm", "input_layernorm"), ("post_attn_norm", "post_attention_layernorm"))


def _layer_stacks(r: _Reader, n: int, projections, norms=_NORMS) -> dict:
    layers = {name: r.stacked_proj(n, f"model.layers.{{}}.{hf}.weight") for name, hf in projections}
    layers.update({name: r.stacked(n, f"model.layers.{{}}.{hf}.weight") for name, hf in norms})
    return layers


def llama_params_from_hf(
    state: Mapping[str, Any],
    config,
    quant_mode: str = "bf16",
    group_size: int = 128,
    device: str | torch.device | None = None,
) -> dict:
    """Convert an HF ``LlamaForCausalLM`` state dict (Qwen2's q/k/v biases
    too) to the port's Llama params on ``device``.

    ``config`` is a ``models.llama.LlamaConfig`` matching the checkpoint.
    ``lm_head`` is stored in ``quant_mode`` (bf16 for int4), as
    ``init_llama_params`` stores it.
    """
    r = _Reader(state, device, config.dtype, quant_mode, group_size)
    n = config.num_layers
    layers = _layer_stacks(r, n, _ATTENTION + _MLP)
    if "model.layers.0.self_attn.q_proj.bias" in state:  # Qwen2 family
        if not config.attention_bias:
            msg = "checkpoint has q/k/v biases: set LlamaConfig.attention_bias=True"
            raise ValueError(msg)
        for name, hf in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
            layers[name] = r.stacked(n, f"model.layers.{{}}.self_attn.{hf}.bias")
    head_mode = "bf16" if quant_mode == "int4" else quant_mode
    return {
        "embedding": r.cast("model.embed_tokens.weight"),
        "layers": layers,
        "final_norm": r.cast("model.norm.weight"),
        "lm_head": r.proj(r.head_key(), head_mode),
        "cos_sin_cache": _cos_sin_cache(config, r.device),
    }


def mixtral_params_from_hf(
    state: Mapping[str, Any],
    config,
    quant_mode: str = "bf16",
    group_size: int = 128,
    device: str | torch.device | None = None,
) -> dict:
    """Convert an HF ``MixtralForCausalLM`` state dict to the port's
    Mixtral params on ``device``.

    ``config`` is a ``models.moe.MoEConfig``. The experts'
    ``block_sparse_moe.experts.{e}.w{1,2,3}`` stack to the (L, E, ...)
    einsum layout of ``init_moe_params`` (w1 = gate, w3 = up, w2 = down)
    in the config's dtype; the router is ``block_sparse_moe.gate``, in
    f32. ``quant_mode`` applies to the attention projections; ``lm_head``
    stays bf16.
    """
    c = config.llama
    r = _Reader(state, device, c.dtype, quant_mode, group_size)
    n, e = c.num_layers, config.num_experts
    layers = _layer_stacks(r, n, _ATTENTION)
    p = "model.layers.{}.block_sparse_moe."
    router = torch.stack([r.get(f"{p}gate.weight".format(i)).t().float() for i in range(n)])
    layers.update({
        "router": router,
        "w_gate": r.experts(n, e, p + "experts.{}.w1.weight"),
        "w_up": r.experts(n, e, p + "experts.{}.w3.weight"),
        "w_down": r.experts(n, e, p + "experts.{}.w2.weight"),
    })
    return {
        "embedding": r.cast("model.embed_tokens.weight"),
        "layers": layers,
        "final_norm": r.cast("model.norm.weight"),
        "lm_head": r.proj(r.head_key(), "bf16"),
        "cos_sin_cache": _cos_sin_cache(c, r.device),
    }


def gemma_params_from_hf(
    state: Mapping[str, Any], config, quant_mode: str = "bf16", group_size: int = 128,
    device: str | torch.device | None = None,
) -> dict:
    """Convert an HF ``GemmaForCausalLM`` / ``Gemma2ForCausalLM`` state dict
    (tied embeddings, no ``lm_head``) to the port's Gemma params on
    ``device``. HF stores Gemma's norm weights in the ``(1 + w)`` offset
    form the port uses, so norms copy through; Gemma-2's sandwich norms
    (``pre_feedforward_layernorm`` / ``post_feedforward_layernorm``) need
    ``config.gemma2``."""
    r = _Reader(state, device, config.dtype, quant_mode, group_size)
    n = config.num_layers
    has_sandwich = "model.layers.0.pre_feedforward_layernorm.weight" in state
    if config.gemma2 and not has_sandwich:
        msg = "GemmaConfig.gemma2=True but the checkpoint has no sandwich norms (Gemma-1?)"
        raise ValueError(msg)
    if has_sandwich and not config.gemma2:
        msg = "checkpoint has Gemma-2 sandwich norms: set GemmaConfig.gemma2=True"
        raise ValueError(msg)
    norms = _NORMS + ((("pre_ff_norm", "pre_feedforward_layernorm"), ("post_ff_norm", "post_feedforward_layernorm"))
                      if has_sandwich else ())
    return {
        "embedding": r.cast("model.embed_tokens.weight"),
        "layers": _layer_stacks(r, n, _ATTENTION + _MLP, norms),
        "final_norm": r.cast("model.norm.weight"),
        "cos_sin_cache": compute_cos_sin_cache(config.rope_theta, config.head_dim, config.max_position, device=r.device),
    }


def phi3_params_from_hf(
    state: Mapping[str, Any],
    config,
    quant_mode: str = "bf16",
    group_size: int = 128,
    device: str | torch.device | None = None,
) -> dict:
    """Convert an HF ``Phi3ForCausalLM`` state dict (the Llama architecture
    with FUSED projections): the fused ``qkv_proj`` ([q|k|v] rows) and
    ``gate_up_proj`` ([gate|up] rows) are split into per-projection keys,
    then :func:`llama_params_from_hf` converts them."""
    q_dim = config.num_heads * config.head_dim
    kv_dim = config.num_kv_heads * config.head_dim
    inter = config.intermediate_size

    split: dict[str, Any] = {}
    for key, value in state.items():
        if key.endswith("self_attn.qkv_proj.weight"):
            base = key[: -len("qkv_proj.weight")]
            split[base + "q_proj.weight"] = value[:q_dim]
            split[base + "k_proj.weight"] = value[q_dim : q_dim + kv_dim]
            split[base + "v_proj.weight"] = value[q_dim + kv_dim :]
        elif key.endswith("mlp.gate_up_proj.weight"):
            base = key[: -len("gate_up_proj.weight")]
            split[base + "gate_proj.weight"] = value[:inter]
            split[base + "up_proj.weight"] = value[inter:]
        else:
            split[key] = value
    return llama_params_from_hf(split, config, quant_mode=quant_mode, group_size=group_size, device=device)


def deepseek_params_from_hf(state: Mapping[str, Any], config, device: str | torch.device | None = None) -> dict:
    """Convert an HF ``DeepseekV2ForCausalLM`` (or V3) state dict to the
    port's DeepSeek params on ``device``, in the ABSORBED layout:
    ``kv_b_proj`` is split into per-head W_uk (folded into the query) and
    W_uv (folded into the output), so the runtime never materializes
    per-head K/V (``models/deepseek.py``). Projections are bf16 dense.

    ``config`` is a ``models.deepseek.DeepseekV2Config``.
    """
    from conch_tpu_torch.models.deepseek import deepseek_rope_cache

    r = _Reader(state, device, config.dtype, "bf16", 128)
    nh, nope, v = config.num_heads, config.qk_nope_head_dim, config.v_head_dim
    lora = config.kv_lora_rank
    n_dense = config.num_layers if config.n_routed_experts == 0 else min(
        config.first_k_dense_replace, config.num_layers
    )
    segments = {"layers_dense": range(n_dense), "layers_moe": range(n_dense, config.num_layers)}
    out = {}
    for stack_name, ids in segments.items():
        if not ids:
            out[stack_name] = None
            continue
        per_layer = []
        for i in ids:
            p = f"model.layers.{i}."
            kv_b = r.get(p + "self_attn.kv_b_proj.weight").float()
            kv_b = kv_b.t().reshape(lora, nh, nope + v)  # (out, in) -> (lora, H, nope + v)
            layer = {
                "w_kv_a": r.proj(p + "self_attn.kv_a_proj_with_mqa.weight"),
                "kv_a_norm": r.cast(p + "self_attn.kv_a_layernorm.weight"),
                "w_uk": kv_b[:, :, :nope].permute(1, 2, 0).to(config.dtype),
                "w_uv": kv_b[:, :, nope:].permute(1, 0, 2).to(config.dtype),
                "wo": r.proj(p + "self_attn.o_proj.weight"),
                "input_norm": r.cast(p + "input_layernorm.weight"),
                "post_attn_norm": r.cast(p + "post_attention_layernorm.weight"),
            }
            if config.q_lora_rank:
                layer["wq_a"] = r.proj(p + "self_attn.q_a_proj.weight")
                layer["q_a_norm"] = r.cast(p + "self_attn.q_a_layernorm.weight")
                layer["wq_b"] = r.proj(p + "self_attn.q_b_proj.weight")
            else:
                layer["wq"] = r.proj(p + "self_attn.q_proj.weight")
            if stack_name == "layers_dense":
                for name, hf in _MLP:
                    layer[name] = r.proj(f"{p}{hf}.weight")
            else:
                # HF's gate weight is (E, hidden); router_w is (hidden, E).
                layer["router_w"] = r.get(p + "mlp.gate.weight").t().to(config.dtype)
                if config.topk_method == "noaux_tc":  # V3's correction bias
                    layer["router_bias"] = r.cast(p + "mlp.gate.e_score_correction_bias", torch.float32)
                for field, hf in (("e_gate", "gate_proj"), ("e_up", "up_proj"), ("e_down", "down_proj")):
                    layer[field] = torch.stack([
                        r.get(f"{p}mlp.experts.{e}.{hf}.weight").t().to(config.dtype)
                        for e in range(config.n_routed_experts)
                    ])
                if config.n_shared_experts > 0:
                    for name, hf in (("shared_gate", "gate_proj"), ("shared_up", "up_proj"),
                                     ("shared_down", "down_proj")):
                        layer[name] = r.proj(f"{p}mlp.shared_experts.{hf}.weight")
            per_layer.append(layer)
        out[stack_name] = {
            name: (stack_layers(lambda j, name=name: per_layer[j][name], len(per_layer))
                   if not isinstance(per_layer[0][name], torch.Tensor)
                   else torch.stack([layer[name] for layer in per_layer]))
            for name in per_layer[0]
        }
    return {
        "embedding": r.cast("model.embed_tokens.weight"),
        **out,
        "final_norm": r.cast("model.norm.weight"),
        "lm_head": r.proj(r.head_key()),
        "rope_cache": deepseek_rope_cache(config, r.device),
    }
