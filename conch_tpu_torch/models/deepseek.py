# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""DeepSeek-V2 family on the port's ops (counterpart of ``conch_tpu/models/deepseek.py``):
Multi-head Latent Attention + DeepSeek MoE, serving path.

MLA in the *absorbed* form: the KV cache stores one packed row
``[c_kv | k_pe | pad]`` per token (kv_lora_rank + qk_rope_head_dim values,
padded to a multiple of 128: 640 for V2-Lite), and the kv_b
up-projections are folded into the query (``q_nope @ W_uk``) and the
output (``out_lat @ W_uv``), so attention (K11) is MQA over the latent
rows. Interleaved-complex RoPE on the rope slices (pairs (x[2i], x[2i+1])
rotate together), YaRN-scaled; the q path full-rank (V2-Lite) or low-rank;
the MoE gate an f32 softmax over all experts, then top-k (greedy),
group-limited (V2) or sigmoid with a choice bias (noaux_tc, V3). Layers
below ``first_k_dense_replace`` have a dense SwiGLU MLP, the rest routed
experts (GShard dense dispatch with capacity, plain einsums as in the JAX
package) plus shared experts. Norms run K4, the fused dense and shared
gate|up K6.

Where the JAX package scans two stacked segments (dense, then MoE) and
donates the cache, the port loops over the layers in Python and updates
the one latent cache ``(L, P, ps, packed)`` in place, indexed by absolute
layer; the steps still return it. Params keep the JAX layout
(``layers_dense`` / ``layers_moe`` stacked on a leading layer axis), so
``deepseek_params_from_jax`` carries a JAX tree across unchanged. The
projections (``wq`` or ``wq_a``/``wq_b``, ``w_kv_a``, ``wo``, the dense
MLP, the shared experts and ``lm_head``) are bf16 or quantized in the
modes of ``QuantizedLinear`` (int4 and int8 at group 32 by default: K1 at
two groups a slice, K1b at 8 word rows a slice; nf4: K1c; w8a8: K8); the
absorbed ``w_uk``/``w_uv`` and the expert stacks stay dense, as in the JAX
package. ``deepseek_verify_forward`` gives every row's logits for
speculative decoding; its padding rows keep K11's copies of a row of the
last sequence, as the JAX launcher's clamped gather gives them, and take
MoE capacity as in prefill. The steps refuse LoRA adapters (the JAX
package's DeepSeek steps take none); tensor parallelism and training are
later work (ROADMAP Queue 1, item 8). int8 and float8_e4m3fn latent caches store
round(x / kv_cache_scale), saturating, and K11 folds the scale back in, as
in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from conch_tpu_torch.kernels.common import QUANTIZED_CACHE_DTYPES, round_up
from conch_tpu_torch.models.linear import QuantizedLinear, quantize_linear
from conch_tpu_torch.models.llama import QUANT_MODES, stack_layers, tree_from_jax
from conch_tpu_torch.models.moe import _top_k, moe_ffn
from conch_tpu_torch.ops.activation import silu_and_mul
from conch_tpu_torch.ops.attention import mla_attention
from conch_tpu_torch.ops.cache import reshape_and_cache_mla
from conch_tpu_torch.ops.normalization import rms_norm
from conch_tpu_torch.platforms import resolve_device


@dataclass(frozen=True)
class DeepseekV2Config:
    """DeepSeek-V2 hyperparameters (defaults: a tiny debug model)."""

    vocab_size: int = 512
    hidden_size: int = 128
    num_layers: int = 2
    num_heads: int = 4
    q_lora_rank: int | None = None  # None => full-rank q_proj (V2-Lite)
    kv_lora_rank: int = 64
    qk_nope_head_dim: int = 32
    qk_rope_head_dim: int = 16
    v_head_dim: int = 32
    # MoE (n_routed_experts = 0 => dense MLP in every layer)
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    num_experts_per_tok: int = 2
    moe_intermediate_size: int = 64
    intermediate_size: int = 256  # dense layers
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False
    # Gate variants: "greedy" (V2-Lite), "group_limited_greedy" (V2 —
    # keep topk_group of n_group expert groups by per-group max), or
    # "noaux_tc" (V3 — sigmoid scores, per-expert correction bias added
    # for CHOICE only, groups ranked by their top-2 sum).
    topk_method: str = "greedy"
    score_function: str = "softmax"  # "softmax" (V2) | "sigmoid" (V3)
    n_group: int = 1
    topk_group: int = 1
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    max_position: int = 4096
    dtype: Any = torch.bfloat16
    moe_capacity_factor: float = 2.0  # serving-path expert capacity factor
    # Static per-tensor scale for int8/fp8 latent caches.
    kv_cache_scale: float = 1.0 / 16
    # YaRN rope scaling (real V2/V3 checkpoints): HF-style dict stored as
    # an items-tuple so the frozen config stays hashable.
    rope_scaling: tuple | None = None
    yarn_mscale_attention: bool = False  # V3: mscale^2 on the softmax scale

    def rope_scaling_dict(self) -> dict | None:
        return dict(self.rope_scaling) if self.rope_scaling else None

    def attention_scale(self) -> float:
        """Softmax scale incl. the V3 yarn mscale^2 adjustment."""
        s = 1.0 / math.sqrt(self.qk_head_dim)
        rs = self.rope_scaling_dict()
        if self.yarn_mscale_attention and rs and rs.get("mscale_all_dim"):
            m = _yarn_mscale(rs["factor"], rs["mscale_all_dim"])
            s *= m * m
        return s

    # -- engine-facing geometry ------------------------------------------
    @property
    def kv_cache_layout(self) -> str:
        return "mla"

    @property
    def kv_packed_dim(self) -> int:
        """Cache row width: [c_kv | k_pe] padded to a multiple of 128."""
        return round_up(self.kv_lora_rank + self.qk_rope_head_dim, 128)

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @staticmethod
    def v2_lite() -> DeepseekV2Config:
        return DeepseekV2Config(
            vocab_size=102400, hidden_size=2048, num_layers=27, num_heads=16,
            q_lora_rank=None, kv_lora_rank=512, qk_nope_head_dim=128,
            qk_rope_head_dim=64, v_head_dim=128,
            n_routed_experts=64, n_shared_experts=2, num_experts_per_tok=6,
            moe_intermediate_size=1408, intermediate_size=10944,
            first_k_dense_replace=1, routed_scaling_factor=1.0,
            rope_theta=10000.0, max_position=163840,
            rope_scaling=(
                ("rope_type", "yarn"), ("factor", 40.0), ("beta_fast", 32),
                ("beta_slow", 1), ("mscale", 0.707), ("mscale_all_dim", 0.707),
                ("original_max_position_embeddings", 4096),
            ),
        )

    @staticmethod
    def v2() -> DeepseekV2Config:
        return DeepseekV2Config(
            vocab_size=102400, hidden_size=5120, num_layers=60, num_heads=128,
            q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
            qk_rope_head_dim=64, v_head_dim=128,
            n_routed_experts=160, n_shared_experts=2, num_experts_per_tok=6,
            moe_intermediate_size=1536, intermediate_size=12288,
            first_k_dense_replace=1, routed_scaling_factor=16.0,
            norm_topk_prob=False, rope_theta=10000.0, max_position=163840,
            rope_scaling=(
                ("rope_type", "yarn"), ("factor", 40.0), ("beta_fast", 32),
                ("beta_slow", 1), ("mscale", 0.707), ("mscale_all_dim", 0.707),
                ("original_max_position_embeddings", 4096),
            ),
        )

    @staticmethod
    def v3() -> DeepseekV2Config:
        """DeepSeek-V3/R1 geometry (same MLA; sigmoid noaux_tc gate)."""
        return DeepseekV2Config(
            vocab_size=129280, hidden_size=7168, num_layers=61, num_heads=128,
            q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
            qk_rope_head_dim=64, v_head_dim=128,
            n_routed_experts=256, n_shared_experts=1, num_experts_per_tok=8,
            moe_intermediate_size=2048, intermediate_size=18432,
            first_k_dense_replace=3, routed_scaling_factor=2.5,
            norm_topk_prob=True, topk_method="noaux_tc",
            score_function="sigmoid", n_group=8, topk_group=4,
            rope_theta=10000.0, max_position=163840,
            rope_scaling=(
                ("rope_type", "yarn"), ("factor", 40.0), ("beta_fast", 32),
                ("beta_slow", 1), ("mscale", 1.0), ("mscale_all_dim", 1.0),
                ("original_max_position_embeddings", 4096),
            ),
            yarn_mscale_attention=True,
        )

    @staticmethod
    def tiny(**overrides) -> DeepseekV2Config:
        return DeepseekV2Config(**overrides)


# -- RoPE (interleaved-complex convention) --------------------------------


def _yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def deepseek_rope_cache(config: DeepseekV2Config, device: str | torch.device | None = None) -> torch.Tensor:
    """(max_position, rope_dim) [cos | sin] cache, f32, on ``device`` (None: CUDA).

    With ``rope_scaling`` (YaRN): low-frequency dims interpolate
    (freq / factor), high-frequency dims extrapolate unchanged, blended by
    the NTK-by-parts linear ramp; the yarn attention factor scales cos/sin.
    Computed in float64 with numpy, as the JAX package does, then cast to
    f32, so the two caches agree bit for bit.
    """
    d = config.qk_rope_head_dim
    theta = config.rope_theta
    pos_freqs = theta ** (np.arange(0, d, 2, dtype=np.float64) / d)
    inv_freq = 1.0 / pos_freqs
    attention_factor = 1.0
    rs = config.rope_scaling_dict()
    if rs and rs.get("rope_type", rs.get("type")) == "yarn":
        factor = rs["factor"]
        orig = rs.get("original_max_position_embeddings") or config.max_position
        beta_fast = rs.get("beta_fast") or 32
        beta_slow = rs.get("beta_slow") or 1

        def corr_dim(num_rotations: float) -> float:
            return (d * math.log(orig / (num_rotations * 2 * math.pi))) / (2 * math.log(theta))

        low = max(math.floor(corr_dim(beta_fast)), 0)
        high = min(math.ceil(corr_dim(beta_slow)), d - 1)
        ramp = np.clip((np.arange(d // 2, dtype=np.float64) - low) / max(high - low, 1e-3), 0, 1)
        extrapolation = 1.0 - ramp
        inv_freq = (1.0 / (factor * pos_freqs)) * ramp + inv_freq * extrapolation
        attention_factor = rs.get("attention_factor")
        if attention_factor is None:
            mscale, msdim = rs.get("mscale"), rs.get("mscale_all_dim")
            if mscale and msdim:
                attention_factor = _yarn_mscale(factor, mscale) / _yarn_mscale(factor, msdim)
            else:
                attention_factor = _yarn_mscale(factor)
    angles = np.arange(config.max_position, dtype=np.float64)[:, None] * inv_freq[None, :]
    cache = (np.concatenate([np.cos(angles), np.sin(angles)], axis=-1) * attention_factor).astype(np.float32)
    return torch.from_numpy(cache).to(resolve_device(device))


def _apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs (x[2i], x[2i+1]) by angle_i; cos/sin
    broadcast over x's leading dims (last dim rope_dim / 2)."""
    x0 = x[..., 0::2]
    x1 = x[..., 1::2]
    o0 = x0 * cos - x1 * sin
    o1 = x0 * sin + x1 * cos
    return torch.stack([o0, o1], dim=-1).reshape(x.shape)


# -- MoE gate --------------------------------------------------------------


def deepseek_route(
    hidden: torch.Tensor,  # (T, H)
    router_w: torch.Tensor,  # (H, E)
    config: DeepseekV2Config,
    bias: torch.Tensor | None = None,  # (E,) noaux_tc correction bias
) -> tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek gate, all three HF variants; (weights (T, k) f32, experts (T, k) int32).

    - greedy (V2-Lite): softmax over all experts, top-k of the
      probabilities — not Mixtral's renormalized top-k softmax;
    - group_limited_greedy (V2): groups ranked by per-group MAX, only
      topk_group groups eligible;
    - noaux_tc (V3): sigmoid scores; ``bias`` is added for the CHOICE
      ranking only (groups by their top-2 sum), while the returned
      weights gather the UNbiased scores.
    """
    logits = hidden.float() @ router_w.float()
    scores = torch.sigmoid(logits) if config.score_function == "sigmoid" else torch.softmax(logits, dim=-1)
    choice = scores + bias[None, :] if bias is not None else scores
    if config.topk_method in ("group_limited_greedy", "noaux_tc"):
        t = choice.shape[0]
        e_per_g = config.n_routed_experts // config.n_group
        grouped = choice.reshape(t, config.n_group, e_per_g)
        if config.topk_method == "noaux_tc":
            group_scores = _top_k(grouped, 2)[0].sum(dim=-1)
        else:
            group_scores = grouped.amax(dim=-1)
        _, gidx = _top_k(group_scores, config.topk_group)
        gmask = F.one_hot(gidx, config.n_group).to(torch.float32).sum(dim=1)
        choice = torch.where(gmask.repeat_interleave(e_per_g, dim=-1) > 0, choice, 0.0)
    vals, idx = _top_k(choice, config.num_experts_per_tok)
    if config.topk_method == "noaux_tc":
        vals = torch.gather(scores, -1, idx)  # weights without the bias
    if config.norm_topk_prob:
        vals = vals / (vals.sum(dim=-1, keepdim=True) + 1e-20)
    return vals * config.routed_scaling_factor, idx.to(torch.int32)


def _moe_mlp(layers: dict, li: int, x: torch.Tensor, config: DeepseekV2Config) -> torch.Tensor:
    """Routed experts (dense-einsum dispatch, GShard capacity over the
    step's padded rows) + shared experts. The routed einsums and their
    SwiGLU are plain PyTorch, as in the JAX package; the fused shared
    gate|up goes through K6."""
    t = x.shape[0]
    cap = max(
        1,
        min(
            t,
            math.ceil(t * config.num_experts_per_tok / config.n_routed_experts * config.moe_capacity_factor),
        ),
    )
    bias = layers["router_bias"][li] if "router_bias" in layers else None
    routing = deepseek_route(x, layers["router_w"][li], config, bias=bias)
    out = moe_ffn(
        x, layers["router_w"][li], layers["e_gate"][li], layers["e_up"][li], layers["e_down"][li],
        config.num_experts_per_tok, cap, routing=routing,
    )
    if config.n_shared_experts > 0:
        if "shared_gateup" in layers:
            act = silu_and_mul(layers["shared_gateup"].apply_stacked(x, li)).to(x.dtype)
        else:
            sg = layers["shared_gate"].apply_stacked(x, li)
            su = layers["shared_up"].apply_stacked(x, li)
            act = (F.silu(sg.float()) * su.float()).to(x.dtype)
        out = out + layers["shared_down"].apply_stacked(act, li)
    return out


def _dense_mlp(layers: dict, li: int, x: torch.Tensor, config: DeepseekV2Config) -> torch.Tensor:
    if "w_gateup" in layers:
        act = silu_and_mul(layers["w_gateup"].apply_stacked(x, li)).to(x.dtype)
    else:
        gate = layers["w_gate"].apply_stacked(x, li)
        up = layers["w_up"].apply_stacked(x, li)
        act = (F.silu(gate.float()) * up.float()).to(x.dtype)
    return layers["w_down"].apply_stacked(act, li)


# -- params ----------------------------------------------------------------


def init_deepseek_params(
    seed: int, config: DeepseekV2Config, quant_mode: str = "bf16", group_size: int = 32,
    device: str | torch.device | None = None,
) -> dict:
    """Random-initialize DeepSeek-V2 params in the absorbed layout, on
    ``device`` (None: CUDA).

    Weights are drawn on the device from a ``torch.Generator`` seeded with
    ``seed`` (normal, std 0.02), one layer at a time, so a full-width model
    never passes through the host (the JAX package's numpy draw would need
    about 63 GB of host memory at V2-Lite's width). Stacks
    ``layers_dense`` (first_k_dense_replace layers) and ``layers_moe`` (the
    rest) on a leading layer axis. The projections, ``lm_head`` among them,
    are bf16 dense (``quant_mode="bf16"``) or quantized on the device from
    each float32 draw, as the JAX package's ``init_deepseek_params`` does:
    ``"int4"`` and ``"int8"`` at ``group_size``, ``"nf4"`` at blocksize 64
    (K12q), ``"w8a8"``. The absorbed ``w_uk``/``w_uv``, the router and the
    expert stacks are in ``config.dtype``; norms ones; the YaRN rope cache.
    """
    if quant_mode not in QUANT_MODES:
        msg = f"Unknown quantization mode: {quant_mode}"
        raise ValueError(msg)
    quant_kwargs = {"group_size": group_size} if quant_mode in ("int4", "int8") else {}
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    h = config.hidden_size
    nh, nope, rope, v = config.num_heads, config.qk_nope_head_dim, config.qk_rope_head_dim, config.v_head_dim
    lora = config.kv_lora_rank

    def normal(*shape: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return (torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * 0.02).to(dtype)

    def ones(n_layers: int, n: int) -> torch.Tensor:
        return torch.ones((n_layers, n), dtype=config.dtype, device=device)

    def stacked(n_layers: int, k_dim: int, n_dim: int) -> QuantizedLinear:
        return stack_layers(lambda _: quantize_linear(normal(k_dim, n_dim), quant_mode, **quant_kwargs), n_layers)

    def array(n_layers: int, *shape: int) -> torch.Tensor:
        out = torch.empty((n_layers, *shape), dtype=config.dtype, device=device)
        for layer in range(n_layers):
            out[layer] = normal(*shape, dtype=config.dtype)
        return out

    def make_stack(n_layers: int, moe: bool) -> dict | None:
        if n_layers == 0:
            return None
        layers = {
            "w_kv_a": stacked(n_layers, h, lora + rope),
            "kv_a_norm": ones(n_layers, lora),
            "w_uk": array(n_layers, nh, nope, lora),
            "w_uv": array(n_layers, nh, lora, v),
            "wo": stacked(n_layers, nh * v, h),
            "input_norm": ones(n_layers, h),
            "post_attn_norm": ones(n_layers, h),
        }
        if config.q_lora_rank:
            layers["wq_a"] = stacked(n_layers, h, config.q_lora_rank)
            layers["q_a_norm"] = ones(n_layers, config.q_lora_rank)
            layers["wq_b"] = stacked(n_layers, config.q_lora_rank, nh * (nope + rope))
        else:
            layers["wq"] = stacked(n_layers, h, nh * (nope + rope))
        if moe:
            e, f = config.n_routed_experts, config.moe_intermediate_size
            layers["router_w"] = array(n_layers, h, e)
            if config.topk_method == "noaux_tc":
                layers["router_bias"] = torch.zeros((n_layers, e), dtype=torch.float32, device=device)
            layers["e_gate"] = array(n_layers, e, h, f)
            layers["e_up"] = array(n_layers, e, h, f)
            layers["e_down"] = array(n_layers, e, f, h)
            if config.n_shared_experts > 0:
                sf = f * config.n_shared_experts
                layers["shared_gate"] = stacked(n_layers, h, sf)
                layers["shared_up"] = stacked(n_layers, h, sf)
                layers["shared_down"] = stacked(n_layers, sf, h)
        else:
            layers["w_gate"] = stacked(n_layers, h, config.intermediate_size)
            layers["w_up"] = stacked(n_layers, h, config.intermediate_size)
            layers["w_down"] = stacked(n_layers, config.intermediate_size, h)
        return layers

    n_dense = config.num_layers if config.n_routed_experts == 0 else min(
        config.first_k_dense_replace, config.num_layers
    )
    return {
        "embedding": normal(config.vocab_size, h, dtype=config.dtype),
        "layers_dense": make_stack(n_dense, moe=False),
        "layers_moe": make_stack(config.num_layers - n_dense, moe=True),
        "final_norm": torch.ones((h,), dtype=config.dtype, device=device),
        "lm_head": quantize_linear(normal(h, config.vocab_size), quant_mode, **quant_kwargs),
        "rope_cache": deepseek_rope_cache(config, device),
    }


_PROJECTIONS = (
    "wq", "wq_a", "wq_b", "w_kv_a", "wo", "w_gate", "w_up", "w_down", "shared_gate", "shared_up", "shared_down",
)


def requantize_deepseek_params(params: dict, config: DeepseekV2Config, quant_mode: str, group_size: int = 32) -> dict:
    """Rebuild every projection of a dense (bf16) DeepSeek param tree in
    ``quant_mode``, as ``conch_tpu.models.deepseek.requantize_deepseek_params``
    does: each stacked projection quantized layer by layer on its device from
    the float32 values of its weights, ``group_size`` to int4 and int8 (the
    defaults to the others). ``lm_head`` goes to the same mode, except int4,
    where it stays bf16 dense (the native int4 init quantizes it; the JAX
    package's requantization keeps it dense, and so does the port's). The
    absorbed ``w_uk``/``w_uv`` and the expert stacks stay dense."""
    if quant_mode not in QUANT_MODES:
        msg = f"Unknown quantization mode: {quant_mode}"
        raise ValueError(msg)
    kwargs = {"group_size": group_size} if quant_mode in ("int4", "int8") else {}

    def requant(w: torch.Tensor, mode: str, **kw) -> QuantizedLinear:
        return quantize_linear(w.to(torch.float32), mode, **kw)

    def dense_weight(ql: QuantizedLinear) -> torch.Tensor:
        if ql.kind != "dense":
            msg = f"requantize needs dense params, got {ql.kind}"
            raise ValueError(msg)
        return ql.arrays["w"]

    out = dict(params)
    for stack_name in ("layers_dense", "layers_moe"):
        if params.get(stack_name) is None:
            continue
        layers = dict(params[stack_name])
        for name in _PROJECTIONS:
            if name in layers:
                w = dense_weight(layers[name])
                layers[name] = stack_layers(lambda i, w=w: requant(w[i], quant_mode, **kwargs), w.shape[0])
        out[stack_name] = layers
    head_mode = "bf16" if quant_mode == "int4" else quant_mode
    out["lm_head"] = requant(dense_weight(params["lm_head"]), head_mode, **(kwargs if head_mode == "int8" else {}))
    return out


def deepseek_params_from_jax(
    numpy_tree: dict, config: DeepseekV2Config, device: str | torch.device | None = None
) -> dict:
    """Carry a JAX DeepSeek param tree (``conch_tpu.models.deepseek.init_deepseek_params``
    output, arrays turned into numpy; a missing stack is None) over to the
    port's params, bit for bit (``tree_from_jax``)."""
    params = tree_from_jax({k: v for k, v in numpy_tree.items() if v is not None}, device)
    for name in ("layers_dense", "layers_moe"):
        params.setdefault(name, None)
    if tuple(params["rope_cache"].shape) != (config.max_position, config.qk_rope_head_dim):
        msg = f"rope_cache {tuple(params['rope_cache'].shape)} does not match the config"
        raise ValueError(msg)
    return params


_FUSION_GROUPS = (
    ("wq_kva", ("wq_a", "w_kv_a")),
    ("wq_kva", ("wq", "w_kv_a")),
    ("w_gateup", ("w_gate", "w_up")),
    ("shared_gateup", ("shared_gate", "shared_up")),
)


def fuse_deepseek_params(params: dict) -> dict:
    """Column-fuse the projections that share an input (one-time), per
    stack, as the JAX package does:

    - ``wq_kva`` = [wq_a|w_kv_a] (q-LoRA) or [wq|w_kv_a] (full-rank q);
    - ``w_gateup`` = [w_gate|w_up] (dense-MLP layers);
    - ``shared_gateup`` = [shared_gate|shared_up] (MoE shared experts).

    Pieces that cannot fuse stay as they are.
    """
    out = dict(params)
    for stack_name in ("layers_dense", "layers_moe"):
        layers = params.get(stack_name)
        if layers is None:
            continue
        layers = dict(layers)
        for fused_name, parts in _FUSION_GROUPS:
            if fused_name in layers or not all(isinstance(layers.get(p), QuantizedLinear) for p in parts):
                continue
            try:
                fused = QuantizedLinear.concat_n([layers[p] for p in parts])
            except ValueError:
                continue
            layers[fused_name] = fused
            for p in parts:
                del layers[p]
        out[stack_name] = layers
    return out


def init_deepseek_kv_cache(
    config: DeepseekV2Config, num_pages: int, page_size: int, dtype: torch.dtype | None = None,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """The stacked (L, P, ps, packed) latent cache on ``device`` (None: CUDA)."""
    return torch.zeros(
        (config.num_layers, num_pages, page_size, config.kv_packed_dim),
        dtype=dtype or config.dtype, device=resolve_device(device),
    )


# -- forward ---------------------------------------------------------------


def _mla_layer_step(
    config: DeepseekV2Config,
    layers: dict,
    li: int,
    hidden: torch.Tensor,
    kv_cache: torch.Tensor,  # (P, ps, packed): this layer's cache, updated in place
    cos: torch.Tensor,
    sin: torch.Tensor,
    slot_mapping: torch.Tensor,
    cu_seqlens_q: torch.Tensor,
    max_seqlen_q: int,
    seq_lens: torch.Tensor,
    block_tables: torch.Tensor,
    mlp_fn,
) -> torch.Tensor:
    """One decoder layer (absorbed MLA attention + residual MLP), layer
    ``li`` of the stack ``layers``."""
    nope, rope_d = config.qk_nope_head_dim, config.qk_rope_head_dim
    lora, v_dim = config.kv_lora_rank, config.v_head_dim
    packed = config.kv_packed_dim
    eps = config.rms_norm_eps
    nh = layers["w_uk"].shape[1]
    t = hidden.shape[0]

    x = rms_norm(hidden, layers["input_norm"][li], eps)
    if "wq_kva" in layers:
        # Fused [wq_a|w_kv_a] (q-LoRA) or [wq|w_kv_a]: one wide-N GEMM
        # feeds the query path and the latent KV projection.
        head = config.q_lora_rank if config.q_lora_rank else nh * (nope + rope_d)
        both = layers["wq_kva"].apply_stacked(x, li)
        q_part, kv_a = both[:, :head], both[:, head:]
        if config.q_lora_rank:
            q = layers["wq_b"].apply_stacked(rms_norm(q_part, layers["q_a_norm"][li], eps), li)
        else:
            q = q_part
    else:
        if config.q_lora_rank:
            qa = rms_norm(layers["wq_a"].apply_stacked(x, li), layers["q_a_norm"][li], eps)
            q = layers["wq_b"].apply_stacked(qa, li)
        else:
            q = layers["wq"].apply_stacked(x, li)
        kv_a = layers["w_kv_a"].apply_stacked(x, li)  # (T, lora + rope)
    q = q.reshape(t, nh, nope + rope_d)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    q_pe = _apply_rope_interleaved(q_pe.float(), cos[:, None, :], sin[:, None, :]).to(q.dtype)

    c_kv = rms_norm(kv_a[:, :lora], layers["kv_a_norm"][li], eps)
    k_pe = _apply_rope_interleaved(kv_a[:, lora:].float(), cos, sin).to(kv_a.dtype)

    # Absorbed query: q_lat[h] = q_nope[h] @ W_uk[h] -> latent space.
    q_lat = torch.einsum("thn,hnl->thl", q_nope.float(), layers["w_uk"][li].float()).to(q.dtype)
    pad = packed - lora - rope_d
    q_cat = torch.cat([q_lat, q_pe, q.new_zeros((t, nh, pad))], dim=-1)
    kv_row = torch.cat([c_kv, k_pe, c_kv.new_zeros((t, pad))], dim=-1)
    quantized = kv_cache.dtype in QUANTIZED_CACHE_DTYPES
    reshape_and_cache_mla(kv_row, kv_cache, slot_mapping, scale=config.kv_cache_scale if quantized else None)

    out_lat = mla_attention(
        q_cat, kv_cache, cu_seqlens_q, max_seqlen_q, seq_lens, block_tables,
        scale=config.attention_scale(), latent=lora, kv_scale=config.kv_cache_scale if quantized else 1.0,
    )
    attn = torch.einsum("thl,hlv->thv", out_lat.float(), layers["w_uv"][li].float()).to(hidden.dtype)
    hidden = hidden + layers["wo"].apply_stacked(attn.reshape(t, nh * v_dim), li)

    mlp_in = rms_norm(hidden, layers["post_attn_norm"][li], eps)
    return hidden + mlp_fn(layers, li, mlp_in, config)


def _check_unported(tp_axis, lora) -> None:
    if tp_axis is not None:
        msg = "tensor parallelism is not ported yet (ROADMAP Queue 1, item 8)"
        raise NotImplementedError(msg)
    if lora is not None:
        msg = ("DeepSeek takes no LoRA adapters (the JAX package's DeepSeek steps have none); "
               "LoRA serves the Llama family")
        raise NotImplementedError(msg)


def _deepseek_forward(
    params, config, token_ids, positions, cu_seqlens_q, max_seqlen_q, seq_lens, block_tables, slot_mapping,
    kv_caches,
) -> torch.Tensor:
    """Shared trunk: the per-token hidden states; the caches updated in place."""
    hidden = params["embedding"][token_ids.long()]
    cs = params["rope_cache"][positions.long()]  # (T, rope_d) [cos|sin]
    half = config.qk_rope_head_dim // 2
    cos, sin = cs[:, :half], cs[:, half:]
    layer = 0
    for stack_name, mlp_fn in (("layers_dense", _dense_mlp), ("layers_moe", _moe_mlp)):
        layers = params[stack_name]
        if layers is None:
            continue
        for li in range(layers["input_norm"].shape[0]):
            hidden = _mla_layer_step(
                config, layers, li, hidden, kv_caches[layer], cos, sin, slot_mapping, cu_seqlens_q, max_seqlen_q,
                seq_lens, block_tables, mlp_fn,
            )
            layer += 1
    return hidden


def _logits(params: dict, config: DeepseekV2Config, hidden: torch.Tensor) -> torch.Tensor:
    hidden = rms_norm(hidden, params["final_norm"], config.rms_norm_eps)
    return params["lm_head"].apply(hidden).float()


def deepseek_prefill(
    params: dict,
    config: DeepseekV2Config,
    token_ids: torch.Tensor,  # (total_tokens,)
    positions: torch.Tensor,  # (total_tokens,) int32
    cu_seqlens_q: torch.Tensor,  # (batch+1,) int32
    max_seqlen_q: int,
    seq_lens: torch.Tensor,  # (batch,) int32
    block_tables: torch.Tensor,  # (batch, max_pages) int32
    slot_mapping: torch.Tensor,  # (total_tokens,) int32, -1 = padding
    k_caches: torch.Tensor,  # (L, P, ps, packed) latent cache, updated in place
    v_caches: torch.Tensor,  # unused placeholder (the engine's two-cache signature)
    tp_axis: str | None = None,
    lora: dict | None = None,
    lora_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill (chunked ok): (last-token logits per sequence (batch, vocab)
    f32, k_caches, v_caches untouched)."""
    _check_unported(tp_axis, lora)
    hidden = _deepseek_forward(
        params, config, token_ids, positions, cu_seqlens_q, max_seqlen_q, seq_lens, block_tables, slot_mapping,
        k_caches,
    )
    last_rows = (cu_seqlens_q[1:] - 1).long()
    return _logits(params, config, hidden[last_rows]), k_caches, v_caches


def deepseek_verify_forward(
    params: dict,
    config: DeepseekV2Config,
    token_ids: torch.Tensor,  # (total_tokens,)
    positions: torch.Tensor,  # (total_tokens,) int32
    cu_seqlens_q: torch.Tensor,  # (batch+1,) int32
    max_seqlen_q: int,
    seq_lens: torch.Tensor,  # (batch,) int32
    block_tables: torch.Tensor,  # (batch, max_pages) int32
    slot_mapping: torch.Tensor,  # (total_tokens,) int32, -1 = padding
    k_caches: torch.Tensor,  # (L, P, ps, packed) latent cache, updated in place
    v_caches: torch.Tensor,  # unused placeholder (the engine's two-cache signature)
    tp_axis: str | None = None,
    lora: dict | None = None,
    lora_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Speculative verification: logits for EVERY row ((total_tokens,
    vocab) f32), k_caches, v_caches untouched."""
    _check_unported(tp_axis, lora)
    hidden = _deepseek_forward(
        params, config, token_ids, positions, cu_seqlens_q, max_seqlen_q, seq_lens, block_tables, slot_mapping,
        k_caches,
    )
    return _logits(params, config, hidden), k_caches, v_caches


def deepseek_decode_step(
    params: dict,
    config: DeepseekV2Config,
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
    """One decode step: varlen MLA with one query per sequence. Returns
    (logits (batch, vocab) f32, k_caches, v_caches)."""
    _check_unported(tp_axis, lora)
    batch = token_ids.shape[0]
    cu = torch.arange(batch + 1, dtype=torch.int32, device=token_ids.device)
    hidden = _deepseek_forward(
        params, config, token_ids, positions, cu, 1, seq_lens, block_tables, slot_mapping, k_caches,
    )
    return _logits(params, config, hidden), k_caches, v_caches
