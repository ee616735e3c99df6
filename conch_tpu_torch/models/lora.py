# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Multi-LoRA serving for the Llama family (counterpart of ``conch_tpu/models/lora.py``).

A low-rank adapter adds ``scale * (x @ A) @ B`` to selected projections.
Adapters are stacked on an adapter axis and every token may pick its own
(or none, id -1). The delta is the JAX package's dense one-hot dispatch:

    h     = einsum('tk,akr->tar', x, A)          # every adapter
    h_sel = h * (one_hot(lora_ids) * scales)     # zero the others
    delta = einsum('tar,arn->tn', h_sel, B)      # sums over a and r

Both contractions run in the input's dtype; the second returns f32, as
JAX's ``preferred_element_type``. They are library matmuls, as JAX leaves
them to XLA (no Pallas kernel computes them). ``lora_from_jax`` carries a
stacked set drawn by the JAX package across, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from conch_tpu_torch.models.linear import QuantizedLinear
from conch_tpu_torch.platforms import resolve_device

# Projections an adapter can target, with (in_dim, out_dim) resolvers.
_TARGET_DIMS = {
    "wq": lambda c: (c.hidden_size, c.num_heads * c.head_dim),
    "wk": lambda c: (c.hidden_size, c.num_kv_heads * c.head_dim),
    "wv": lambda c: (c.hidden_size, c.num_kv_heads * c.head_dim),
    "wo": lambda c: (c.num_heads * c.head_dim, c.hidden_size),
    "w_gate": lambda c: (c.hidden_size, c.intermediate_size),
    "w_up": lambda c: (c.hidden_size, c.intermediate_size),
    "w_down": lambda c: (c.intermediate_size, c.hidden_size),
}

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo")


def init_lora_adapter(
    seed: int, config, rank: int = 8, alpha: float = 16.0, targets: tuple[str, ...] = DEFAULT_TARGETS,
    dtype: torch.dtype | None = None, zero_b: bool = False, device: str | torch.device | None = None,
) -> dict:
    """Random-initialize one adapter on ``device`` (None: CUDA), from the
    JAX package's numpy draws, so that both give the same adapter from a
    seed: ``{"layers": {target: {"a": (L, K, r), "b": (L, r, N)}}, "scale":
    alpha / rank}``. ``zero_b`` gives the training init (a zero delta)."""
    rng = np.random.default_rng(seed)
    dtype = dtype or config.dtype
    device = resolve_device(device)
    layers = {}
    for name in targets:
        if name not in _TARGET_DIMS:
            msg = f"unknown LoRA target {name!r}; supported: {sorted(_TARGET_DIMS)}"
            raise ValueError(msg)
        k_dim, n_dim = _TARGET_DIMS[name](config)
        a = rng.normal(size=(config.num_layers, k_dim, rank)) * (1.0 / np.sqrt(k_dim))
        b = (
            np.zeros((config.num_layers, rank, n_dim))
            if zero_b
            else rng.normal(size=(config.num_layers, rank, n_dim)) * 0.02
        )
        layers[name] = {"a": _from_f64(a, dtype, device), "b": _from_f64(b, dtype, device)}
    return {"layers": layers, "scale": float(alpha) / float(rank)}


def _from_f64(a: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """An f64 draw in ``dtype``, rounded as JAX rounds it: to f32 first (JAX
    holds no f64 arrays), then to ``dtype``."""
    return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dtype)


def stack_lora_adapters(adapters: list[dict]) -> dict:
    """Stack single adapters into the serving set the model steps take:
    ``{"layers": {target: {"a": (L, A, K, r_max), "b": (L, A, r_max, N)}},
    "scales": (A,) f32}``. Ranks are zero-padded to the largest; a target an
    adapter lacks is zeros."""
    if not adapters:
        msg = "need at least one adapter"
        raise ValueError(msg)
    all_targets: dict[str, tuple[int, int]] = {}
    for ad in adapters:
        for name, ab in ad["layers"].items():
            k_dim, n_dim = ab["a"].shape[-2], ab["b"].shape[-1]
            prev = all_targets.setdefault(name, (k_dim, n_dim))
            if prev != (k_dim, n_dim):
                msg = f"adapter dim mismatch for target {name!r}: {prev} vs {(k_dim, n_dim)}"
                raise ValueError(msg)
    r_max = max(ab["a"].shape[-1] for ad in adapters for ab in ad["layers"].values())
    layers: dict = {}
    for name, (k_dim, n_dim) in sorted(all_targets.items()):
        a_rows, b_rows = [], []
        for ad in adapters:
            ab = ad["layers"].get(name)
            if ab is None:
                ref = next(iter(ad["layers"].values()))["a"]
                a_rows.append(ref.new_zeros((ref.shape[0], k_dim, r_max)))
                b_rows.append(ref.new_zeros((ref.shape[0], r_max, n_dim)))
                continue
            pad = r_max - ab["a"].shape[-1]
            a_rows.append(F.pad(ab["a"], (0, pad)))
            b_rows.append(F.pad(ab["b"], (0, 0, 0, pad)))
        layers[name] = {"a": torch.stack(a_rows, dim=1), "b": torch.stack(b_rows, dim=1)}
    device = next(iter(layers.values()))["a"].device
    scales = torch.tensor([ad["scale"] for ad in adapters], dtype=torch.float32, device=device)
    return {"layers": layers, "scales": scales}


def lora_from_jax(numpy_set: dict, device: str | torch.device | None = None) -> dict:
    """Carry a stacked adapter set of the JAX package
    (``conch_tpu.models.lora.stack_lora_adapters`` output, arrays turned
    into numpy) over to ``device``, bit for bit (``tree_from_jax``)."""
    from conch_tpu_torch.models.llama import tree_from_jax  # llama imports this module

    return tree_from_jax(numpy_set, device)


def lora_selector(lora_ids: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(T,) adapter ids (-1: none) -> (T, A) f32 scaled one-hot selector;
    an id outside [0, A) gives a zero row, as JAX's ``one_hot``."""
    adapters = torch.arange(scales.shape[0], device=lora_ids.device)
    return (lora_ids.long()[:, None] == adapters[None, :]).float() * scales.float()[None, :]


def _f32_product(h: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h @ b`` summed and returned in f32 without rounding to the inputs'
    dtype (JAX's ``preferred_element_type=f32``): on the card a bf16
    product writes f32 directly, the CPU casts both sides (bf16 products
    are exact in f32)."""
    if h.is_cuda and h.dtype != torch.float32:
        return torch.mm(h, b, out_dtype=torch.float32)
    return h.float() @ b.float()


def lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, sel_scaled: torch.Tensor) -> torch.Tensor:
    """Batched multi-adapter delta, f32. x (T, K); a (A, K, r); b (A, r, N);
    sel_scaled (T, A)."""
    h = torch.einsum("tk,akr->tar", x, a.to(x.dtype))
    h = (h.float() * sel_scaled[:, :, None]).to(x.dtype)
    return _f32_product(h.reshape(h.shape[0], -1), b.to(x.dtype).reshape(-1, b.shape[-1]))


def lora_delta_single(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, scale: float) -> torch.Tensor:
    """Single-adapter delta (the training path: one adapter, every token),
    f32. x (T, K); a (K, r); b (r, N); the contractions in x's dtype, the
    scale in f32."""
    h = x @ a.to(x.dtype)
    return _f32_product(h, b.to(x.dtype)) * scale


def merge_lora_into_params(params: dict, adapter: dict, config=None) -> dict:
    """Fold ONE adapter into dense Llama params: ``w += scale * (A @ B)`` in
    f32, cast back to w's dtype (the offline single-adapter path, and the
    oracle of the multi-LoRA tests). Needs dense projections."""
    layers = dict(params["layers"])
    scale = adapter["scale"]
    for name, ab in adapter["layers"].items():
        ql = layers[name]
        if not isinstance(ql, QuantizedLinear) or ql.kind != "dense":
            msg = f"merge_lora_into_params needs dense weights, got {getattr(ql, 'kind', type(ql))} for {name}"
            raise ValueError(msg)
        w = ql.arrays["w"]  # (L, K, N) stacked
        delta = torch.einsum("lkr,lrn->lkn", ab["a"].float(), ab["b"].float()) * scale
        layers[name] = QuantizedLinear("dense", {"w": (w.float() + delta).to(w.dtype)}, dict(ql.meta))
    return {**params, "layers": layers}
