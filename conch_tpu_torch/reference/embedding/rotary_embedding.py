# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Golden reference for rotary embedding, and the cos/sin cache builder.

Counterpart of ``conch_tpu/reference/embedding/rotary_embedding.py``.
The cache is built in numpy exactly as the JAX package builds it, so both
packages rotate by the same f32 table.
"""

from __future__ import annotations

import numpy as np
import torch


def compute_cos_sin_cache(
    base: float,
    rotary_dim: int,
    max_position_embeddings: int,
    rope_scaling: dict | None = None,
    device: str | torch.device = "cpu",
) -> torch.Tensor:
    """Build the f32 [cos | sin] cache, shape (max_position, rotary_dim).

    ``rope_scaling`` supports the HF "llama3" scheme (Llama-3.1+):
    frequencies below the low-frequency threshold stretch by ``factor``,
    those above the high-frequency threshold stay, and the band between
    interpolates smoothly.
    """
    inv_freq = 1.0 / (base ** (np.arange(0, rotary_dim, 2, dtype=np.float32) / rotary_dim))
    if rope_scaling is not None:
        if rope_scaling.get("rope_type", rope_scaling.get("type")) != "llama3":
            msg = f"unsupported rope_scaling: {rope_scaling}"
            raise ValueError(msg)
        factor = rope_scaling["factor"]
        low = rope_scaling.get("low_freq_factor", 1.0)
        high = rope_scaling.get("high_freq_factor", 4.0)
        old_ctx = rope_scaling.get("original_max_position_embeddings", 8192)
        wavelen = 2 * np.pi / inv_freq
        low_wavelen = old_ctx / low
        high_wavelen = old_ctx / high
        scaled = np.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
        smooth = (old_ctx / wavelen - low) / (high - low)
        mid = (1 - smooth) / factor * inv_freq + smooth * inv_freq
        in_band = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
        inv_freq = np.where(in_band, mid, scaled).astype(np.float32)
    t = np.arange(max_position_embeddings, dtype=np.float32)
    freqs = np.einsum("i,j->ij", t, inv_freq)
    cache = np.concatenate([np.cos(freqs), np.sin(freqs)], axis=-1)
    return torch.from_numpy(np.ascontiguousarray(cache)).to(device)


def rotary_embedding(
    positions: torch.Tensor,
    query: torch.Tensor,
    key: torch.Tensor,
    cos_sin_cache: torch.Tensor,
    rotary_dim: int,
    head_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Golden NeoX rotation, computed in the inputs' dtype (as the JAX
    reference does)."""
    cos_sin = cos_sin_cache[positions.reshape(-1).long()]
    half = cos_sin.shape[-1] // 2
    cos, sin = cos_sin[:, None, :half], cos_sin[:, None, half:]

    def rotate(x: torch.Tensor) -> torch.Tensor:
        xh = x.reshape(x.shape[0], -1, head_size)
        c, s = cos.to(x.dtype), sin.to(x.dtype)
        x1, x2 = xh[..., : rotary_dim // 2], xh[..., rotary_dim // 2 : rotary_dim]
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s, xh[..., rotary_dim:]], dim=-1)
        return out.reshape(x.shape)

    return rotate(query), rotate(key)
