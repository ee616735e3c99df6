# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""How far w8a8's logits move under rounding noise, beside int8's and bf16's.

    python3 -m conch_tpu_torch.tools.w8a8_sensitivity

Runs on the CPU (the plain versions). w8a8 rounds every projection's input
to whole int8 steps per row, so a difference of one ulp before it can flip
a code at a half-way point, and the flips spread through the layers. The
tool shows by how much, on a 2-layer Llama (hidden 1024, 8 query heads
over 2 KV heads of 128, intermediate 3584, vocab 32000, random weights
from seed 0) and one prefill of two prompts (24 and 13 tokens), for each
weight format:

- the logits with bf16 activations against f32 activations;
- the f32 logits with one ulp of random noise (x (1 + {-1, 0, 1} * 2^-23))
  on every norm's output against the f32 logits without it;

each as max |difference| / max |logit|. These set the w8a8 tolerances of
``chip_smoke.py``'s 2-layer prefill check and of
``tests/test_torch_llama_quant.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from conch_tpu_torch.models import llama
from conch_tpu_torch.models.llama import (
    LlamaConfig,
    fuse_llama_params,
    init_kv_caches,
    init_llama_params,
    llama_prefill,
)

PS = 16
DIMS = {
    "vocab_size": 32000, "hidden_size": 1024, "intermediate_size": 3584, "num_layers": 2,
    "num_heads": 8, "num_kv_heads": 2, "head_dim": 128,
}


def _inputs() -> list[torch.Tensor]:
    rng = np.random.default_rng(0)
    q_lens, rows, batch = [24, 13], 48, 4
    total = sum(q_lens)
    tokens = np.zeros(rows, np.int32)
    tokens[:total] = rng.integers(0, DIMS["vocab_size"], total)
    positions = np.zeros(rows, np.int32)
    positions[:total] = np.concatenate([np.arange(n) for n in q_lens])
    bt = np.zeros((batch, 8), np.int32)
    bt[0, :2], bt[1, :1] = [5, 0], [3]
    slots = np.full(rows, -1, np.int32)
    slots[:total] = [int(bt[b, p // PS]) * PS + p % PS for b, n in enumerate(q_lens) for p in range(n)]
    cu = np.array([0, q_lens[0], total, total, total], np.int32)
    seq_lens = np.array(q_lens + [0, 0], np.int32)
    return [torch.from_numpy(a) for a in (tokens, positions, cu, seq_lens, bt, slots)]


def prefill_logits(mode: str, dtype: torch.dtype, noise_seed: int | None = None) -> torch.Tensor:
    """First-token logits (f32) of the prefill in ``mode`` with activations
    in ``dtype``; ``noise_seed`` puts one ulp of noise on the norms."""
    cfg = LlamaConfig(**DIMS, dtype=dtype)
    params = fuse_llama_params(init_llama_params(0, cfg, quant_mode=mode, device="cpu"))
    kc, vc = init_kv_caches(cfg, 8, PS, device="cpu")
    t = _inputs()
    plain_norm = llama.rms_norm
    if noise_seed is not None:
        gen = torch.Generator().manual_seed(noise_seed)

        def noisy_norm(x, w, eps):
            y = plain_norm(x, w, eps)
            return y * (1 + torch.randint(-1, 2, y.shape, generator=gen).to(y.dtype) * 2.0**-23)

        llama.rms_norm = noisy_norm
    try:
        logits, _, _ = llama_prefill(params, cfg, t[0], t[1], t[2], 48, t[3], t[4], t[5], kc, vc)
    finally:
        llama.rms_norm = plain_norm
    return logits


def main() -> None:
    for mode in ("bf16", "int8", "w8a8"):
        ref = prefill_logits(mode, torch.float32)
        scale = ref.abs().max().item()
        dtype_shift = (prefill_logits(mode, torch.bfloat16) - ref).abs().max().item() / scale
        noise_shift = max((prefill_logits(mode, torch.float32, seed) - ref).abs().max().item() for seed in (1, 2, 3))
        print(f"{mode}: bf16 against f32 activations {dtype_shift:.4f} of max |logit| ({scale:.3f}); "
              f"one ulp of noise on the norms, worst of 3 seeds: {noise_shift / scale:.4f}", flush=True)


if __name__ == "__main__":
    main()
