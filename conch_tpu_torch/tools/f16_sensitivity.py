# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""How far f16's logits move from f32's, beside bf16's: the ratio that sets
the f16 tolerances of ``chip_smoke.py``'s 2-layer prefill check.

    python3 -m conch_tpu_torch.tools.f16_sensitivity

Runs on the CPU (the plain versions). The card-against-CPU prefill check
holds bf16 logits at 3e-2 x max |logit|; card and CPU differ by where and
in what order they round, and that rounding scales with the activation
type's unit roundoff. The tool takes a Qwen2-shaped 2-layer int4 model
(hidden 896, 14 query heads over 2 KV heads of 128 (Qwen2-7B's group 7),
intermediate 4864, vocab 8192, q/k/v biases; random weights from seed 0)
and one prefill of two prompts (24 and 13 tokens, the check's step), and
prints, over a 16-bit KV cache and over an int8 one, max |logits - f32
logits| / max |f32 logits| with activations (and int4 scales) in bf16 and
in f16, the f32 run using the same scales' values and cache type, and the
ratio f16 / bf16.
"""

from __future__ import annotations

import dataclasses

import torch

from conch_tpu_torch.models.llama import (
    LlamaConfig,
    fuse_llama_params,
    init_kv_caches,
    init_llama_params,
    llama_prefill,
)
from conch_tpu_torch.tools.w8a8_sensitivity import PS, _inputs

CONFIG = dataclasses.replace(
    LlamaConfig.qwen2_7b(), num_layers=2, hidden_size=896, intermediate_size=4864, num_heads=14, num_kv_heads=2,
    vocab_size=8192,
)


def prefill_logits(dtype: torch.dtype, scale_dtype: torch.dtype, cache: torch.dtype | None) -> torch.Tensor:
    """First-token logits (f32) of the prefill with activations in
    ``dtype``, int4 scales in ``scale_dtype`` and a KV cache of ``cache``
    (None: the activations' dtype)."""
    cfg = dataclasses.replace(CONFIG, dtype=dtype)
    params = fuse_llama_params(init_llama_params(0, cfg, quant_mode="int4", device="cpu", scale_dtype=scale_dtype))
    kc, vc = init_kv_caches(cfg, 8, PS, cache_dtype=cache, device="cpu")
    t = _inputs()
    t[0] = t[0] % cfg.vocab_size
    logits, _, _ = llama_prefill(params, cfg, t[0], t[1], t[2], 48, t[3], t[4], t[5], kc, vc)
    return logits.float()


def main() -> None:
    for cache in (None, torch.int8):
        shift = {}
        for dtype in (torch.bfloat16, torch.float16):
            ref = prefill_logits(torch.float32, dtype, cache)
            shift[dtype] = (prefill_logits(dtype, dtype, cache) - ref).abs().max().item() / ref.abs().max().item()
        print(f"KV cache {'16-bit' if cache is None else str(cache).removeprefix('torch.')}: against f32 "
              f"activations, bf16 {shift[torch.bfloat16]:.4f} and f16 {shift[torch.float16]:.4f} of max |logit|; "
              f"f16 / bf16 {shift[torch.float16] / shift[torch.bfloat16]:.3f}", flush=True)


if __name__ == "__main__":
    main()
