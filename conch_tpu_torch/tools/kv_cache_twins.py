# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Serve each quantized-KV-cache path of ``chip_smoke.py`` beside its
bf16-cache twin, in turns, on one card.

    python3 -m conch_tpu_torch.tools.kv_cache_twins

Run from the checkout's root on one Hopper card (it builds the kernels and
reuses ``chip_smoke.py``'s configurations, prompts and profiler). For each
pair (the README's int4 Llama-3-8B over an int8 cache, bf16 Llama-3-8B
over an e4m3 cache, DeepSeek-V2-Lite over an e4m3 latent cache) the model
is drawn once from the seed and fused once; every call then builds a fresh
``LLMEngine`` on those weights with one cache or the other. One untimed
call of each first loads every kernel either path runs; then the two
alternate twin, quantized, quantized, twin, each ``generate`` timed on the
host clock between two synchronizes (32 greedy tokens a request). Last,
one profiled call of each: device busy time, idle share, top kernels.
Prints the generated tok/s of every timed call and each cache's mean.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch


def main() -> int:
    import chip_smoke as cs

    from conch_tpu_torch.models.deepseek import (
        DeepseekV2Config,
        deepseek_decode_step,
        deepseek_prefill,
        init_deepseek_params,
    )
    from conch_tpu_torch.models.llama import LlamaConfig, init_llama_params
    from conch_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams

    if not torch.cuda.is_available():
        print("kv_cache_twins: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card, flush=True)
    cs.build()
    max_tokens = 32
    llama_cfg, ds_cfg = LlamaConfig.llama3_8b(), DeepseekV2Config.v2_lite()
    ds_fns = {"prefill_fn": deepseek_prefill, "decode_fn": deepseek_decode_step}
    pairs = (
        ("llama3_8b_int4 / kv_int8", llama_cfg, lambda: init_llama_params(cs.SEED, llama_cfg, quant_mode="int4"),
         {}, {"num_pages": 4096, "max_batch_size": 32}, cs.int4_prompts, torch.int8),
        ("llama3_8b_bf16 / kv_fp8", llama_cfg, lambda: init_llama_params(cs.SEED, llama_cfg), {},
         {"page_size": 16, "num_pages": 2048, "max_batch_size": 8, "max_prefill_tokens": 128}, cs.bf16_prompts,
         torch.float8_e4m3fn),
        ("deepseek_v2_lite_bf16 / kv_fp8", ds_cfg, lambda: init_deepseek_params(cs.SEED, ds_cfg), ds_fns,
         {"num_pages": 4096, "max_batch_size": 16, "max_pages_per_seq": 128}, cs.deepseek_prompts,
         torch.float8_e4m3fn),
    )
    for label, cfg, make_params, fns, engine_kwargs, make_prompts, quant in pairs:
        ecfg = EngineConfig(**engine_kwargs)
        fused = LLMEngine(make_params(), cfg, ecfg, **fns).params  # drawn and fused once
        prompts = make_prompts(np.random.default_rng(cs.SEED), cfg.vocab_size)
        caches = {"bf16 cache": None, f"{str(quant).removeprefix('torch.')} cache": quant}

        def call(cache):
            engine = LLMEngine(fused, cfg, ecfg, cache_dtype=cache, **fns)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.generate(prompts, SamplingParams(max_tokens=max_tokens))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            del engine
            torch.cuda.empty_cache()
            return len(prompts) * max_tokens / seconds

        for cache in caches.values():
            call(cache)
        twin, quantized = caches
        rates: dict[str, list[float]] = {name: [] for name in caches}
        for name in (twin, quantized, quantized, twin):
            rates[name].append(call(caches[name]))
        for name, got in rates.items():
            print(f"{label}, {name}: generated tok/s {[round(r, 2) for r in got]}, mean {np.mean(got):.2f} on {card}",
                  flush=True)
        for name, cache in caches.items():
            cs.profile_served_run(fused, cfg, ecfg, {**fns, "cache_dtype": cache}, prompts, max_tokens,
                                  f"{label}, {name}")
        del fused
        torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
