# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""The dtype rules the card's wrappers check before a launch, held on the
CPU (the checks are plain Python over tensors' dtypes and shapes).

- K2, K3 and K7 (``check_kv_dtypes``): f32 activations over f32, bf16,
  int8 or e4m3 caches; bf16 and f16 ones over their own type, int8 or
  e4m3; both caches of one dtype. Every other pair raises
  ``NotImplementedError`` naming the rule.
- K1 (``check_magic_dtypes``): bf16 x over bf16 scales, f16 x over bf16,
  f16 or f32 scales, int32 words; outputs f32, bf16 or f16. K1b and K1c
  keep bf16 x and f32 or bf16 outputs, and K11 bf16 or f32 queries
  (``dtype_code``'s default), so f16 still raises there.
"""

import itertools

import pytest
import torch

from conch_tpu_torch.kernels.common import COMPUTE_DTYPES, KV_DTYPE_PAIRS, check_kv_dtypes, dtype_code
from conch_tpu_torch.kernels.quantization.gemm import (
    KERNEL_OUT_DTYPES,
    MAGIC_OUT_DTYPES,
    MAGIC_SCALE_DTYPES,
    _check_x,
    _out_dtype,
    check_magic_dtypes,
)
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

FLOATS = (torch.float32, torch.bfloat16, torch.float16)
CACHES = (*FLOATS, torch.int8, torch.float8_e4m3fn)
ADMITTED_KV = {
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16), (torch.float32, torch.int8),
    (torch.float32, torch.float8_e4m3fn), (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8),
    (torch.bfloat16, torch.float8_e4m3fn), (torch.float16, torch.float16), (torch.float16, torch.int8),
    (torch.float16, torch.float8_e4m3fn),
}


def _t(dtype: torch.dtype, *shape: int) -> torch.Tensor:
    return torch.zeros(shape or (2, 8), dtype=dtype)


def test_kv_pairs_are_the_kernels():
    assert {(a, c) for a, cs in KV_DTYPE_PAIRS.items() for c in cs} == ADMITTED_KV


@pytest.mark.parametrize("act,cache", list(itertools.product(FLOATS, CACHES)))
def test_kv_rule(act, cache):
    q, kc = _t(act, 2, 4, 8), _t(cache, 1, 2, 1, 16, 8)
    if (act, cache) in ADMITTED_KV:
        check_kv_dtypes("attention", q, kc, kc.clone())
        return
    with pytest.raises(NotImplementedError, match="float16 over float16, int8, float8_e4m3fn"):
        check_kv_dtypes("attention", q, kc, kc.clone())


@pytest.mark.parametrize("act", FLOATS)
def test_kv_rule_needs_one_cache_dtype(act):
    kc = _t(torch.int8, 1, 2, 1, 16, 8)
    with pytest.raises(NotImplementedError, match="reshape_and_cache_stacked"):
        check_kv_dtypes("reshape_and_cache_stacked", _t(act, 2, 1, 8), kc, _t(torch.float8_e4m3fn, 1, 2, 1, 16, 8))


@pytest.mark.parametrize("x,scales", list(itertools.product(FLOATS, FLOATS)))
def test_magic_rule(x, scales):
    words = _t(torch.int32, 1, 8)
    admitted = x == torch.bfloat16 and scales == torch.bfloat16 or x == torch.float16
    if admitted:
        check_magic_dtypes(_t(x), _t(scales, 1, 8), words)
        return
    with pytest.raises(NotImplementedError, match="mixed_gemm_magic"):
        check_magic_dtypes(_t(x), _t(scales, 1, 8), words)


def test_magic_rule_names_the_scales_and_words():
    with pytest.raises(NotImplementedError, match="bfloat16 or float16 or float32 scales"):
        check_magic_dtypes(_t(torch.float16), _t(torch.float16, 1, 8), _t(torch.int8, 1, 8))
    assert set(MAGIC_SCALE_DTYPES[torch.float16]) == set(FLOATS)


@pytest.mark.parametrize("out", [*FLOATS, None])
@pytest.mark.parametrize("x", [torch.bfloat16, torch.float16])
def test_output_rules(x, out):
    """K1 stores f32, bf16 and f16 (x's dtype by default); K1b and K1c f32
    and bf16 only."""
    assert _out_dtype("mixed_gemm_magic", _t(x), out, MAGIC_OUT_DTYPES) == (out or x)
    if (out or x) in KERNEL_OUT_DTYPES:
        assert _out_dtype("mixed_gemm_planar", _t(x), out) == (out or x)
    else:
        with pytest.raises(NotImplementedError, match="float32 or bfloat16 outputs"):
            _out_dtype("mixed_gemm_planar", _t(x), out)


def test_planar_rows_and_mla_refuse_f16():
    """K1b and K1c take bf16 x only; K11's dtype code takes f32 and bf16."""
    for name in ("mixed_gemm_planar", "mixed_gemm_rows"):
        with pytest.raises(NotImplementedError, match="x must be bfloat16"):
            _check_x(name, _t(torch.float16))
        _check_x(name, _t(torch.bfloat16))
    with pytest.raises(NotImplementedError, match="float16"):
        dtype_code(_t(torch.float16), COMPUTE_DTYPES)
