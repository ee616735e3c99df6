# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""The launch plan of K1 (magic), K1b (planar), K1c (GPTQ rows) and K8
(scaled int8, and float8_e4m3fn on the same mainloop), which the wrappers in
``conch_tpu_torch/kernels/quantization/gemm.py`` compute in Python and
hand to the CUDA entry points. Held on the CPU, for the Llama-3-8B engine
shapes (int4 fused at groups 64 and 128, nf4 unfused, int8 and w8a8 fused,
and lm_head), Qwen2-7B's int4 shapes (K 3584 and 18944), DeepSeek-V2-Lite's
int4 and int8 shapes at group 32 (K 2048, 2816 and 10944; w_kv_a's N 640)
and Gemma-2-2B's int4 shapes at M 1, 8, 32, 40 and 512, and for the small
shapes of the port's GEMM tests and K8's option sweep:

- the splits cover K's slices exactly once, in order, and every split
  starts on a group boundary; the K slice is the one the entry point's
  template takes, and the entry point gets the plan's numbers as they are;
- at M <= 32 every engine shape puts at least one block on each SM of a
  132-SM card;
- the plan refuses what the kernel refuses, with the wrappers' messages;
- x rows that do not suit the kernels' TMA copies are realigned, values
  unchanged (bf16 x, and K8's int8 a);
- K8's workspace holds int32 sums (exact; f32 would round above 2^24),
  its e4m3 plan f32 ones, with int8's rows a block and splits;
- K8's e4m3 shapes that the mainloop's TMA copies cannot take (N not a
  multiple of 16, b's layer off 16 bytes, K 0) go to the loop kernel;
- K1's A fragments, read from the magic packing as
  ``csrc/mixed_gemm_magic.cu`` reads them (at group 32 two groups a slice,
  two k16 steps a word), are x's k order within each group, and so are
  K1b's at 8 word rows a slice (``csrc/mixed_gemm_planar.cu``, SUB 8).
"""

import dataclasses
import math

import pytest
import torch

from conch_tpu_torch.kernels.quantization.gemm import (
    E4M3_LOOP_PLAN_ARGS,
    PLAN_ARGTYPES,
    QGEMM_COLS,
    _plan_args,
    _tma_rows,
    e4m3_takes_mainloop,
    quant_gemm_plan,
)
from conch_tpu_torch.utils.quant_utils import pack_rows_magic, pack_rows_planar
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

H100_SMS = 132
NF4_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)]  # (K, N), group 64
INT8_SHAPES = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096), (4096, 128256)]  # (K, N), group 128
INT4_SHAPES = INT8_SHAPES[:4]  # fused wqkv, wo, fused gate|up, w_down; groups 64 and 128
# Qwen2-7B's int4 GEMMs at group 128, as its engine runs them: the fused
# wqkv (3584 + 2 x 512), wo, w_gate and w_up apart (N 18944 padded at pack
# time to 20480, so they do not fuse) and w_down. K 3584 is 28 groups and
# 18944 is 148, both with few divisors.
QWEN2_SHAPES = [(3584, 4608), (3584, 3584), (3584, 20480), (18944, 3584)]
# DeepSeek-V2-Lite's GEMMs at group 32, as its engines run them. int4 (K1):
# wq, w_kv_a (N 576 padded at pack time to 640), wo, w_gate and w_up (N
# 10944 padded to 12288, so unfused), w_down (K 10944: 171 slices of two
# groups), the fused shared gate|up, shared_down (K 2816) and lm_head.
# int8 (K1b, nothing padded, all fused): [wq|w_kv_a], wo, gate|up, w_down,
# shared gate|up, shared_down, lm_head.
DEEPSEEK_INT4_SHAPES = [(2048, 3072), (2048, 640), (2048, 2048), (2048, 12288), (10944, 2048), (2048, 5632),
                        (2816, 2048), (2048, 102400)]
DEEPSEEK_INT8_SHAPES = [(2048, 3648), (2048, 2048), (2048, 21888), (10944, 2048), (2048, 5632), (2816, 2048),
                        (2048, 102400)]
# Gemma-2-2B's int4 GEMMs at group 128: fused wqkv, wo, fused gate|up, w_down.
GEMMA_SHAPES = [(2304, 4096), (2048, 2304), (2304, 18432), (9216, 2304)]
ENGINE_MS = [1, 8, 32, 40, 512]

# (layout, bits, group, K, N): the engine's, then the small shapes of
# tests/test_torch_rows_gemm.py, tests/test_torch_planar_gemm.py and
# tests/test_torch_int4_gemm.py.
ENGINE_CASES = (
    [("gptq", 4, 64, k, n) for k, n in NF4_SHAPES] + [("planar", 8, 128, k, n) for k, n in INT8_SHAPES]
    + [("magic", 4, g, k, n) for g in (128, 64) for k, n in INT4_SHAPES]
    + [("magic", 4, 128, k, n) for k, n in QWEN2_SHAPES]
    + [("magic", 4, 32, k, n) for k, n in DEEPSEEK_INT4_SHAPES]
    + [("planar", 8, 32, k, n) for k, n in DEEPSEEK_INT8_SHAPES]
    + [("magic", 4, 128, k, n) for k, n in GEMMA_SHAPES]
    + [("scaled", 8, 128, k, n) for k, n in INT8_SHAPES]
    + [("e4m3", 8, 128, k, n) for k, n in INT8_SHAPES]
)
SMALL_CASES = [
    ("magic", 4, 128, 256, 384), ("magic", 4, 128, 512, 256), ("magic", 4, 64, 256, 384), ("magic", 4, 64, 128, 32),
    *[("gptq", bits, 64, 512, 256) for bits in (2, 4, 8)],
    ("gptq", 4, 64, 256, 384), ("gptq", 4, 64, 256, 256), ("gptq", 4, 64, 128, 96), ("gptq", 8, 100, 300, 64),
    ("gptq", 4, 4, 256, 64), ("gptq", 2, 12, 192, 32),
    *[("planar", bits, 128 if bits >= 4 else 256, 512, 256) for bits in (2, 4, 8)],
    ("planar", 8, 128, 256, 384), ("planar", 8, 64, 512, 128), ("planar", 4, 256, 1024, 512),
    # 8 word rows a group (tests/gemm_test.py's cases of JAX's planar kernel), and magic at group 32.
    ("planar", 8, 32, 256, 384), ("planar", 4, 64, 512, 256), ("planar", 2, 128, 1024, 256), ("planar", 8, 96, 384, 64),
    ("magic", 4, 32, 416, 160), ("magic", 4, 32, 64, 32),
    ("scaled", 8, 128, 96, 160), ("scaled", 8, 128, 64, 32), ("scaled", 8, 128, 512, 256),
    # e4m3 takes any K >= 1 and N a multiple of 16 (chip_smoke's K8 sweep and phase shapes among them).
    ("e4m3", 8, 128, 96, 160), ("e4m3", 8, 128, 512, 256), ("e4m3", 8, 128, 1, 16), ("e4m3", 8, 128, 300, 48),
    ("e4m3", 8, 128, 14336, 4096),
]


def _k_slice(layout: str, bits: int, group: int) -> int:
    """K of a slice in the entry points' templates: 64 for GPTQ rows
    (RowsLayout::KS); one group for magic codes, two at group 32
    (MagicLayout::KS); planar codes a whole group of 128 for 4 and 8 bits at
    group 128, else 16 word rows where the group holds a multiple of 16,
    else 8 (PlanarLayout::KS); 128 for K8's int8 and e4m3 (ScaledLayout::KS)."""
    if layout == "gptq":
        return 64
    if layout in ("scaled", "e4m3"):
        return 128
    if layout == "magic":
        return 64 if group == 32 else group
    epp = 32 // bits
    if group == 128 and bits >= 4:
        return 128
    return 16 * epp if group % (16 * epp) == 0 else 8 * epp


@pytest.mark.parametrize("m", ENGINE_MS + [9, 33])
@pytest.mark.parametrize("case", ENGINE_CASES + SMALL_CASES, ids=lambda c: "-".join(map(str, c)))
def test_splits_cover_k_once_on_group_boundaries(case, m):
    layout, bits, group, k, n = case
    plan = quant_gemm_plan(layout, m, n, k, bits, group, H100_SMS)
    ks = _k_slice(layout, bits, group)
    assert plan.k_slice == ks
    assert plan.slices == math.ceil(k / ks) and plan.slices * ks >= k > (plan.slices - 1) * ks
    covered = []
    for split in range(plan.splits):
        s0, s1 = plan.split_slices(split)
        assert s0 < s1, f"split {split} of {plan.splits} is empty"
        assert (s0 * ks) % group == 0 or s0 == 0, f"split {split} starts at k {s0 * ks}, inside a group of {group}"
        covered.extend(range(s0, s1))
    assert covered == list(range(plan.slices))
    assert plan.grid == (math.ceil(n / QGEMM_COLS), math.ceil(m / plan.bn), plan.splits)
    assert plan.workspace_shape(m, n) == ((plan.splits, m, n) if plan.splits > 1 else None)
    assert (plan.unit * ks) % group == 0, "a unit ends on a group boundary (the entry point's plan_ok)"


@pytest.mark.parametrize("m", [8, 512])
@pytest.mark.parametrize(
    "case", [ENGINE_CASES[1], ENGINE_CASES[6], SMALL_CASES[3], ENGINE_CASES[-9], ENGINE_CASES[-4]],
    ids=lambda c: "-".join(map(str, c)),
)
def test_entry_point_gets_the_plan(case, m):
    """The entry point's plan arguments are the plan's own numbers, and the
    workspace is the splits' partial sums: f32, int32 for K8's int8 (its
    e4m3 sums are f32)."""
    layout, bits, group, k, n = case
    plan = quant_gemm_plan(layout, m, n, k, bits, group, H100_SMS)
    args, ws = _plan_args(plan, m, n, torch.device("cpu"))
    assert len(args) == len(PLAN_ARGTYPES)
    assert args[:5] == (plan.bn, plan.k_slice, plan.slices, plan.unit, plan.splits)
    if plan.splits > 1:
        want = torch.int32 if layout == "scaled" else torch.float32
        assert ws.dtype == want and tuple(ws.shape) == (plan.splits, m, n) and args[5] == ws.data_ptr()
    else:
        assert ws is None and args[5] == 0


@pytest.mark.parametrize("m", [m for m in ENGINE_MS if m <= 32])
@pytest.mark.parametrize("case", ENGINE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_decode_grid_fills_the_card(case, m):
    layout, bits, group, k, n = case
    plan = quant_gemm_plan(layout, m, n, k, bits, group, H100_SMS)
    blocks = math.prod(plan.grid)
    assert plan.bn == 32, "the engine's decode step (32 rows) takes the 32-row template"
    assert blocks >= H100_SMS, f"{blocks} blocks for {H100_SMS} SMs"


@pytest.mark.parametrize("m,bn", [(1, 32), (8, 32), (32, 32), (33, 64), (40, 64), (64, 64), (65, 128), (512, 128)])
@pytest.mark.parametrize(
    "layout,bits,group",
    [("gptq", 4, 64), ("planar", 8, 128), ("planar", 4, 128), ("magic", 4, 128), ("magic", 4, 64), ("scaled", 8, 128),
     ("e4m3", 8, 128)],
)
def test_rows_a_block(m, bn, layout, bits, group):
    """32 rows a block up to the engine's 32-row decode step, then 64, then
    128; 2- and 4-bit planar codes stop at 64. The x row-sum pre-pass runs
    only for K1b at 128 rows a block."""
    plan = quant_gemm_plan(layout, m, 4096, 4096, bits, group, H100_SMS)
    want = min(bn, 64) if layout == "planar" and bits < 8 else bn
    assert plan.bn == want
    assert plan.row_sums == (layout == "planar" and want == 128)


def test_prefill_takes_at_most_one_wave():
    """At 128 rows a block K is split only to fill one wave."""
    for layout, bits, group, k, n in ENGINE_CASES:
        plan = quant_gemm_plan(layout, 512, n, k, bits, group, H100_SMS)
        blocks = math.prod(plan.grid)
        assert plan.splits == 1 or blocks <= H100_SMS


@pytest.mark.parametrize(
    "layout,bits,group,k,n,error,match",
    [
        ("planar", 8, 128, 4000, 256, ValueError, "mixed_gemm_planar kernel: needs K % group == 0"),
        # Once refused, int8 at group 32 and 4-bit at 64 now run (8 word rows a
        # slice); what still refuses is a group of fewer (or not a multiple of
        # 8) word rows: int8 at 16, 4-bit at 32. The IDs are the old cases'.
        pytest.param("planar", 8, 16, 4096, 256, ValueError, r"group % 32 == 0 \(8 word rows of 8-bit codes\)",
                     id="planar-8-32-4096-256-ValueError-group % 64 == 0"),
        pytest.param("planar", 4, 32, 4096, 256, ValueError, r"group % 64 == 0 \(8 word rows of 4-bit codes\)",
                     id="planar-4-64-4096-256-ValueError-group % 128 == 0"),
        ("planar", 8, 128, 4096, 100, ValueError, "N % 32 == 0"),
        ("gptq", 4, 64, 4100, 256, ValueError, r"mixed_gemm_rows kernel: needs K % 8 == 0"),
        ("gptq", 4, 2, 4096, 256, ValueError, r"group % 4 == 0"),
        ("gptq", 8, 64, 4096, 48, ValueError, "N % 32 == 0"),
        # Once refused, magic at group 32 now runs; group 16 still refuses.
        pytest.param("magic", 4, 16, 4096, 256, ValueError,
                     r"mixed_gemm_magic kernel: needs 4-bit codes, group_size 32, 64 or 128",
                     id="magic-4-32-4096-256-ValueError-mixed_gemm_magic kernel: needs 4-bit codes, group_size 64 or 128"),
        ("magic", 4, 256, 4096, 256, ValueError, r"group=256"),
        ("magic", 4, 128, 4160, 256, ValueError, r"K a multiple of it"),
        ("magic", 4, 64, 4096, 48, ValueError, "N of 32"),
        ("magic", 8, 64, 4096, 256, ValueError, "bits=8"),
        ("scaled", 8, 128, 4112, 256, ValueError, r"scaled_gemm kernel: needs int8 operands and K and N multiples of 32"),
        ("scaled", 8, 128, 4096, 48, ValueError, "N=48"),
        ("scaled", 4, 128, 4096, 256, ValueError, "bits=4"),
        ("e4m3", 8, 128, 4096, 40, ValueError,
         r"scaled_gemm kernel: the e4m3 mainloop needs 8-bit operands, K >= 1 and N a multiple of 16"),
        ("e4m3", 8, 128, 4096, 4104, ValueError, r"b's rows 16-byte aligned for TMA\) \(bits=8, K=4096, N=4104\)"),
        ("e4m3", 8, 128, 0, 256, ValueError, "K=0"),
        ("e4m3", 4, 128, 4096, 256, ValueError, "bits=4"),
        ("awq", 4, 64, 4096, 256, ValueError, "no K1/K1b/K1c/K8 launch plan"),
    ],
)
def test_plan_refuses_what_the_kernel_refuses(layout, bits, group, k, n, error, match):
    with pytest.raises(error, match=match):
        quant_gemm_plan(layout, 8, n, k, bits, group, H100_SMS)


W8A8_SHAPES = INT8_SHAPES[:4]  # fused wqkv, wo, fused gate|up, w_down


@pytest.mark.parametrize("m", [1, 16, 17, 32, 40, 130, 512, 600])
@pytest.mark.parametrize("k,n", W8A8_SHAPES, ids=lambda v: str(v))
def test_e4m3_plan_is_int8s_with_f32_sums(k, n, m):
    """At the w8a8 shapes K8's e4m3 plan takes int8's rows a block, slices
    and splits (the same bytes, the same tensor-core rate), and its split
    sums are f32 where int8's are int32."""
    e4m3 = quant_gemm_plan("e4m3", m, n, k, 8, 128, H100_SMS)
    int8 = quant_gemm_plan("scaled", m, n, k, 8, 128, H100_SMS)
    assert dataclasses.replace(e4m3, int_sums=True) == int8
    assert not e4m3.int_sums and int8.int_sums
    for plan, want in ((e4m3, torch.float32), (int8, torch.int32)):
        _, ws = _plan_args(plan, m, n, torch.device("cpu"))
        assert (ws is None) == (plan.splits == 1)
        assert ws is None or ws.dtype == want


@pytest.mark.parametrize(
    "k,n,offset,mainloop",
    [
        (4096, 6144, 0, True), (14336, 4096, 0, True), (96, 160, 0, True), (97, 16, 0, True), (1, 16, 0, True),
        (96, 100, 0, False),  # N not a multiple of 16: b's rows off 16 bytes
        (96, 24, 0, False),
        (96, 160, 8, False),  # b's base off 16 bytes
        (96, 160, 16, True),
        (0, 32, 0, False),  # K 0: nothing to copy
    ],
)
def test_e4m3_loop_kernel_by_shape(k, n, offset, mainloop):
    """K8's e4m3 calls go to the mainloop where its TMA copies take b
    (``e4m3_takes_mainloop``), else to the loop kernel with the plan
    arguments that name it (bn 0); the plan refuses every shape that
    goes to the loop kernel for its N or K."""
    assert e4m3_takes_mainloop(k, n, 4096 + offset) == mainloop
    assert E4M3_LOOP_PLAN_ARGS[0] == 0 and len(E4M3_LOOP_PLAN_ARGS) == len(PLAN_ARGTYPES)
    if mainloop:
        quant_gemm_plan("e4m3", 8, n, k, 8, 128, H100_SMS)
    elif offset == 0:
        with pytest.raises(ValueError, match="the e4m3 mainloop needs"):
            quant_gemm_plan("e4m3", 8, n, k, 8, 128, H100_SMS)


@pytest.mark.parametrize("offset,stride,kept", [(0, 4100, False), (4, 4104, False), (8, 4096, True)])
def test_tma_rows_realigns_x(offset, stride, kept):
    """Rows 8-byte aligned with a stride that is a multiple of 4 (what the
    wrappers accept) become a copy with 16-byte aligned rows and a stride
    that is a multiple of 8; aligned rows are passed through."""
    base = torch.randn(3 * stride + offset, dtype=torch.float32).to(torch.bfloat16)
    x = base[offset:offset + 3 * stride].view(3, stride)[:, :4092]
    assert x.data_ptr() % 8 == 0 and x.stride(0) % 4 == 0
    y = _tma_rows(x)
    assert (y is x) == kept
    assert y.stride(0) % 8 == 0 and y.data_ptr() % 16 == 0 and y.stride(1) == 1
    assert torch.equal(y, x)


@pytest.mark.parametrize("offset,stride,kept", [(0, 4100, False), (4, 4112, False), (16, 4096, True), (0, 96, True)])
def test_tma_rows_realigns_int8_a(offset, stride, kept):
    """K8's int8 a with rows off 16 bytes (any stride, a sliced view) becomes
    a copy with 16-byte aligned rows and a stride that is a multiple of 16;
    aligned rows are passed through."""
    base = torch.randint(-127, 128, (3 * stride + offset,), dtype=torch.int8)
    x = base[offset:offset + 3 * stride].view(3, stride)[:, :96]
    y = _tma_rows(x)
    assert (y is x) == kept
    assert y.stride(0) % 16 == 0 and y.data_ptr() % 16 == 0 and y.stride(1) == 1
    assert torch.equal(y, x)


@pytest.mark.parametrize("offset,stride,kept", [(0, 4100, False), (8, 4112, False), (16, 4096, True), (0, 96, True)])
def test_tma_rows_realigns_e4m3_a(offset, stride, kept):
    """K8's float8_e4m3fn a, as its int8 a: rows off 16 bytes become an
    aligned copy of the same bytes; aligned rows are passed through."""
    base = torch.randint(0, 126, (3 * stride + offset,), dtype=torch.uint8)
    x = base.view(torch.float8_e4m3fn)[offset:offset + 3 * stride].view(3, stride)[:, :96]
    y = _tma_rows(x)
    assert (y is x) == kept and y.dtype == torch.float8_e4m3fn
    assert y.stride(0) % 16 == 0 and y.data_ptr() % 16 == 0 and y.stride(1) == 1
    assert torch.equal(y.view(torch.uint8), x.view(torch.uint8))


@pytest.mark.parametrize("group", [64, 128])
def test_magic_fragments_follow_x(group):
    """K1's decode as csrc/mixed_gemm_magic.cu does it, on words packed by
    ``pack_rows_magic``: k16 step j of a group takes field j // NB of word
    rows 8 (j % NB) + t (k slots 2t, 2t+1: low and high half) and 8 (j %
    NB) + 4 + t (slots 2t+8, 2t+9), NB = group / 64. Each slot must hold
    the code of x value 16j + slot of the group: x's TMA box is a plain
    slice. Codes encode their k mod 16 and j, so any slip shows."""
    k, nb = 2 * group, group // 64
    rows = torch.arange(k)
    codes = ((rows % 16) ^ ((rows % group) // 16)).reshape(k, 1).repeat(1, 2)  # 4-bit, two columns
    words = pack_rows_magic(codes, group).to(torch.int64) & 0xFFFFFFFF
    for g in range(k // group):
        w = words[g * group // 8 : (g + 1) * group // 8, 0]
        for j in range(group // 16):
            f, b = divmod(j, nb)
            for t in range(4):
                for q, base in ((0, 2 * t), (1, 2 * t + 8)):
                    word = int(w[8 * b + t + 4 * q]) >> (4 * f)
                    for h in range(2):
                        assert (word >> (16 * h)) & 0xF == int(codes[g * group + 16 * j + base + h, 0])


def _magic_slot(group: int, j: int, t: int, q: int) -> tuple[int, int]:
    """(word row of the slice, bit field) that csrc/mixed_gemm_magic.cu
    reads for k16 step j, thread t, k slots 2t + 8q and 2t + 8q + 1: at
    groups 64 and 128 field j // NB of word row 8 (j % NB) + t + 4q (NB =
    group / 64); at group 32 (two groups a slice) field 2 (j % 2) + q of
    word row 4 (j // 2) + t."""
    if group == 32:
        return 4 * (j // 2) + t, 2 * (j % 2) + q
    f, b = divmod(j, group // 64)
    return 8 * b + t + 4 * q, f


def test_magic_fragments_at_group_32_follow_x():
    """K1's decode at group 32, a slice of two groups: slot 2t + 8q + h of
    k16 step j must hold the code of x value 16j + 2t + 8q + h of the slice
    (K 160: two whole slices and one half slice, as TMA fills the rest)."""
    group, ks, k = 32, 64, 160
    rows = torch.arange(k)
    codes = ((rows % 16) ^ (rows // 16)).reshape(k, 1).repeat(1, 2) & 0xF
    words = pack_rows_magic(codes, group).to(torch.int64) & 0xFFFFFFFF
    for s0 in range(0, k, ks):
        w = words[s0 // 8 : (s0 + ks) // 8, 0]
        for j in range(min(ks, k - s0) // 16):
            for t in range(4):
                for q in range(2):
                    row, field = _magic_slot(group, j, t, q)
                    word = int(w[row]) >> (4 * field)
                    for h in range(2):
                        assert (word >> (16 * h)) & 0xF == int(codes[s0 + 16 * j + 2 * t + 8 * q + h, 0])


@pytest.mark.parametrize("bits,group", [(8, 32), (4, 64), (2, 128), (8, 96)])
def test_planar_fragments_at_8_word_rows_follow_x(bits, group):
    """K1b's decode at 8 word rows a slice (SUB 8, group % (16 * epp) != 0):
    slot 2t + 8q + h of k16 step j is field 2j + q of word row 2t + h of the
    slice; x's 4-d box stages k-block 2j + q as the 8 values of field 2j + q
    at (2j + q) * (group / epp) + 8 * sub. Each slot must hold the code of
    that x value."""
    epp = 32 // bits
    rpg, k = group // epp, 2 * group
    rows = torch.arange(k)
    codes = (rows * 7 + rows // group) % (1 << bits)
    words = pack_rows_planar(codes.reshape(k, 1).repeat(1, 2), bits, group).to(torch.int64) & 0xFFFFFFFF
    mask = (1 << bits) - 1
    for s in range(k // (8 * epp)):
        g, sub = divmod(s, rpg // 8)
        w = words[8 * s : 8 * s + 8, 0]
        for j in range(epp // 2):
            for t in range(4):
                for q in range(2):
                    field = 2 * j + q
                    for h in range(2):
                        x_at = g * group + field * rpg + 8 * sub + 2 * t + h
                        assert (int(w[2 * t + h]) >> (bits * field)) & mask == int(codes[x_at])
