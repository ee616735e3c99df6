# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""The quantized GEMMs: four CUDA kernels and their plain versions.

Each kernel replaces one kernel of ``conch_tpu/kernels/quantization/gemm.py``:

- K1 ``mixed_gemm_magic`` (``csrc/mixed_gemm_magic.cu``) replaces
  ``_mixed_gemm_magic_kernel``: int4 codes in the magic packing, groups 32,
  64 and 128 (any other group raises on the card), the group's scale
  applied to the decoded weight before the product; bf16 x over bf16
  scales, or f16 x over bf16, f16 or f32 scales (``MAGIC_SCALE_DTYPES``);
- K1b ``mixed_gemm_planar`` (``csrc/mixed_gemm_planar.cu``) replaces
  ``_mixed_gemm_planar_kernel``: 2/4/8-bit codes in the planar packing, a
  group a multiple of 8 word rows (any other raises on the card), the
  group's scale and zero-point applied after the product;
- K1c ``mixed_gemm_rows`` (``csrc/mixed_gemm_rows.cu``) replaces
  ``_mixed_gemm_kernel``: 2/4/8-bit GPTQ rows or 4-bit codebook codes
  (NF4, FP4), dequantized before the product and rounded to the
  activation dtype;
- K8 ``scaled_gemm`` (``csrc/scaled_gemm.cu``) replaces
  ``_scaled_gemm_kernel``: int8 x int8 summed in int32 (float8_e4m3fn in
  f32), then ``* sa[m] * sb[n]``.

K1, K1b, K1c and K8 share one pipelined tensor-core mainloop
(``csrc/quant_gemm_mainloop.cuh``); ``quant_gemm_plan`` picks its launch
(rows a block, splits of K on group boundaries, the workspace: f32, int32
for K8's int8) from the shape and the SM count, here in Python where the
CPU tests hold it. K8's float8_e4m3fn shapes that the mainloop's TMA
copies cannot take (``e4m3_takes_mainloop``) run a loop kernel instead,
chosen here before the launch.

Each takes a ``layer_index`` into per-layer stacks of its weight arrays
(``(L, ...)``): the wrapper offsets the pointers to the layer, so no
slice of a stack is ever copied. K1, K1b and K1c round their f32 sums
once, into ``out_dtype`` (x's dtype by default; on the card float32 or
bfloat16, and K1 float16 too). The plain versions follow the
TPU kernels' order of rounding in f32. A launcher takes its plain version for
CPU tensors only; on CUDA it launches its kernel or raises, and counts
each launch in ``launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from conch_tpu_torch.kernels.common import (
    FLOAT_DTYPES,
    cdiv,
    check_launch,
    dtype_code,
    kernel_function,
    require_cuda,
    sm_count,
    stream_of,
)
from conch_tpu_torch.utils.quant_utils import get_pack_factor, unpack_rows, unpack_rows_magic, unpack_rows_planar

KERNEL_GROUP_SIZES = (32, 64, 128)  # the group sizes K1's CUDA kernel is written for (a slice: one group, or two of 32)
KERNEL_OUT_DTYPES = (torch.float32, torch.bfloat16)  # the final stores K1b and K1c are written for
MAGIC_OUT_DTYPES = (*KERNEL_OUT_DTYPES, torch.float16)  # K1's
# K1's scale dtypes under each x dtype: bf16 x takes bf16 scales (the
# JAX package's int4 init), f16 x also f16 (a GPTQ checkpoint's) and f32.
MAGIC_SCALE_DTYPES = {
    torch.bfloat16: (torch.bfloat16,),
    torch.float16: (torch.bfloat16, torch.float16, torch.float32),
}


def _layer(a: torch.Tensor, layer_index: int | None) -> torch.Tensor:
    if layer_index is None:
        return a
    if not 0 <= layer_index < a.shape[0]:
        msg = f"layer_index {layer_index} outside the {a.shape[0]}-layer stack"
        raise IndexError(msg)
    return a[layer_index]


# -- shared by the wrappers ------------------------------------------------


def _zp_of(zp: torch.Tensor | None, layer_index: int | None) -> torch.Tensor | None:
    """A per-group zero-point stack follows the weights' layer; a scalar
    zero-point (one element) is shared."""
    if zp is None or zp.numel() == 1 or layer_index is None:
        return zp
    return _layer(zp, layer_index)


def _layer_ptr(a: torch.Tensor, layer_index: int | None) -> int:
    """The data pointer of layer ``layer_index`` of a contiguous stack (or of
    ``a`` itself): a pointer offset, never a copy."""
    if layer_index is None:
        return a.data_ptr()
    _layer(a, layer_index)  # range check
    return a.data_ptr() + layer_index * a.stride(0) * a.element_size()


def _check_layer_shapes(name: str, layer_index: int | None, shapes: dict) -> None:
    """Raise unless each tensor has rank 2 (3 with a layer index) and the
    given trailing shape."""
    rank = 2 if layer_index is None else 3
    for label, (t, want) in shapes.items():
        if t.dim() != rank or tuple(t.shape[-2:]) != want:
            msg = f"{name} kernel: {label} {tuple(t.shape)} does not fit (expected {'(L, ' if rank == 3 else '('}{want})"
            raise ValueError(msg)


def _names(dtypes: tuple[torch.dtype, ...]) -> str:
    return " or ".join(str(d).removeprefix("torch.") for d in dtypes)


def _out_dtype(
    name: str, x: torch.Tensor, out_dtype: torch.dtype | None, dtypes: tuple[torch.dtype, ...] = KERNEL_OUT_DTYPES
) -> torch.dtype:
    """The kernel's output dtype (x's by default); raises on one it does not store."""
    out_dtype = out_dtype or x.dtype
    if out_dtype not in dtypes:
        msg = f"{name} kernel: stores {_names(dtypes)} outputs, not {out_dtype}"
        raise NotImplementedError(msg)
    return out_dtype


def _check_x(name: str, x: torch.Tensor, dtypes: tuple[torch.dtype, ...] = (torch.bfloat16,)) -> None:
    if x.dtype not in dtypes:
        msg = f"{name} kernel: x must be {_names(dtypes)} on the card, got {x.dtype}"
        raise NotImplementedError(msg)
    if x.dim() != 2 or x.stride(1) != 1 or x.stride(0) % 4 or x.data_ptr() % 8:
        msg = f"{name} kernel: x rows must be contiguous, 8-byte aligned, with a row stride that is a multiple of 4"
        raise ValueError(msg)


def _tma_rows(x: torch.Tensor) -> torch.Tensor:
    """x itself when its rows suit the TMA copies of K1, K1b, K1c and K8
    (16-byte aligned, a row stride of a multiple of 16 bytes), else a copy
    whose rows do (stride K rounded up to 16 bytes)."""
    per16 = 16 // x.element_size()
    if x.stride(0) % per16 == 0 and x.data_ptr() % 16 == 0:
        return x
    m, k = x.shape
    aligned = torch.empty((m, -(-k // per16) * per16), dtype=x.dtype, device=x.device)[:, :k]
    aligned.copy_(x)
    return aligned


def _check_packed(name: str, bits: int, packed: torch.Tensor, scales: torch.Tensor) -> None:
    """Raise unless the words are contiguous int32 of 2/4/8-bit codes and the
    scales contiguous bf16 or f32."""
    if bits not in (2, 4, 8) or packed.dtype != torch.int32 or scales.dtype not in (torch.bfloat16, torch.float32):
        msg = f"{name} kernel: 2/4/8-bit int32 words and bf16/f32 scales, got {bits} bits, {packed.dtype}, {scales.dtype}"
        raise NotImplementedError(msg)
    if not (packed.is_contiguous() and scales.is_contiguous()):
        msg = f"{name} kernel: packed weights and scales must be contiguous"
        raise ValueError(msg)


def _zp_args(name: str, zp: torch.Tensor | None, layer_index: int | None, meta_shape: tuple) -> tuple[int, int]:
    """(pointer, mode) of the zero-points: mode 0 none, 1 one value, 2 per group."""
    if zp is None:
        return 0, 0
    if zp.dtype != torch.float32 or not zp.is_contiguous():
        msg = f"{name} kernel: zero-points must be contiguous float32, got {zp.dtype}"
        raise ValueError(msg)
    if zp.numel() == 1:
        return zp.data_ptr(), 1
    _check_layer_shapes(name, layer_index, {"w_zp": (zp, meta_shape)})
    return _layer_ptr(zp, layer_index), 2


def dequantize_magic(packed: torch.Tensor, scales: torch.Tensor, k: int, group_size: int, bias: int) -> torch.Tensor:
    """The (K, N) float32 weight ``(code - bias) * scale`` of one layer."""
    codes = unpack_rows_magic(packed, k, group_size)
    return (codes - bias).to(torch.float32) * scales.to(torch.float32).repeat_interleave(group_size, dim=0)


def mixed_gemm_magic_plain(
    x: torch.Tensor,
    packed: torch.Tensor,
    scales: torch.Tensor,
    group_size: int,
    bias: int,
    layer_index: int | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of K1, on any device: dequantize the layer's
    weight in f32, multiply in f32, round to ``out_dtype`` (x's dtype by
    default)."""
    packed, scales = _layer(packed, layer_index), _layer(scales, layer_index)
    w = dequantize_magic(packed, scales, x.shape[1], group_size, bias)
    return torch.matmul(x.float(), w).to(out_dtype or x.dtype)


def check_magic_dtypes(x: torch.Tensor, scales: torch.Tensor, packed: torch.Tensor) -> None:
    """Raise unless K1 takes x's, the scales' and the words' dtypes
    (``MAGIC_SCALE_DTYPES``: bf16 x over bf16 scales, f16 x over bf16, f16
    or f32 scales; int32 words), naming the rule."""
    _check_x("mixed_gemm_magic", x, tuple(MAGIC_SCALE_DTYPES))
    if scales.dtype not in MAGIC_SCALE_DTYPES[x.dtype] or packed.dtype != torch.int32:
        msg = (
            f"mixed_gemm_magic kernel: {x.dtype} x takes {_names(MAGIC_SCALE_DTYPES[x.dtype])} scales and int32 "
            f"words, got {scales.dtype}, {packed.dtype}"
        )
        raise NotImplementedError(msg)


def _magic_gemm_cuda(
    x, packed, scales, group_size: int, bias: int, layer_index: int | None, out_dtype: torch.dtype | None
) -> torch.Tensor:
    require_cuda(x, packed, scales)
    check_magic_dtypes(x, scales, packed)
    x = _tma_rows(x)
    out_dtype = _out_dtype("mixed_gemm_magic", x, out_dtype, MAGIC_OUT_DTYPES)
    m, k = x.shape
    n = packed.shape[-1]
    if not (packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError("mixed_gemm_magic kernel: packed weights and scales must be contiguous")
    plan = quant_gemm_plan("magic", m, n, k, 4, group_size, sm_count(x.device.index))
    _check_layer_shapes("mixed_gemm_magic", layer_index, {
        "packed": (packed, (k // 8, n)), "scales": (scales, (k // group_size, n)),
    })
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    plan_args, _ws = _plan_args(plan, m, n, x.device)
    fn = kernel_function("conch_mixed_gemm_magic", (
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int, *PLAN_ARGTYPES,
        ctypes.c_void_p,
    ))
    code = fn(x.data_ptr(), dtype_code(x, FLOAT_DTYPES), _layer_ptr(packed, layer_index),
              _layer_ptr(scales, layer_index), dtype_code(scales, FLOAT_DTYPES), out.data_ptr(),
              dtype_code(out, FLOAT_DTYPES), m, n, k, group_size, x.stride(0), bias, *plan_args, stream_of(x))
    check_launch("conch_mixed_gemm_magic", code)
    mixed_gemm_magic_launcher.launches += 1
    if x.dtype == torch.float16:
        mixed_gemm_magic_launcher.f16_launches += 1
    return out


def mixed_gemm_magic_launcher(
    x: torch.Tensor,  # (M, K)
    packed: torch.Tensor,  # (K/8, N) int32, or (L, K/8, N) with layer_index
    scales: torch.Tensor,  # (K/group, N), or (L, K/group, N)
    group_size: int,
    bias: int,
    layer_index: int | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``x @ ((code - bias) * scale)`` in f32, rounded to ``out_dtype`` (x's
    dtype by default; float32, bfloat16 or float16 on the card): (M, N).
    On the card x is bf16 over bf16 scales, or f16 over bf16, f16 or f32
    scales (``check_magic_dtypes``).

    ``launches`` counts kernel launches; of them, ``f16_launches`` those
    under f16 x.
    """
    if x.device.type == "cpu":
        return mixed_gemm_magic_plain(x, packed, scales, group_size, bias, layer_index, out_dtype)
    return _magic_gemm_cuda(x, packed, scales, group_size, bias, layer_index, out_dtype)


mixed_gemm_magic_launcher.launches = 0
mixed_gemm_magic_launcher.f16_launches = 0


# -- the launch plan of K1, K1b, K1c and K8 --------------------------------

QGEMM_COLS = 128  # weight (output) columns a block: two warpgroups of 64 (quant_gemm_mainloop.cuh kCols)
QGEMM_ROW_TILES = (32, 64, 128)  # x rows a block (wgmma's N): decode, up to 64, prefill
ROWS_K_SLICE = 64  # K of a GPTQ-row slice (kKSlice)
SCALED_K_SLICE = 128  # K of a K8 slice: one 128-byte swizzle atom of int8 or e4m3 (scaled_gemm.cu ScaledLayout::KS)


def planar_k_slice(bits: int, group_size: int) -> int:
    """K of a planar slice: a whole group of 128 for 4- and 8-bit codes (its
    x values are contiguous), else 16 word rows of one group, 16 * (32 /
    bits) k, where the group's word rows are a multiple of 16, else 8 word
    rows, 8 * (32 / bits) k (int8 at group 32, 4-bit at 64, 2-bit at 128:
    the slice is the group)."""
    epp = get_pack_factor(bits)
    if group_size == 128 and bits >= 4:
        return 128
    return 16 * epp if group_size % (16 * epp) == 0 else 8 * epp


def magic_k_slice(group_size: int) -> int:
    """K of a magic slice: one group of 64 or 128, two groups of 32."""
    return 64 if group_size < 64 else group_size


@dataclasses.dataclass(frozen=True)
class QuantGemmPlan:
    """A launch of K1, K1b, K1c or K8: ``bn`` x rows a block; K walked in ``slices``
    slices of ``k_slice`` k; ``splits`` blocks over K, each taking whole
    units of ``unit`` slices (a unit ends on a group boundary); grid
    (column tiles, row tiles, splits). The entry point takes ``bn``,
    ``k_slice``, ``slices``, ``unit`` and ``splits`` as they are, refuses a
    plan its template cannot run, and splits K with ``split_slices``'s
    formula (quant_gemm_mainloop.cuh: split_range)."""

    bn: int
    k_slice: int
    slices: int
    unit: int
    splits: int
    grid: tuple[int, int, int]
    row_sums: bool = False  # K1b: x's group row sums summed once by a pre-pass (128 rows a block)
    int_sums: bool = False  # K8's int8 sums in s32: its splits' partial sums are int32, not f32 (e4m3: f32)

    @property
    def units(self) -> int:
        return cdiv(self.slices, self.unit)

    def split_slices(self, split: int) -> tuple[int, int]:
        """Slices [s0, s1) of one split: whole units, as evenly as integer
        division allows."""
        u0, u1 = split * self.units // self.splits, (split + 1) * self.units // self.splits
        return u0 * self.unit, min(u1 * self.unit, self.slices)

    def workspace_shape(self, m: int, n: int) -> tuple[int, int, int] | None:
        """The partial sums of the splits (int32 with ``int_sums``, else
        f32), added in a fixed order by a second kernel; none with one
        split."""
        return (self.splits, m, n) if self.splits > 1 else None


def quant_gemm_plan(layout: str, m: int, n: int, k: int, bits: int, group_size: int, num_sms: int) -> QuantGemmPlan:
    """The launch of K1 (``layout="magic"``), K1b (``"planar"``), K1c
    (``"gptq"``) or K8 (``"scaled"``: int8 x int8; ``"e4m3"``: float8_e4m3fn
    x float8_e4m3fn; ``bits`` 8, no groups) for an (M, K) x (K, N) product
    of ``bits``-bit codes in groups of ``group_size`` on a card of
    ``num_sms`` SMs. Raises on what the kernel refuses. A magic slice is one
    group (64 or 128) or two groups of 32 (the last slice zero-filled past
    K); a planar group must be a multiple of 8 word rows (``planar_k_slice``);
    a scaled or e4m3 slice is 128 k (the last one
    zero-filled past K), a split unit one slice. e4m3 takes any K >= 1 and
    N a multiple of 16 (b's rows 16-byte aligned for its TMA copies; a's
    are realigned by ``_tma_rows``); its split sums are f32.

    Rows: 32 a block up to 32 (the engine's decode step: one block covers
    every row, so each code is decoded once), 64 up to 64, else 128 (64
    for 2- and 4-bit planar codes). K is split so that a decode shape has
    about two blocks an SM, never less than one, and a prefill shape at
    most one wave; a split takes at least two slices, unless a decode shape
    would then leave SMs without a block (DeepSeek-V2-Lite's w_kv_a, N 640
    at K 2048), where a split may take one unit. K1b at 128 rows a block
    takes x's row sums over each group from a pre-pass, so that the N / 128
    column blocks do not each sum them again.
    """
    epp = get_pack_factor(bits)
    if layout == "planar":
        name = "mixed_gemm_planar"
        if k % group_size or group_size % (8 * epp) or n % 32:
            msg = (
                f"{name} kernel: needs K % group == 0, group % {8 * epp} == 0 (8 word rows of {bits}-bit codes) "
                f"and N % 32 == 0 (K={k}, N={n}, group={group_size})"
            )
            raise ValueError(msg)
        ks = planar_k_slice(bits, group_size)
        slices, unit = k // ks, group_size // ks
    elif layout == "gptq":
        name = "mixed_gemm_rows"
        if k % epp or group_size % 4 or n % 32:
            msg = (
                f"{name} kernel: needs K % {epp} == 0, group % 4 == 0 and N % 32 == 0 "
                f"(K={k}, N={n}, group={group_size})"
            )
            raise ValueError(msg)
        ks = ROWS_K_SLICE
        slices, unit = cdiv(k, ks), math.lcm(group_size, ks) // ks
    elif layout == "magic":
        name = "mixed_gemm_magic"
        if bits != 4 or group_size not in KERNEL_GROUP_SIZES or k % group_size or n % 32:
            msg = (
                f"{name} kernel: needs 4-bit codes, group_size 32, 64 or 128, K a multiple of it and N of 32 "
                f"(bits={bits}, K={k}, N={n}, group={group_size})"
            )
            raise ValueError(msg)
        ks = magic_k_slice(group_size)
        slices, unit = cdiv(k, ks), 1
    elif layout == "scaled":
        name = "scaled_gemm"
        if bits != 8 or k % 32 or n % 32:
            msg = f"{name} kernel: needs int8 operands and K and N multiples of 32 (bits={bits}, K={k}, N={n})"
            raise ValueError(msg)
        ks = SCALED_K_SLICE
        slices, unit = cdiv(k, ks), 1
    elif layout == "e4m3":
        name = "scaled_gemm"
        if bits != 8 or k < 1 or n % 16:
            msg = (
                f"{name} kernel: the e4m3 mainloop needs 8-bit operands, K >= 1 and N a multiple of 16 "
                f"(b's rows 16-byte aligned for TMA) (bits={bits}, K={k}, N={n})"
            )
            raise ValueError(msg)
        ks = SCALED_K_SLICE
        slices, unit = cdiv(k, ks), 1
    else:
        msg = f"no K1/K1b/K1c/K8 launch plan for layout {layout!r}"
        raise ValueError(msg)
    # 2- and 4-bit planar codes decode 8 or 16 k16 steps a slice: their
    # fragments fit the registers beside two accumulator sets up to 64 rows.
    tiles = QGEMM_ROW_TILES[:-1] if layout == "planar" and bits < 8 else QGEMM_ROW_TILES
    bn = next((b for b in tiles if m <= b), tiles[-1])
    col_tiles, row_tiles = cdiv(n, QGEMM_COLS), cdiv(m, bn)
    blocks = col_tiles * row_tiles
    units = cdiv(slices, unit)
    if blocks == 0:
        splits = 1
    elif bn <= 64:  # about two blocks an SM, never less than one
        splits = max(cdiv(num_sms, blocks), 2 * num_sms // blocks)
    else:  # at most one wave
        splits = num_sms // blocks
    cap = slices // (2 * unit)
    if bn <= 64 and blocks * min(cap, units) < num_sms:
        cap = units
    splits = max(1, min(splits, cap, units))
    return QuantGemmPlan(bn=bn, k_slice=ks, slices=slices, unit=unit, splits=splits,
                         grid=(col_tiles, row_tiles, splits), row_sums=layout == "planar" and bn == QGEMM_ROW_TILES[-1],
                         int_sums=layout == "scaled")


# The plan's arguments of the entry points: bn, k_slice, slices, unit,
# splits, then the workspace pointer.
PLAN_ARGTYPES = (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


# The plan arguments that send K8's float8_e4m3fn call to its loop kernel (bn 0).
E4M3_LOOP_PLAN_ARGS = (0, 0, 0, 0, 1, 0)


def e4m3_takes_mainloop(k: int, n: int, b_address: int) -> bool:
    """Whether K8 runs an (M, K) x (K, N) float8_e4m3fn product on the
    mainloop (``quant_gemm_plan``'s "e4m3"): K >= 1, N a multiple of 16 and
    the layer's b at a 16-byte aligned address, so that b's rows suit its
    TMA copies (a's rows are realigned by ``_tma_rows``). Else the loop
    kernel, which takes any shape."""
    return k >= 1 and n % 16 == 0 and b_address % 16 == 0


def _plan_args(plan: QuantGemmPlan, m: int, n: int, device: torch.device) -> tuple[tuple, torch.Tensor | None]:
    """The plan's arguments of the entry point (PLAN_ARGTYPES) and the
    workspace, which the caller keeps alive until the launch."""
    shape = plan.workspace_shape(m, n)
    ws = None if shape is None else torch.empty(shape, dtype=torch.int32 if plan.int_sums else torch.float32,
                                                device=device)
    args = (plan.bn, plan.k_slice, plan.slices, plan.unit, plan.splits, 0 if ws is None else ws.data_ptr())
    return args, ws


# -- K1b: planar packing, dequantized after the product --------------------


def mixed_gemm_planar_plain(
    x: torch.Tensor,
    packed: torch.Tensor,
    scales: torch.Tensor,
    zp: torch.Tensor | None,
    bits: int,
    bias: int,
    group_size: int,
    layer_index: int | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of K1b, on any device, in the TPU kernel's
    order: for each group G, ``acc += (x_G @ c_G - z * sum(x_G)) * s_G``
    in f32 (z the group's zero-point, the scalar zero-point, or ``bias``),
    then rounded to ``out_dtype`` (x's dtype by default)."""
    packed, scales, zp = _layer(packed, layer_index), _layer(scales, layer_index), _zp_of(zp, layer_index)
    k = x.shape[1]
    codes = unpack_rows_planar(packed, bits, k, group_size)
    xf = x.float()
    acc = torch.zeros((x.shape[0], packed.shape[-1]), dtype=torch.float32, device=x.device)
    for g in range(k // group_size):
        rows = slice(g * group_size, (g + 1) * group_size)
        part = xf[:, rows] @ codes[rows].float()
        xsum = xf[:, rows].sum(dim=1, keepdim=True)
        if zp is None:
            z = float(bias)
        elif zp.numel() == 1:
            z = zp.reshape(()).float()
        else:
            z = zp[g].float()
        acc += (part - z * xsum) * scales[g].float()
    return acc.to(out_dtype or x.dtype)


def _planar_gemm_cuda(
    x, packed, scales, zp, bits: int, bias: int, group_size: int, layer_index, out_dtype: torch.dtype | None
) -> torch.Tensor:
    require_cuda(x, packed, scales, *([] if zp is None else [zp]))
    _check_x("mixed_gemm_planar", x)
    x = _tma_rows(x)
    out_dtype = _out_dtype("mixed_gemm_planar", x, out_dtype)
    m, k = x.shape
    n = packed.shape[-1]
    epp = get_pack_factor(bits)
    _check_packed("mixed_gemm_planar", bits, packed, scales)
    plan = quant_gemm_plan("planar", m, n, k, bits, group_size, sm_count(x.device.index))
    meta_shape = (k // group_size, n)
    _check_layer_shapes("mixed_gemm_planar", layer_index, {"packed": (packed, (k // epp, n)), "scales": (scales, meta_shape)})
    zp_ptr, zp_mode = _zp_args("mixed_gemm_planar", zp, layer_index, meta_shape)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    plan_args, _ws = _plan_args(plan, m, n, x.device)
    xs = torch.empty((k // group_size, -(-m // 4) * 4), dtype=torch.float32, device=x.device) if plan.row_sums else None
    fn = kernel_function("conch_mixed_gemm_planar", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, *PLAN_ARGTYPES, ctypes.c_void_p, ctypes.c_void_p,
    ))
    code = fn(x.data_ptr(), _layer_ptr(packed, layer_index), _layer_ptr(scales, layer_index), dtype_code(scales),
              zp_ptr, zp_mode, out.data_ptr(), dtype_code(out), m, n, k, x.stride(0), bits, group_size, bias,
              *plan_args, 0 if xs is None else xs.data_ptr(), stream_of(x))
    check_launch("conch_mixed_gemm_planar", code)
    mixed_gemm_planar_launcher.launches += 1
    return out


def mixed_gemm_planar_launcher(
    x: torch.Tensor,  # (M, K)
    packed: torch.Tensor,  # (K / (32 / bits), N) int32, or (L, ...) with layer_index
    scales: torch.Tensor,  # (K / group, N), or (L, ...)
    zp: torch.Tensor | None,  # None, one value, or (K / group, N) ((L, ...) when stacked)
    bits: int,
    bias: int,
    group_size: int,
    layer_index: int | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """K1b: ``x @ W`` over the planar packing, (M, N) in ``out_dtype`` (x's
    dtype by default)."""
    if x.device.type == "cpu":
        return mixed_gemm_planar_plain(x, packed, scales, zp, bits, bias, group_size, layer_index, out_dtype)
    return _planar_gemm_cuda(x, packed, scales, zp, bits, bias, group_size, layer_index, out_dtype)


mixed_gemm_planar_launcher.launches = 0


# -- K1c: GPTQ rows and codebooks, dequantized before the product ----------


def dequantize_rows(
    packed: torch.Tensor,
    scales: torch.Tensor,
    zp: torch.Tensor | None,
    k: int,
    bits: int,
    bias: int,
    group_size: int,
    codebook: tuple[float, ...] | None = None,
) -> torch.Tensor:
    """One layer's (K, N) f32 weight ``(c - bias [- z]) * s``, or
    ``(book[c] [- z]) * s`` with a codebook, as K1c computes it."""
    codes = unpack_rows(packed, bits, k)
    if codebook is not None:
        w = torch.tensor(codebook, dtype=torch.float32, device=packed.device)[codes.long()]
    else:
        w = codes.float() - float(bias)
    if zp is not None:
        w = w - (zp.reshape(()).float() if zp.numel() == 1 else zp.float().repeat_interleave(group_size, dim=0)[:k])
    return w * scales.float().repeat_interleave(group_size, dim=0)[:k]


def mixed_gemm_rows_plain(
    x: torch.Tensor,
    packed: torch.Tensor,
    scales: torch.Tensor,
    zp: torch.Tensor | None,
    bits: int,
    bias: int,
    group_size: int,
    codebook: tuple[float, ...] | None = None,
    layer_index: int | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of K1c, on any device, in the TPU kernel's
    order: the weight dequantized in f32 and rounded to x's dtype, the
    product summed in f32, then rounded to ``out_dtype`` (x's dtype by
    default)."""
    packed, scales, zp = _layer(packed, layer_index), _layer(scales, layer_index), _zp_of(zp, layer_index)
    w = dequantize_rows(packed, scales, zp, x.shape[1], bits, bias, group_size, codebook).to(x.dtype)
    return torch.matmul(x.float(), w.float()).to(out_dtype or x.dtype)


@functools.lru_cache(maxsize=8)
def _codebook_tensor(codebook: tuple[float, ...], device: torch.device) -> torch.Tensor:
    return torch.tensor(codebook, dtype=torch.float32, device=device)


def _rows_gemm_cuda(
    x, packed, scales, zp, bits: int, bias: int, group_size: int, codebook, layer_index, out_dtype: torch.dtype | None
) -> torch.Tensor:
    require_cuda(x, packed, scales, *([] if zp is None else [zp]))
    _check_x("mixed_gemm_rows", x)
    x = _tma_rows(x)
    out_dtype = _out_dtype("mixed_gemm_rows", x, out_dtype)
    m, k = x.shape
    n = packed.shape[-1]
    epp = get_pack_factor(bits)
    _check_packed("mixed_gemm_rows", bits, packed, scales)
    if codebook is not None and (bits != 4 or len(codebook) != 16):
        raise ValueError("mixed_gemm_rows kernel: a codebook has 16 entries and takes 4-bit codes")
    plan = quant_gemm_plan("gptq", m, n, k, bits, group_size, sm_count(x.device.index))
    meta_shape = (-(-k // group_size), n)
    _check_layer_shapes("mixed_gemm_rows", layer_index, {"packed": (packed, (k // epp, n)), "scales": (scales, meta_shape)})
    zp_ptr, zp_mode = _zp_args("mixed_gemm_rows", zp, layer_index, meta_shape)
    book = 0 if codebook is None else _codebook_tensor(tuple(codebook), x.device).data_ptr()
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    plan_args, _ws = _plan_args(plan, m, n, x.device)
    fn = kernel_function("conch_mixed_gemm_rows", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, *PLAN_ARGTYPES, ctypes.c_void_p,
    ))
    code = fn(x.data_ptr(), _layer_ptr(packed, layer_index), _layer_ptr(scales, layer_index), dtype_code(scales),
              zp_ptr, zp_mode, book, out.data_ptr(), dtype_code(out), m, n, k, x.stride(0), bits, group_size, bias,
              *plan_args, stream_of(x))
    check_launch("conch_mixed_gemm_rows", code)
    mixed_gemm_rows_launcher.launches += 1
    return out


def mixed_gemm_rows_launcher(
    x: torch.Tensor,  # (M, K)
    packed: torch.Tensor,  # (K / (32 / bits), N) int32, or (L, ...) with layer_index
    scales: torch.Tensor,  # (ceil(K / group), N), or (L, ...)
    zp: torch.Tensor | None,  # None, one value, or (ceil(K / group), N) ((L, ...) when stacked)
    bits: int,
    bias: int,
    group_size: int,
    codebook: tuple[float, ...] | None = None,
    layer_index: int | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """K1c: ``x @ W`` over GPTQ rows (or codebook codes), (M, N) in
    ``out_dtype`` (x's dtype by default)."""
    if x.device.type == "cpu":
        return mixed_gemm_rows_plain(x, packed, scales, zp, bits, bias, group_size, codebook, layer_index, out_dtype)
    return _rows_gemm_cuda(x, packed, scales, zp, bits, bias, group_size, codebook, layer_index, out_dtype)


mixed_gemm_rows_launcher.launches = 0


# -- K8: int8 (or float8_e4m3fn) x int8 with row and column scales ---------


def _scale_vector(scale: torch.Tensor, size: int) -> torch.Tensor:
    """(size, ) or one value, as float32."""
    s = scale.float().reshape(-1)
    if s.numel() not in (1, size):
        msg = f"a scale of {s.numel()} values for {size} rows or columns"
        raise ValueError(msg)
    return s


def scaled_gemm_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    scale_a: torch.Tensor,
    scale_b: torch.Tensor,
    out_dtype: torch.dtype,
    layer_index: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of K8 on any device: ``float(a @ b) * sa * sb``
    in f32, in that order, rounded to ``out_dtype``. The int8 sums are
    exact: taken in float64, whose 53 bits hold any int32 sum, and then
    rounded to f32 as the int32 sum would be; float8 values are summed in
    f32."""
    b = _layer(b, layer_index)
    if scale_b.numel() > 1:
        scale_b = _layer(scale_b, layer_index)
    if a.dtype == torch.int8:
        acc = torch.matmul(a.double(), b.double()).float()
    else:
        acc = torch.matmul(a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float())
    sa = _scale_vector(scale_a, a.shape[0])
    sb = _scale_vector(scale_b, b.shape[1])
    return (acc * sa[:, None] * sb[None, :]).to(out_dtype)


def _scaled_gemm_cuda(a, b, scale_a, scale_b, out_dtype: torch.dtype, layer_index) -> torch.Tensor:
    require_cuda(a, b, scale_a, scale_b)
    m, k = a.shape
    n = b.shape[-1]
    fp8 = a.dtype == torch.float8_e4m3fn
    if a.dtype != b.dtype or a.dtype not in (torch.int8, torch.float8_e4m3fn) or out_dtype not in (
        torch.float32, torch.bfloat16,
    ):
        msg = f"scaled_gemm kernel: int8 or float8_e4m3fn inputs and a float32/bfloat16 output, got {a.dtype}, {b.dtype} -> {out_dtype}"
        raise NotImplementedError(msg)
    if scale_a.dtype != torch.float32 or scale_b.dtype != torch.float32 or not (
        scale_a.is_contiguous() and scale_b.is_contiguous()
    ):
        raise ValueError("scaled_gemm kernel: scales must be contiguous float32")
    if a.dim() != 2 or a.stride(1) != 1 or not b.is_contiguous() or (not fp8 and (k % 32 or n % 32)):
        msg = f"scaled_gemm kernel: needs contiguous rows and, for int8, K and N multiples of 32 (K={k}, N={n})"
        raise ValueError(msg)
    _check_layer_shapes("scaled_gemm", layer_index, {"b": (b, (k, n))})
    b_ptr = _layer_ptr(b, layer_index)
    sa_scalar = scale_a.numel() == 1
    sb_scalar = scale_b.numel() == 1
    if not sa_scalar and scale_a.numel() != m:
        raise ValueError(f"scaled_gemm kernel: scale_a of {scale_a.numel()} values for {m} rows")
    if sb_scalar:
        sb_ptr = scale_b.data_ptr()
    else:
        if scale_b.shape[-1] != n or scale_b.dim() != (1 if layer_index is None else 2):
            raise ValueError(f"scaled_gemm kernel: scale_b {tuple(scale_b.shape)} for {n} columns")
        sb_ptr = _layer_ptr(scale_b, layer_index)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    loop = fp8 and not e4m3_takes_mainloop(k, n, b_ptr)
    if loop:
        plan_args, _ws = E4M3_LOOP_PLAN_ARGS, None
    else:
        a = _tma_rows(a)
        plan = quant_gemm_plan("e4m3" if fp8 else "scaled", m, n, k, 8, SCALED_K_SLICE, sm_count(a.device.index))
        plan_args, _ws = _plan_args(plan, m, n, a.device)
    fn = kernel_function("conch_scaled_gemm", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
        *PLAN_ARGTYPES, ctypes.c_void_p,
    ))
    code = fn(a.data_ptr(), b_ptr, scale_a.data_ptr(), int(sa_scalar), sb_ptr, int(sb_scalar),
              out.data_ptr(), dtype_code(out), m, n, k, a.stride(0), int(fp8), *plan_args, stream_of(a))
    check_launch("conch_scaled_gemm", code)
    scaled_gemm_launcher.launches += 1
    if fp8:
        if loop:
            scaled_gemm_launcher.e4m3_loop_launches += 1
        else:
            scaled_gemm_launcher.e4m3_launches += 1
    return out


def scaled_gemm_launcher(
    a: torch.Tensor,  # (M, K) int8 or float8_e4m3fn
    b: torch.Tensor,  # (K, N) of a's dtype, or (L, K, N) with layer_index
    scale_a: torch.Tensor,  # (M,) or one value, float32
    scale_b: torch.Tensor,  # (N,) or one value ((L, N) when stacked), float32
    out_dtype: torch.dtype,
    layer_index: int | None = None,
) -> torch.Tensor:
    """K8: ``float(a @ b) * scale_a[:, None] * scale_b[None, :]`` as
    ``out_dtype``: (M, N).

    ``launches`` counts kernel launches; of them, ``e4m3_launches`` those of
    float8_e4m3fn on the mainloop's fp8 ``wgmma`` layout and
    ``e4m3_loop_launches`` those on the loop kernel.
    """
    if a.device.type == "cpu":
        return scaled_gemm_plain(a, b, scale_a, scale_b, out_dtype, layer_index)
    return _scaled_gemm_cuda(a, b, scale_a, scale_b, out_dtype, layer_index)


scaled_gemm_launcher.launches = 0
scaled_gemm_launcher.e4m3_launches = 0
scaled_gemm_launcher.e4m3_loop_launches = 0
