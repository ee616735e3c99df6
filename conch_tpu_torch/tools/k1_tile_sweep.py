# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Time K1 (``csrc/mixed_gemm_magic.cu``) at several tile shapes on the card.

    python3 -m conch_tpu_torch.tools.k1_tile_sweep

Builds the kernel's template at group 128 and each (MT, WARPS_N, WARPS_K,
DEPTH) below into a library of its own (under ``conch_tpu_torch/_build``), checks each
against the plain version, and prints the device time of each at the
engine's four (K, N) and M = 8, 32 and 512, with the weights walked over a
32-layer stack so they come from HBM. ``csrc/mixed_gemm_magic.cu`` picks
its two shapes from this table. Needs one Hopper card.
"""

from __future__ import annotations

import ctypes
import itertools
import subprocess
import sys

import torch

from conch_tpu_torch import envs
from conch_tpu_torch.kernels.common import ARCH_FLAGS, BUILD_DIR, CSRC_DIR
from conch_tpu_torch.kernels.quantization.gemm import mixed_gemm_magic_plain

SHAPES = ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096))
# (MT, WARPS_N, WARPS_K, DEPTH): rows = 16 * MT, columns = 32 * WARPS_N.
DECODE_TILES = ((1, 1, 8, 1), (1, 1, 8, 2), (1, 1, 8, 3), (1, 1, 16, 2), (2, 1, 8, 1), (2, 1, 8, 2), (2, 1, 8, 3),
                (2, 1, 4, 3))
PREFILL_TILES = ((4, 4, 1, 1), (2, 4, 1, 1), (2, 2, 2, 1), (4, 2, 1, 1), (1, 4, 1, 1))
LAYERS, GROUP, BIAS = 32, 128, 8
HBM_BYTES_PER_S, BF16_OPS_PER_S = 3.35e12, 989e12


def _name(tile: tuple) -> str:
    return "tile_" + "_".join(map(str, tile))


def build() -> ctypes.CDLL:
    lines = [f'#include "{CSRC_DIR / "mixed_gemm_magic.cu"}"']
    for tile in DECODE_TILES + PREFILL_TILES:
        lines.append(
            f'extern "C" int {_name(tile)}(const void* x, const void* w, const void* s, void* o, int m, int n, int k,'
            f" int64_t st, int bias, void* stream) {{ conch::launch<{GROUP}, {', '.join(map(str, tile))}, __nv_bfloat16>(x, w, s, o, m,"
            " n, k, st, bias, static_cast<cudaStream_t>(stream)); return static_cast<int>(cudaGetLastError()); }"
        )
    BUILD_DIR.mkdir(exist_ok=True)
    src, lib = BUILD_DIR / "k1_tile_sweep.cu", BUILD_DIR / "libk1_tile_sweep.so"
    src.write_text("\n".join(lines) + "\n")
    cmd = [envs.CONCH_NVCC, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(src)]
    subprocess.run(cmd, check=True)
    return ctypes.CDLL(str(lib))


def device_ms(fn, iters: int = 50) -> float:
    """Mean device time per call, the stream held by a sleep kernel while
    the host queues the calls (as chip_smoke.time_ms)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(iters * 2e5))  # about 0.1 ms a call at 2 GHz, far above the host's launch time
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_tile_sweep: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    lib = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals: dict[tuple, float] = {}
    for k, n in SHAPES:
        packed = torch.randint(-(2**31), 2**31 - 1, (LAYERS, k // 8, n), generator=gen, device="cuda", dtype=torch.int32)
        scales = (torch.rand((LAYERS, k // GROUP, n), generator=gen, device="cuda") * 4e-3 + 1e-4).to(torch.bfloat16)
        for m in (8, 32, 512):
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            ref = mixed_gemm_magic_plain(x, packed, scales, GROUP, BIAS, 17).float()
            out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
            bytes_moved = m * k * 2 + k * n // 2 + (k // GROUP) * n * 2 + m * n * 2
            bound_us = max(bytes_moved / HBM_BYTES_PER_S, 2 * m * n * k / BF16_OPS_PER_S) * 1e6
            cells = []
            for tile in DECODE_TILES if m <= 32 else PREFILL_TILES:
                fn = getattr(lib, _name(tile))
                fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
                stream = torch.cuda.current_stream().cuda_stream

                def call(layer: int, fn=fn) -> int:
                    return fn(x.data_ptr(), packed.data_ptr() + layer * packed.stride(0) * 4,
                              scales.data_ptr() + layer * scales.stride(0) * 2, out.data_ptr(), m, n, k, k, BIAS, stream)

                if call(17) != 0:
                    raise RuntimeError(f"tile {tile}: launch failed")
                err = (out.float() - ref).abs().max().item()
                if err > 1e-2 * ref.abs().max().item():
                    raise AssertionError(f"tile {tile} at M={m} K={k} N={n}: max_abs_err {err}")
                layers = itertools.cycle(range(LAYERS))
                us = device_ms(lambda call=call: call(next(layers))) * 1e3
                totals[(m, tile)] = totals.get((m, tile), 0.0) + us
                cells.append(f"{tile}: {us:.1f}")
            print(f"M={m} K={k} N={n} bound {bound_us:.1f} us | " + " | ".join(cells), flush=True)
        del packed, scales
        torch.cuda.empty_cache()
    for m in (8, 32, 512):
        row = sorted((us, tile) for (mm, tile), us in totals.items() if mm == m)
        print(f"M={m}, sum over the four shapes (us): " + " | ".join(f"{tile}: {us:.1f}" for us, tile in row))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
