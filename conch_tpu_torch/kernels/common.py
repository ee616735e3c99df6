# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Shared helpers for the hand-written Hopper kernels.

``build_kernels`` compiles every ``conch_tpu_torch/csrc/*.cu`` with its
own ``nvcc`` process, all started together, and links the objects into
one shared library with a plain C interface under
``conch_tpu_torch/_build/`` (listed in ``.gitignore``); ``kernel_function``
binds one of its entry points with ``ctypes``. Every entry point launches
on the stream it is given and returns ``cudaGetLastError()``, which
``check_launch`` turns into an exception. Nothing is built or loaded when
a module is imported: the first launch on a CUDA tensor does it.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from pathlib import Path

import torch

from conch_tpu_torch import envs
from conch_tpu_torch.platforms.platform import current_platform

_PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR / "_build"
LIBRARY_NAME = "libconch_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes understood by the C entry points (csrc/common.cuh: DType).
# DTYPE_CODES: the float types; most kernels take COMPUTE_DTYPES (f32 and
# bf16); K4, K4b, K5, K10a, K6, K10b, K12q and K12d take FLOAT_DTYPES (f16
# too), and so do K1 (f16 x: kernels/quantization/gemm.py's
# MAGIC_SCALE_DTYPES), K2, K3 and K7 (KV_DTYPE_PAIRS). STORAGE_CODES adds
# the int8 / e4m3 elements of quantized KV caches.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
FLOAT_DTYPES = (*COMPUTE_DTYPES, torch.float16)
STORAGE_CODES = {**DTYPE_CODES, torch.int8: 3, torch.float8_e4m3fn: 4}
# Element types of KV caches quantized on store (K2), read by K3, K7, K11.
QUANTIZED_CACHE_DTYPES = (torch.int8, torch.float8_e4m3fn)
# The (activation, cache) dtypes K2 stores and K3 and K7 read on the card
# (csrc/common.cuh: dispatch_act_cache): f32 keys or queries over f32,
# bf16 or 1-byte caches; bf16 and f16 ones over their own type or 1-byte
# caches.
KV_DTYPE_PAIRS = {
    torch.float32: (torch.float32, torch.bfloat16, *QUANTIZED_CACHE_DTYPES),
    torch.bfloat16: (torch.bfloat16, *QUANTIZED_CACHE_DTYPES),
    torch.float16: (torch.float16, *QUANTIZED_CACHE_DTYPES),
}


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up(x: int, multiple: int) -> int:
    """Round ``x`` up to the nearest multiple of ``multiple``."""
    return ((x + multiple - 1) // multiple) * multiple


def next_power_of_2(x: int) -> int:
    """Smallest power of two >= x."""
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def build_kernels() -> Path:
    """Compile ``csrc/*.cu`` into the shared library, unless it is newer
    than every source. Returns the library's path.

    One ``nvcc -c`` per source, all running at once (``sm_90a``), then one
    link. Their output (``-Xptxas -v``: registers, shared memory, spills
    per kernel) goes to ``_build/nvcc.log``. The library is written under
    a temporary name and renamed, so concurrent builders never load a
    half-written file.
    """
    sources = sorted(CSRC_DIR.glob("*.cu"))
    inputs = sources + sorted(CSRC_DIR.glob("*.cuh"))
    library = BUILD_DIR / LIBRARY_NAME
    if library.exists() and library.stat().st_mtime >= max(p.stat().st_mtime for p in inputs):
        return library
    BUILD_DIR.mkdir(exist_ok=True)
    tag = os.getpid()
    objects = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    compiles = [
        [envs.CONCH_NVCC, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(sources, objects)
    ]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for cmd in compiles]
    log, failed = [], []
    for cmd, proc in zip(compiles, procs):
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} (exit code {proc.returncode}):\n{out}")
    if not failed:
        partial = BUILD_DIR / f"{LIBRARY_NAME}.{tag}.partial"
        link = [envs.CONCH_NVCC, *ARCH_FLAGS, "-shared", "-o", str(partial), *map(str, objects)]
        proc = subprocess.run(link, capture_output=True, text=True, check=False)
        log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link (exit code {proc.returncode}):\n{proc.stderr}")
    (BUILD_DIR / "nvcc.log").write_text("\n".join(log))
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        msg = "nvcc failed:\n" + "\n".join(failed)
        raise RuntimeError(msg)
    os.replace(partial, library)
    return library


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process.
    Raises on a device that is not Hopper: the library holds sm_90a code only."""
    platform = current_platform()
    if not platform.is_hopper():
        msg = f"the kernels are built for sm_90a (Hopper); device {platform.device_name} has capability {platform.capability}"
        raise RuntimeError(msg)
    return ctypes.CDLL(str(build_kernels()))


@functools.cache
def kernel_function(name: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """One C entry point with its argument types declared (once per name).

    Pointers and the stream must be ``ctypes.c_void_p``: undeclared, ctypes
    would pass them as 32-bit ints and cut them.
    """
    fn = getattr(kernel_library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_launch(name: str, code: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if code != 0:
        msg = f"{name}: kernel launch failed with cudaError_t {code}"
        raise RuntimeError(msg)


@functools.cache
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of CUDA device ``device_index``."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def stream_of(tensor: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``tensor``'s device."""
    return torch.cuda.current_stream(tensor.device).cuda_stream


def dtype_code(tensor: torch.Tensor, dtypes: tuple[torch.dtype, ...] = COMPUTE_DTYPES) -> int:
    """The C entry points' code for ``tensor``'s dtype, one of the
    ``dtypes`` the kernel takes; raises on others."""
    if tensor.dtype not in dtypes:
        names = ", ".join(str(d).removeprefix("torch.") for d in dtypes)
        msg = f"this CUDA kernel takes {names}, got {tensor.dtype}"
        raise NotImplementedError(msg)
    return DTYPE_CODES[tensor.dtype]


def storage_code(tensor: torch.Tensor) -> int:
    """The C entry points' code for ``tensor``'s storage dtype (STORAGE_CODES);
    raises on others."""
    code = STORAGE_CODES.get(tensor.dtype)
    if code is None:
        msg = f"no CUDA kernel stores {tensor.dtype}"
        raise NotImplementedError(msg)
    return code


def check_kv_dtypes(name: str, act: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor) -> None:
    """Raise unless the kernel ``name`` (K2, K3 or K7) takes the keys' or
    queries' dtype over the caches' (``KV_DTYPE_PAIRS``; both caches of one
    dtype), naming the rule."""
    caches = KV_DTYPE_PAIRS.get(act.dtype, ())
    if k_cache.dtype not in caches or v_cache.dtype != k_cache.dtype:
        rule = "; ".join(
            f"{str(a).removeprefix('torch.')} over {', '.join(str(c).removeprefix('torch.') for c in cs)}"
            for a, cs in KV_DTYPE_PAIRS.items()
        )
        msg = (
            f"{name} kernel: takes {rule} (activations over caches of one dtype), got {act.dtype} over "
            f"{k_cache.dtype}/{v_cache.dtype}"
        )
        raise NotImplementedError(msg)


def aligned16(*tensors: torch.Tensor) -> bool:
    """Whether every tensor's data starts on a 16-byte boundary (the
    kernels' vector paths need it)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def require_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        msg = f"kernel inputs must share one CUDA device, got {sorted(map(str, devices))}"
        raise ValueError(msg)


def check_rows(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless the 2-D tensors lie on one CUDA device, share a dtype,
    and have contiguous rows (any row stride)."""
    require_cuda(*tensors)
    if any(t.stride(1) != 1 for t in tensors) or len({t.dtype for t in tensors}) != 1:
        msg = f"{name} kernel: rows must be contiguous and of one dtype"
        raise ValueError(msg)
