# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""ctypes bindings to the port's native C++ library (counterpart of
``conch_tpu/native.py``): host baselines of the vision ops and the native
block allocator that the engine takes under ``CONCH_ENABLE_CPP_EXT=1``.

The library is built from the port's own sources, ``ext/{bev_pool,
block_allocator,voxelization}.cc``, by one ``g++`` with ``CXX_FLAGS`` (those
of the C++ extension's Makefile) at first use, into ``_build/`` (listed in
``.gitignore``), unless it is newer than every source; ``CONCH_CXX`` names
the compiler. It includes no PyTorch header. A failed build raises: the
engine never falls back to the Python allocator in silence.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from pathlib import Path

import numpy as np

from conch_tpu_torch import envs

_PACKAGE_DIR = Path(__file__).resolve().parent
EXT_DIR = _PACKAGE_DIR / "ext"
BUILD_DIR = _PACKAGE_DIR / "_build"
LIBRARY_NAME = "libconch_native.so"
SOURCES = ("bev_pool.cc", "voxelization.cc", "block_allocator.cc")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")

_I32P = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_F32P = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_I64 = ctypes.c_int64
_F32 = ctypes.c_float


def build_library() -> Path:
    """Compile ``ext/*.cc`` into one shared library under ``BUILD_DIR``,
    unless it is newer than every source. Written under a temporary name
    and renamed, so concurrent builds never load a half-written file.
    Raises ``RuntimeError`` with the compiler's output if the build fails."""
    sources = [EXT_DIR / name for name in SOURCES]
    library = BUILD_DIR / LIBRARY_NAME
    if library.exists() and library.stat().st_mtime >= max(p.stat().st_mtime for p in sources):
        return library
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    partial = BUILD_DIR / f"{LIBRARY_NAME}.{os.getpid()}.partial"
    cmd = [envs.CONCH_CXX, *CXX_FLAGS, "-shared", "-o", str(partial), *map(str, sources), "-lm"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    except OSError as exc:
        msg = f"native library build failed: {' '.join(cmd)}: {exc}"
        raise RuntimeError(msg) from exc
    if proc.returncode != 0:
        partial.unlink(missing_ok=True)
        msg = f"native library build failed (exit code {proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        raise RuntimeError(msg)
    os.replace(partial, library)
    return library


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed), load and type the native library, once per process."""
    lib = ctypes.CDLL(str(build_library()))

    lib.conch_bev_pool_forward.argtypes = [_F32P, _I32P, _I32P, _I32P, _I64, _I64, _I64, _I64, _I64, _F32P]
    lib.conch_bev_pool_forward.restype = None
    lib.conch_bev_pool_backward.argtypes = [_F32P, _I32P, _I32P, _I32P, _I64, _I64, _I64, _I64, _I64, _F32P]
    lib.conch_bev_pool_backward.restype = None

    lib.conch_voxelize.argtypes = [
        _F32P, _I64, _F32, _F32, _F32, _F32, _F32, _F32, _I64, _I64, _I64, _I64, _I64, _F32P, _I32P, _I32P,
    ]
    lib.conch_voxelize.restype = _I64

    lib.conch_allocator_create.argtypes = [_I64]
    lib.conch_allocator_create.restype = ctypes.c_void_p
    lib.conch_allocator_destroy.argtypes = [ctypes.c_void_p]
    lib.conch_allocator_destroy.restype = None
    for name in ("num_free", "allocate"):
        fn = getattr(lib, f"conch_allocator_{name}")
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = _I64
    for name in ("free", "fork", "refcount"):
        fn = getattr(lib, f"conch_allocator_{name}")
        fn.argtypes = [ctypes.c_void_p, _I64]
        fn.restype = _I64
    return lib


# -- vision baselines ------------------------------------------------------


def bev_pool_forward(
    image_feats: np.ndarray,
    geom_feats: np.ndarray,
    interval_starts: np.ndarray,
    interval_lengths: np.ndarray,
    batch_size: int,
    grid_z: int,
    grid_x: int,
    grid_y: int,
) -> np.ndarray:
    """Sum each interval's f32 features into its cell of a zeroed (B, Z, X,
    Y, C) grid (intervals in any order, each point in one)."""
    lib = load_library()
    feats = np.ascontiguousarray(image_feats, dtype=np.float32)
    channels = feats.shape[1]
    out = np.zeros((batch_size, grid_z, grid_x, grid_y, channels), dtype=np.float32)
    lib.conch_bev_pool_forward(
        feats,
        np.ascontiguousarray(geom_feats, dtype=np.int32),
        np.ascontiguousarray(interval_starts, dtype=np.int32),
        np.ascontiguousarray(interval_lengths, dtype=np.int32),
        len(interval_starts), channels, grid_z, grid_x, grid_y,
        out,
    )
    return out


def bev_pool_backward(
    grad_output: np.ndarray,
    geom_feats: np.ndarray,
    interval_starts: np.ndarray,
    interval_lengths: np.ndarray,
    num_points: int,
) -> np.ndarray:
    """Each interval's cell gradient copied to its points; (num_points, C)
    f32, zero for points in no interval."""
    lib = load_library()
    grad = np.ascontiguousarray(grad_output, dtype=np.float32)
    _, grid_z, grid_x, grid_y, channels = grad.shape
    out = np.zeros((num_points, channels), dtype=np.float32)
    lib.conch_bev_pool_backward(
        grad,
        np.ascontiguousarray(geom_feats, dtype=np.int32),
        np.ascontiguousarray(interval_starts, dtype=np.int32),
        np.ascontiguousarray(interval_lengths, dtype=np.int32),
        len(interval_starts), channels, grid_z, grid_x, grid_y,
        out,
    )
    return out


def voxelize(points: np.ndarray, min_range, voxel_dim, grid_dim, max_points_per_voxel: int, max_num_voxels: int):
    """(voxels, features (max_num_voxels, max_points_per_voxel, 4), indices
    (max_num_voxels, 4) as x, y, z, 0, points a voxel): voxels in ascending
    flat-key order, each point's voxel by ``floor((p - min) / dim)``."""
    lib = load_library()
    pts = np.ascontiguousarray(points, dtype=np.float32)
    feats = np.zeros((max_num_voxels, max_points_per_voxel, 4), dtype=np.float32)
    indices = np.zeros((max_num_voxels, 4), dtype=np.int32)
    counts = np.zeros((max_num_voxels,), dtype=np.int32)
    n = lib.conch_voxelize(
        pts, len(pts),
        min_range[0], min_range[1], min_range[2],
        voxel_dim[0], voxel_dim[1], voxel_dim[2],
        grid_dim[0], grid_dim[1], grid_dim[2],
        max_points_per_voxel, max_num_voxels,
        feats, indices, counts,
    )
    return int(n), feats, indices, counts


# -- native block allocator -----------------------------------------------


class NativeBlockAllocator:
    """``BlockAllocator``'s interface over the C++ free list and refcounts,
    with the JAX package's error types and messages: ``MemoryError`` when
    the pool is empty, ``AssertionError`` on a double free or a fork of a
    free page."""

    def __init__(self, num_pages: int) -> None:
        self._lib = load_library()
        self._handle = self._lib.conch_allocator_create(num_pages)
        self.num_pages = num_pages

    def __del__(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.conch_allocator_destroy(self._handle)
            self._handle = None

    @property
    def num_free(self) -> int:
        return self._lib.conch_allocator_num_free(self._handle)

    def allocate(self) -> int:
        page = self._lib.conch_allocator_allocate(self._handle)
        if page < 0:
            msg = "Out of KV-cache pages"
            raise MemoryError(msg)
        return page

    def can_allocate(self, n: int) -> bool:
        return self.num_free >= n

    def free(self, page: int) -> None:
        if self._lib.conch_allocator_free(self._handle, page) < 0:
            msg = f"double free of page {page}"
            raise AssertionError(msg)

    def fork(self, page: int) -> None:
        if self._lib.conch_allocator_fork(self._handle, page) < 0:
            msg = f"fork of unallocated page {page}"
            raise AssertionError(msg)

    def refcount(self, page: int) -> int:
        return self._lib.conch_allocator_refcount(self._handle, page)

    def is_shared(self, page: int) -> bool:
        return self.refcount(page) > 1

    def cow(self, page: int) -> tuple[int, bool]:
        """A writable page for ``page``: itself if not shared, else a fresh
        page (the caller copies) while ``page`` drops one reference."""
        if not self.is_shared(page):
            return page, False
        new_page = self.allocate()
        self._lib.conch_allocator_free(self._handle, page)
        return new_page, True
