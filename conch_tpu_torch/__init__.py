# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Conch-TPU's port to PyTorch and CUDA on an NVIDIA H100.

A package beside ``conch_tpu`` (the JAX/Pallas reference, left as it is).
Plain tensor code is PyTorch; every Pallas kernel that the ported path
launches is a hand-written Hopper kernel under ``csrc/``, built with
``nvcc`` on first use and bound with ``ctypes`` (``kernels/common.py``).
Module names mirror ``conch_tpu`` so each counterpart is easy to find.

Entry points take ``device=None``, meaning ``"cuda"``; without a CUDA
device they raise unless the caller passes ``device="cpu"``, which runs
each kernel's plain PyTorch version (the CPU tests do this).
"""
