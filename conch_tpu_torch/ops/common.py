# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Shared helpers for the public ops layer."""

from __future__ import annotations

# The JAX package computes row ops of at most this many rows outside any
# Pallas kernel on a chip (conch_tpu/ops/common.py:fuse_small_op); above
# it, rms_norm (K4) and silu_and_mul (K6) are kernels that are not ported
# yet, so the port refuses those sizes instead of running plain code there.
SMALL_OP_TOKEN_THRESHOLD = 128


def check_small_op(rows: int, op: str, kernel: str) -> None:
    """Raise ``NotImplementedError`` above the small-op threshold."""
    if rows > SMALL_OP_TOKEN_THRESHOLD:
        msg = (
            f"{op} on {rows} rows needs its kernel ({kernel}), which is not ported yet; "
            f"the port takes at most {SMALL_OP_TOKEN_THRESHOLD} rows per call"
        )
        raise NotImplementedError(msg)
