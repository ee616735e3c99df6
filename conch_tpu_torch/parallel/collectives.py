# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Ring collectives and the collective matmuls (counterpart of
``conch_tpu/parallel/collectives.py``).

JAX writes these per device inside ``shard_map``; the port writes them
over the whole ring at once, PyTorch's single-process idiom for several
devices (as ``torch.cuda.comm``): a list of per-rank shards in, a list of
per-rank results out, rank ``r``'s tensors at position ``r`` on rank
``r``'s device. ``ppermute`` is the rotation of the list by one hop: each
rank's tensor is copied to the next rank's device, a real copy even when
two ranks share a card, so no rank aliases another's buffer.

``ring_all_gather`` runs the hand-scheduled ring kernel (K14,
``kernels/collectives/ring_all_gather.py``), which computes what JAX's
``ppermute`` ring computes. The collective matmuls keep JAX's arithmetic
order exactly: each hop's partial product in f32 (bf16 operands upcast,
as ``preferred_element_type=jnp.float32``; torch's default f32 matmul
precision, never TF32), the partials added in JAX's hop order, one cast
at the end. Their products are ``torch.matmul``, as JAX leaves them to
XLA. On virtual ranks nothing overlaps; the hops only show the order.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from conch_tpu_torch.kernels.collectives.ring_all_gather import check_ring_error, ring_all_gather_launcher


def ppermute(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """One ring hop (JAX's ``ppermute`` over ``i -> i + 1``): rank ``r``
    receives a copy of rank ``r - 1``'s tensor on its own device."""
    n = len(xs)
    return [xs[(r - 1) % n].to(xs[r].device, copy=True) for r in range(n)]


def ring_all_gather(shards: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """All-gather of the ring's ``(rows, cols)`` shards along rows: rank
    ``r`` gets the ``(n * rows, cols)`` concatenation, row block ``j``
    being rank ``j``'s shard (``lax.all_gather(..., tiled=True)``).

    On CUDA it waits for the kernel and reads its error word: if a rank's
    wait on a neighbour timed out, the outputs are incomplete and it raises
    ``RuntimeError`` (naming the rank, block and step) instead of returning
    them."""
    out = ring_all_gather_launcher(shards)
    if out[0].is_cuda:
        check_ring_error(out[0].device)
    return out


def _dot32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.dot(a, b, preferred_element_type=jnp.float32)``."""
    return torch.matmul(a.float(), b.float())


def _check_ring(name: str, xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor]) -> int:
    n = len(xs)
    if n == 0 or len(ws) != n or any(t.dim() != 2 for t in (*xs, *ws)):
        msg = f"{name}: one 2-D activation and one 2-D weight per rank, got {len(xs)} and {len(ws)}"
        raise ValueError(msg)
    return n


def overlapped_allgather_matmul(x_shards: Sequence[torch.Tensor], w_locals: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``all_gather(x, K axis) @ w_local`` on every rank, hop by hop.

    Args:
        x_shards: rank ``r``'s (m, k_local) K-shard of the activations.
        w_locals: rank ``r``'s (k_global, n_local) column shard of the
            weight, with the full contraction dimension.

    Returns:
        rank ``r``'s (m, n_local) product in x's dtype.
    """
    n = _check_ring("overlapped_allgather_matmul", x_shards, w_locals)
    k_local = x_shards[0].shape[1]
    if any(w.shape[0] != n * k_local for w in w_locals):
        msg = f"overlapped_allgather_matmul: weights need {n} x {k_local} rows, got {[tuple(w.shape) for w in w_locals]}"
        raise ValueError(msg)

    def w_rows(r: int, shard_id: int) -> torch.Tensor:
        return w_locals[r][shard_id * k_local : (shard_id + 1) * k_local]

    acc = [_dot32(x_shards[r], w_rows(r, r)) for r in range(n)]
    cur = list(x_shards)
    for hop in range(1, n):
        cur = ppermute(cur)
        acc = [acc[r] + _dot32(cur[r], w_rows(r, (r - hop) % n)) for r in range(n)]
    return [a.to(x.dtype) for a, x in zip(acc, x_shards)]


def overlapped_matmul_reduce_scatter(
    x_locals: Sequence[torch.Tensor], w_shards: Sequence[torch.Tensor]
) -> list[torch.Tensor]:
    """``reduce_scatter(x_local @ w_shard, N axis)``: the accumulating slice
    walks the ring, each rank adding its partial product before the hop.

    Args:
        x_locals: rank ``r``'s (m, k_local) K-shard of the activations.
        w_shards: rank ``r``'s (k_local, n_global) row shard of the weight,
            with the full output dimension.

    Returns:
        rank ``r``'s (m, n_global // n) N-shard of the summed product, in
        x's dtype.
    """
    n = _check_ring("overlapped_matmul_reduce_scatter", x_locals, w_shards)
    n_global = w_shards[0].shape[1]
    if n_global % n or any(w.shape != w_shards[0].shape for w in w_shards):
        msg = f"overlapped_matmul_reduce_scatter: weights of one shape with N divisible by {n}, got {[tuple(w.shape) for w in w_shards]}"
        raise ValueError(msg)
    n_local = n_global // n

    def w_cols(r: int, block_id: int) -> torch.Tensor:
        return w_shards[r][:, block_id * n_local : (block_id + 1) * n_local]

    acc = None
    for hop in range(n - 1, -1, -1):
        partial = [_dot32(x_locals[r], w_cols(r, (r + hop) % n)) for r in range(n)]
        acc = partial if acc is None else [a + p for a, p in zip(acc, partial)]
        if hop > 0:
            acc = ppermute(acc)
    return [a.to(x.dtype) for a, x in zip(acc, x_locals)]
