# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""The collectives layer (counterpart of ``conch_tpu/parallel``, as far as
it is ported: the mesh and the ring collectives; the sharding helpers are
not ported yet)."""

from conch_tpu_torch.parallel.collectives import (
    overlapped_allgather_matmul,
    overlapped_matmul_reduce_scatter,
    ppermute,
    ring_all_gather,
)
from conch_tpu_torch.parallel.mesh import Mesh, create_mesh

__all__ = [
    "Mesh",
    "create_mesh",
    "overlapped_allgather_matmul",
    "overlapped_matmul_reduce_scatter",
    "ppermute",
    "ring_all_gather",
]
