# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Device meshes (counterpart of ``conch_tpu/parallel/mesh.py``).

A ``Mesh`` is a ``(data, model)`` grid of ``torch.device``s with the JAX
package's axis names: ``data`` for data parallelism, ``model`` for
tensor parallelism, innermost so that a tensor-parallel ring is a row of
the grid. The same device may be listed more than once: that gives a ring
of virtual ranks on one card, the counterpart of the JAX tests' virtual
CPU devices (``--xla_force_host_platform_device_count``). For example
``create_mesh(model=8, devices=[torch.device("cuda:0")] * 8)`` is an
8-rank ring on one H100, each rank with buffers of its own.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass

import torch

from conch_tpu_torch.platforms.platform import resolve_device

AXIS_NAMES = ("data", "model")


@dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of devices."""

    devices: tuple[tuple[torch.device, ...], ...]
    axis_names: tuple[str, str] = AXIS_NAMES

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, (len(self.devices), len(self.devices[0]))))

    def axis_devices(self, axis_name: str, index: int = 0) -> list[torch.device]:
        """The ranks along ``axis_name`` at position ``index`` of the other
        axis: one ring, rank ``r`` at position ``r``."""
        if axis_name == "model":
            return list(self.devices[index])
        if axis_name == "data":
            return [row[index] for row in self.devices]
        msg = f"unknown mesh axis {axis_name!r}; expected one of {self.axis_names}"
        raise ValueError(msg)


def create_mesh(data: int = 1, model: int = 1, devices: Sequence[torch.device | str] | None = None) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: every CUDA device),
    ``model`` the minor axis. Raises if there are fewer than ``data *
    model`` devices."""
    if data < 1 or model < 1:
        msg = f"Mesh {data}x{model}: both axes need at least one device"
        raise ValueError(msg)
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if data * model > len(devices):
        msg = f"Mesh {data}x{model} needs {data * model} devices, have {len(devices)}"
        raise ValueError(msg)
    flat = [resolve_device(d) for d in devices[: data * model]]
    return Mesh(tuple(tuple(flat[i * model : (i + 1) * model]) for i in range(data)))
