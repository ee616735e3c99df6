# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""CUDA detection, the device name, and device resolution.

Counterpart of ``conch_tpu/platforms/platform.py``: where the JAX
package reads the TPU generation, the port reads the CUDA device and its
compute capability. The kernels under ``csrc/`` are built for
``sm_90a`` (Hopper) only.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

HOPPER_CAPABILITY = (9, 0)


@dataclass(frozen=True)
class Platform:
    """What the current process can run on."""

    has_cuda: bool
    device_name: str
    capability: tuple[int, int] | None

    def is_hopper(self) -> bool:
        return self.capability == HOPPER_CAPABILITY


def current_platform() -> Platform:
    """Describe CUDA device 0, or the CPU when no CUDA device exists."""
    if not torch.cuda.is_available():
        return Platform(False, "cpu", None)
    return Platform(True, torch.cuda.get_device_name(0), torch.cuda.get_device_capability(0))


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Resolve an entry point's ``device`` argument.

    ``None`` means CUDA. A CUDA request without a CUDA device raises: the
    port never drops to the CPU unless the caller asks for ``"cpu"``.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            msg = "no CUDA device is available; pass device='cpu' to run the plain PyTorch path"
            raise RuntimeError(msg)
        return device if device.index is not None else torch.device("cuda", torch.cuda.current_device())
    if device.type != "cpu":
        msg = f"unsupported device {device}: the port runs on 'cuda' or 'cpu'"
        raise ValueError(msg)
    return device
