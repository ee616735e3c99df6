# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Environment flags read by the port (evaluated on attribute access)."""

import os
from collections.abc import Callable
from typing import Any

environment_variables: dict[str, Callable[[], Any]] = {
    # The CUDA compiler that builds csrc/*.cu (kernels/common.py).
    "CONCH_NVCC": lambda: os.getenv(
        "CONCH_NVCC", os.path.join(os.getenv("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    ),
    # Serve with the native C++ block allocator (native.py; built at first
    # use, and a failed build raises).
    "CONCH_ENABLE_CPP_EXT": lambda: bool(int(os.getenv("CONCH_ENABLE_CPP_EXT", "0"))),
    # The C++ compiler that builds ext/*.cc (native.py).
    "CONCH_CXX": lambda: os.getenv("CONCH_CXX", "g++"),
}


def __getattr__(name: str) -> Any:
    if name in environment_variables:
        return environment_variables[name]()
    msg = f"module {__name__!r} has no attribute {name!r}"
    raise AttributeError(msg)


def __dir__() -> list[str]:
    return list(environment_variables.keys())
