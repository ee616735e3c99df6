# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Tracing and profiling helpers (counterpart of ``conch_tpu/utils/profiling.py``).

``trace`` captures a ``torch.profiler`` trace (the CPU, and the CUDA
device where there is one) into a directory, as a Chrome trace that
TensorBoard and Perfetto read; ``annotate`` is a named range in it
(``record_function``); ``profile_fn`` runs one call under a trace and
waits for the device. ``StepTimeline`` is the JAX package's per-step
host-clock recorder, unchanged.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections.abc import Callable
from dataclasses import dataclass, field
from typing import Any

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler


def default_trace_dir() -> str:
    """Where traces go unless a directory is given: under the temporary directory."""
    return os.path.join(tempfile.gettempdir(), "conch_tpu_torch_trace")


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture a torch.profiler trace of the enclosed work into ``log_dir``
    (one ``*.pt.trace.json`` a capture); yields the directory."""
    log_dir = log_dir or default_trace_dir()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir


def annotate(name: str):
    """A named range in the trace (a context manager)."""
    return record_function(name)


def profile_fn(fn: Callable[..., Any], *args, log_dir: str | None = None, **kwargs) -> Any:
    """Run ``fn`` once under a trace, waiting for the device before the
    trace ends; returns its result."""
    with trace(log_dir):
        out = fn(*args, **kwargs)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    return out


@dataclass
class StepTimeline:
    """Lightweight per-step latency recorder for the serving engine."""

    events: list[tuple[str, float, float]] = field(default_factory=list)

    @contextlib.contextmanager
    def record(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.events.append((name, t0, time.perf_counter()))

    def summary(self) -> dict[str, dict[str, float]]:
        """Aggregate stats (count, total_s, mean_ms) per event name."""
        agg: dict[str, list[float]] = {}
        for name, t0, t1 in self.events:
            agg.setdefault(name, []).append(t1 - t0)
        return {
            name: {
                "count": len(times),
                "total_s": sum(times),
                "mean_ms": 1e3 * sum(times) / len(times),
            }
            for name, times in agg.items()
        }
