# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Ring all-gather (K14): the CUDA kernel's launcher and its plain version.

``csrc/ring_all_gather.cu`` replaces
``conch_tpu/kernels/collectives/ring_all_gather.py:_ring_all_gather_kernel``
with the same protocol: an entry barrier with both neighbours, the own
chunk into its own slot, then n - 1 ring steps that forward one slot each
into the right neighbour's output, each step closed by a flag.

The launcher takes the ring's n shards (each ``(rows, cols)``, one dtype,
one shape) and returns n tensors of ``(n * rows, cols)``, one per rank on
the rank's device; row block ``j`` of each is rank ``j``'s shard, as in
JAX. On the CPU it takes the plain version (``torch.cat`` per rank). On
CUDA it launches K14 or raises. All shards on one card form a ring of
virtual ranks, the counterpart of the JAX tests' virtual CPU devices
(``--xla_force_host_platform_device_count``); shards on distinct cards
raise ``NotImplementedError``, since that needs peer access
(``cudaDeviceEnablePeerAccess``, then one launch per card), which the
kernel's address table already allows.

Launch modes: one cooperative launch for the whole ring (the default), or
with ``rank_streams``, one launch per rank on that rank's stream, ordered
after the caller's stream and the caller's stream after them. Each ring
(device, size, blocks per rank, caller's stream) owns a flag buffer that
is never reset: every call passes a larger epoch, counted on the host.
Calls from one stream are ordered, so their epochs reach the card in
order; calls from two streams use two buffers. A CUDA graph would replay
one captured epoch, so capture is refused. A wait that times out after
``TIMEOUT_S`` sets the device's error word (``ring_error``) and ends the
kernel instead of hanging, leaving the outputs partly unwritten:
``check_ring_error`` turns the word into an exception.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence
from dataclasses import dataclass

import torch

from conch_tpu_torch.kernels.common import cdiv, check_launch, kernel_function, sm_count
from conch_tpu_torch.reference.collectives.ring_all_gather import ring_all_gather as ring_all_gather_plain

__all__ = [
    "check_ring_error",
    "decode_ring_error",
    "reset_ring_error",
    "ring_all_gather_launcher",
    "ring_all_gather_plain",
    "ring_error",
]

MAX_RANKS = 64  # csrc/ring_all_gather.cu: kMaxRanks
TIMEOUT_S = 2.0  # bound of every wait on a flag
_BYTES_PER_BLOCK = 64 * 1024  # a chunk's bytes per block before another block joins


@dataclass
class _Ring:
    flags: torch.Tensor  # (n * blocks * (n + 1),) 64-bit flags, zero at first
    epoch: int = 0


_RINGS: dict[tuple[int, int, int, int], _Ring] = {}
_ERROR_WORDS: dict[int, torch.Tensor] = {}


def _error_word(device: torch.device) -> torch.Tensor:
    word = _ERROR_WORDS.get(device.index)
    if word is None:
        word = _ERROR_WORDS[device.index] = torch.zeros(1, dtype=torch.int32, device=device)
    return word


def _device_index(device: torch.device | str | int | None) -> int:
    if isinstance(device, int):
        return device
    index = None if device is None else torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def ring_error(device: torch.device | str | int | None = None) -> int:
    """The error word of ``device``'s rings (synchronizes): 0, or the code of
    the first wait that timed out since the last reset (``decode_ring_error``)."""
    word = _ERROR_WORDS.get(_device_index(device))
    return 0 if word is None else int(word.item())


def reset_ring_error(device: torch.device | str | int | None = None) -> None:
    """Clear ``device``'s error word (on the current stream)."""
    word = _ERROR_WORDS.get(_device_index(device))
    if word is not None:
        word.zero_()


def check_ring_error(device: torch.device | str | int | None = None) -> None:
    """Raise ``RuntimeError`` if a wait on ``device`` timed out since the
    last check (synchronizes). The word is cleared first, so the next call
    starts clean; the outputs of the call that timed out are partly
    unwritten and must not be used."""
    code = ring_error(device)
    if code:
        reset_ring_error(device)
        msg = f"ring all-gather kernel: {decode_ring_error(code)}; its outputs are incomplete"
        raise RuntimeError(msg)


def decode_ring_error(code: int) -> str:
    """A readable account of an error word's value."""
    if code == 0:
        return "no error"
    rank, block, stage = (code >> 16) & 0xFF, (code >> 8) & 0xFF, code & 0xFF
    where = "the entry barrier" if stage == 0 else f"ring step {stage - 1}"
    return f"rank {rank}, block {block} timed out waiting in {where}"


def _check_shards(shards: Sequence[torch.Tensor]) -> None:
    if not shards:
        raise ValueError("ring all-gather: no shards")
    first = shards[0]
    if first.dim() != 2 or any(s.shape != first.shape or s.dtype != first.dtype for s in shards):
        shapes = sorted({(tuple(s.shape), str(s.dtype)) for s in shards})
        msg = f"ring all-gather: shards must be 2-D (rows, cols) of one shape and dtype, got {shapes}"
        raise ValueError(msg)


def _ring(device: torch.device, n: int, blocks: int, stream: int) -> _Ring:
    key = (device.index, n, blocks, stream)
    ring = _RINGS.get(key)
    if ring is None:
        ring = _RINGS[key] = _Ring(torch.zeros(n * blocks * (n + 1), dtype=torch.int64, device=device))
    return ring


def _blocks_per_rank(chunk_bytes: int, n: int, device: torch.device) -> int:
    """Enough blocks to keep the copies in flight, no more blocks in all than
    SMs, so every rank's blocks are resident together in either mode."""
    return max(1, min(cdiv(chunk_bytes, _BYTES_PER_BLOCK), sm_count(device.index) // n))


def _ring_cuda(shards: list[torch.Tensor], rank_streams: Sequence[torch.cuda.Stream] | None) -> list[torch.Tensor]:
    devices = {s.device for s in shards}
    if any(d.type != "cuda" for d in devices):
        msg = f"ring all-gather: shards lie on {sorted(map(str, devices))}; all on the CPU or all on CUDA"
        raise ValueError(msg)
    if len(devices) > 1:
        msg = (
            "ring all-gather kernel: shards on distinct CUDA devices need peer access, which is not ported yet "
            "(ROADMAP Queue 1 item 8: parallel, training and multiple GPUs); put every rank on one card "
            "(a ring of virtual ranks)"
        )
        raise NotImplementedError(msg)
    n = len(shards)
    if n > MAX_RANKS:
        msg = f"ring all-gather kernel: at most {MAX_RANKS} ranks, got {n}"
        raise NotImplementedError(msg)
    if any(not s.is_contiguous() for s in shards):
        raise ValueError("ring all-gather kernel: shards must be contiguous")
    if rank_streams is not None and len(rank_streams) != n:
        msg = f"ring all-gather kernel: {len(rank_streams)} rank streams for {n} ranks"
        raise ValueError(msg)
    if torch.cuda.is_current_stream_capturing():
        msg = (
            "ring all-gather kernel: not under CUDA graph capture, since every replay would reuse the "
            "captured epoch and pass its waits before the neighbours have written"
        )
        raise RuntimeError(msg)
    device = shards[0].device
    rows, cols = shards[0].shape
    outputs = [torch.empty((n * rows, cols), dtype=shards[0].dtype, device=device) for _ in range(n)]
    chunk_bytes = shards[0].numel() * shards[0].element_size()
    if chunk_bytes == 0:
        return outputs
    blocks = _blocks_per_rank(chunk_bytes, n, device)
    caller = torch.cuda.current_stream(device)
    ring = _ring(device, n, blocks, caller.cuda_stream)
    ring.epoch += 1
    word = ring.flags.element_size() * blocks * (n + 1)
    pointers = ctypes.c_void_p * n
    inputs = pointers(*(s.data_ptr() for s in shards))
    outs = pointers(*(o.data_ptr() for o in outputs))
    flags = pointers(*(ring.flags.data_ptr() + r * word for r in range(n)))
    error = _error_word(device).data_ptr()
    fn = kernel_function("conch_ring_all_gather", (
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_void_p,
    ))
    timeout_ns = int(TIMEOUT_S * 1e9)

    def launch(rank: int, stream: int) -> None:
        code = fn(inputs, outs, flags, error, n, rank, chunk_bytes, blocks, ring.epoch, timeout_ns, stream)
        check_launch("conch_ring_all_gather", code)
        ring_all_gather_launcher.launches += 1

    if rank_streams is None:
        launch(-1, caller.cuda_stream)
        return outputs
    ready = caller.record_event()
    for rank, stream in enumerate(rank_streams):
        stream.wait_event(ready)
        launch(rank, stream.cuda_stream)
    for stream in rank_streams:
        caller.wait_event(stream.record_event())
    return outputs


def ring_all_gather_launcher(
    shards: Sequence[torch.Tensor], *, rank_streams: Sequence[torch.cuda.Stream] | None = None
) -> list[torch.Tensor]:
    """All-gather of the ring's ``(rows, cols)`` shards along rows: rank
    ``r``'s result is the ``(n * rows, cols)`` concatenation, any dtype.

    Args:
        shards: rank ``r``'s shard at position ``r``; all on the CPU (the
            plain version) or all on one CUDA device (K14).
        rank_streams: None for one cooperative launch of the whole ring on
            the current stream; else n CUDA streams, one launch per rank on
            its own stream.

    Blocks per rank follow the chunk's size. The launch is asynchronous:
    a wait that timed out shows only in the error word (``ring_error``,
    ``check_ring_error``). ``launches`` counts kernel launches (n per call
    with ``rank_streams``).
    """
    shards = list(shards)
    _check_shards(shards)
    if all(s.device.type == "cpu" for s in shards):
        return ring_all_gather_plain(shards)
    return _ring_cuda(shards, rank_streams)


ring_all_gather_launcher.launches = 0
