# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""K13c's and K13b's launch plans, on the CPU, against what the kernels do.

K13c (``conch_tpu_torch/kernels/vision/nms.py:nms_plan``, ``csrc/nms.cu``):
the suppression mask's upper triangle is stored band-major (band w: the 64
rows of word w, columns w .. W - 1, rows padded to an even number of
words), each band in chunks that one TMA bulk copy moves, and the scan
keeps a ring of chunk slots in shared memory. The tests walk the mask
kernel's stores (row, column tile) -> word as ``nms_mask_kernel`` computes
them and the scan's reads as it streams the chunks, and check that they
meet, that no word is written twice or left out, that every chunk is
16-byte aligned and whole, and that the scan fits the H100's 227 KB.

K13b (``kernels/vision/bev_pool.py:bev_backward_blocks``, ``csrc/bev_pool.cu``):
a block takes 256 consecutive points and a warp 32 of them; the warp finds
the interval of its first point by one 32-way search over the starts and a
step back over empty intervals, the intervals starting among its points
mark slots, and a prefix maximum gives each point its interval.
``kernel_sources`` below repeats that resolve step for step, for warps
starting at every point; its source row for every point must equal the one the plain
backward (``reference/vision/vision.py:bev_pool_backward``) copies, on the
cases where a search can go wrong: a zero-length interval sharing its
start with a real one (before or after it), intervals starting at or past
the last point, a negative start, a dropped interval between two intervals
of one cell, gaps, an end past the last point. One small case holds the
port's plain backward against the JAX package's sorted backward (Pallas in
interpret mode) on zero-length intervals that share a start.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conch_tpu.ops.vision as jv
from conch_tpu_torch.kernels.vision.bev_pool import BWD_BLOCK_POINTS, bev_backward_blocks
from conch_tpu_torch.kernels.vision.nms import (
    CHUNK_WORDS,
    MAX_BOXES,
    MAX_STAGES,
    SMEM_LIMIT,
    TILE,
    band_offset,
    band_row_words,
    nms_plan,
)
from conch_tpu_torch.reference.vision.vision import bev_pool_backward, interval_cells
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

NMS_SIZES = (1, 63, 64, 65, 513, 4096, MAX_BOXES)


# --- K13c ---------------------------------------------------------------------


def mask_store(plan, row: int, col_tile: int) -> int:
    """The word nms_mask_kernel stores for (row, column tile), as it computes it."""
    row_tile, r = divmod(row, TILE)
    j = col_tile - row_tile
    chunk, jj = divmod(j, plan.chunk_words)
    width = min(plan.chunk_words, band_row_words(plan.words, row_tile) - chunk * plan.chunk_words)
    return band_offset(plan.words, row_tile) + TILE * chunk * plan.chunk_words + r * width + jj


def chunk_offset(plan, w: int, k: int) -> tuple[int, int]:
    """(first word, columns) of chunk k of band w, as the scan's producer
    computes them: 64 rows of that many words, one contiguous run."""
    return (band_offset(plan.words, w) + TILE * k * plan.chunk_words,
            min(plan.chunk_words, band_row_words(plan.words, w) - k * plan.chunk_words))


def scan_chunks(plan):
    """The chunks in the producer's order: (band, chunk, first word, columns)."""
    for w in range(plan.words):
        for k in range(-(-band_row_words(plan.words, w) // plan.chunk_words)):
            yield (w, k, *chunk_offset(plan, w, k))


@pytest.mark.parametrize("n", NMS_SIZES)
def test_nms_plan_fits_the_card(n):
    plan = nms_plan(n)
    assert plan.words == -(-n // TILE)
    assert plan.chunk_words % 2 == 0 and 2 <= plan.chunk_words <= CHUNK_WORDS
    assert plan.chunk_words == min(band_row_words(plan.words, 0), CHUNK_WORDS)
    assert 2 <= plan.stages <= MAX_STAGES
    assert plan.stage_bytes == TILE * plan.chunk_words * 8
    ring, removed = plan.stages * plan.stage_bytes, 8 * (plan.words + plan.words % 2)
    assert plan.smem_bytes == ring + removed + 16 + 8 * (2 * plan.stages + 4)
    assert plan.smem_bytes <= SMEM_LIMIT
    # One more slot would not fit, unless the ring is at its cap.
    assert plan.stages == MAX_STAGES or plan.smem_bytes + plan.stage_bytes + 16 > SMEM_LIMIT


@pytest.mark.parametrize("n", NMS_SIZES)
def test_nms_bands_tile_the_triangle(n):
    """Bands follow one another with no gap, rows of an even number of words;
    each band's chunks tile it, every chunk 16-byte aligned and a multiple of
    16 bytes; the closed-form offsets are the sums; the scratch is the
    triangle's words."""
    plan = nms_plan(n)
    words, offset, total = plan.words, 0, 0
    for w in range(words):
        row_words = band_row_words(words, w)
        assert row_words % 2 == 0 and words - w <= row_words <= words - w + 1
        assert band_offset(words, w) == offset
        offset += TILE * row_words
    assert plan.mask_words == offset
    assert offset <= TILE * words * (words + 2) // 2 + TILE * words  # half the (N, W) mask and the pads
    for w, k, first, width in scan_chunks(plan):
        assert first == (total if k else band_offset(words, w))
        assert width >= 2 and width % 2 == 0 and width <= plan.chunk_words
        assert (first * 8) % 16 == 0 and (TILE * width * 8) % 16 == 0
        assert TILE * width * 8 <= plan.stage_bytes
        total = first + TILE * width
    assert total == plan.mask_words


@pytest.mark.parametrize("n", (1, 63, 64, 65, 513, 1000, 4097, 5000))
def test_nms_mask_stores_meet_the_scan(n):
    """Every word the mask kernel stores is one the scan reads where it
    expects it (row r of band w, word v at chunk (v - w) // chunk_words),
    no two stores share a word, and the stores with the odd rows' pads
    cover the whole scratch."""
    plan = nms_plan(n)
    words, written = plan.words, {}
    chunks = {(w, k): (first, width) for w, k, first, width in scan_chunks(plan)}
    for row_tile in range(words):
        for col_tile in range(row_tile, words):
            j = col_tile - row_tile
            first, width = chunks[(row_tile, j // plan.chunk_words)]
            for r in range(TILE):
                addr = mask_store(plan, row_tile * TILE + r, col_tile)
                assert addr == first + r * width + j % plan.chunk_words
                written[addr] = written.get(addr, 0) + 1
                if col_tile == words - 1 and j % plan.chunk_words + 1 < width:
                    written[addr + 1] = written.get(addr + 1, 0) + 1  # the pad word
    assert set(written.values()) == {1}
    assert sorted(written) == list(range(plan.mask_words))


def test_nms_plan_streams_large_bands():
    """Bands wider than a slot stream in chunks (4097 boxes on); at the
    limit the removed bitmap and five 32 KB slots fit."""
    assert len(list(scan_chunks(nms_plan(4096)))) == 64
    assert nms_plan(4097).chunk_words == CHUNK_WORDS < band_row_words(nms_plan(4097).words, 0)
    big = nms_plan(MAX_BOXES)
    assert big.words == 6144 and big.stages == 5 and big.chunk_words == CHUNK_WORDS
    assert -(-band_row_words(big.words, 0) // big.chunk_words) == 96
    with pytest.raises(NotImplementedError):
        nms_plan(MAX_BOXES + 1)


# --- K13b ---------------------------------------------------------------------


def kernel_sources(starts, lengths, cells, num_points, p0):
    """bev_pool_bwd_kernel's resolve for the warp whose first point is p0,
    step for step: (the source row of each of its points, -1 for zeros; the
    interval p0 takes, or -1)."""
    ni, lanes = len(starts), np.arange(32)
    lo, hi = 0, ni
    while lo < hi:
        step = -(-(hi - lo) // 32)
        probes = lo + (lanes + 1) * step - 1
        hits = [bool(p >= hi or starts[p] >= p0) for p in probes]
        if not any(hits):
            lo = hi
        else:
            f = hits.index(True)
            lo, hi = lo + f * step, min(hi, lo + (f + 1) * step - 1)
    first, cur, base = lo, -1, lo - 1
    while base >= 0:
        nonempty = [bool(i >= 0 and lengths[i] > 0) for i in base - lanes]
        if any(nonempty):
            cur = base - nonempty.index(True)
            break
        base -= 32
    slots = {}
    while first < ni:
        idx = first + lanes
        in_tile = [bool(i < ni and starts[i] < p0 + 32) for i in idx]
        count = 32 if all(in_tile) else in_tile.index(False)
        for i in idx[:count]:
            if lengths[i] > 0 and starts[i] >= p0:
                slots[int(starts[i]) - p0] = (int(starts[i]) + int(lengths[i]), int(cells[i]), int(i))
        first += count
        if count < 32:
            break
    current = (int(starts[cur]) + int(lengths[cur]), int(cells[cur]), cur) if cur >= 0 else (-1, -1, -1)
    src, taken = [], None
    for lane in range(min(32, num_points - p0)):
        current = slots.get(lane, current)
        end, cell, interval = current
        src.append(cell if p0 + lane < end else -1)
        if lane == 0:
            taken = interval if p0 < end else -1
    return np.asarray(src), taken


def plain_sources(starts, lengths, geom, grid, num_points):
    """The cell row the plain backward copies to each point (-1: zeros): its
    output for a gradient whose cell c holds c + 1 (f64, exact)."""
    rows = torch.arange(1, int(np.prod(grid)) + 1, dtype=torch.float64).reshape(*grid, 1)
    out = bev_pool_backward(rows, torch.from_numpy(geom), torch.from_numpy(starts), torch.from_numpy(lengths),
                            num_points)
    return out[:, 0].long().numpy() - 1


def holding_interval(starts, lengths, p):
    """The non-empty interval that holds point p, or -1."""
    held = [i for i, (s, ln) in enumerate(zip(starts, lengths)) if ln > 0 and s <= p < s + ln]
    assert len(held) <= 1
    return held[0] if held else -1


def trap_case(num_points=300, grid=(1, 1, 8, 8), seed=0):
    """Ascending, disjoint intervals over ``num_points`` points with every
    trap: points before the first interval, a negative start, zero-length
    intervals sharing a start before and after a real one (and inside a
    gap), gaps, a dropped interval (batch past the end) between two
    intervals of one cell, a dropped x, an end past the last point, and
    intervals starting at and past it."""
    rng = np.random.default_rng(seed)
    starts, lengths, cells = [-4], [7], [5]  # negative start: points 0 .. 2
    p = 6  # points 3 .. 5 before the next interval
    while p < num_points - 80:
        kind, length, cell = int(rng.integers(0, 6)), int(rng.integers(1, 40)), int(rng.integers(0, 64))
        if kind == 0:  # an empty interval, then a real one at its start
            starts += [p, p]
            lengths += [0, length]
            cells += [cell, cell]
        elif kind == 1:  # a real interval, then an empty one at its start
            starts += [p, p]
            lengths += [length, 0]
            cells += [cell, cell]
        elif kind == 2:  # a gap of up to 4 points with an empty interval in it
            length = int(rng.integers(1, 5))
            starts.append(p + length - 1)
            lengths.append(0)
            cells.append(0)
        else:
            starts.append(p)
            lengths.append(length)
            cells.append(cell)
        p += length
    # a dropped interval between two intervals of one cell, then a dropped x
    for length, cell in ((5, 60), (4, -1), (6, 60), (3, -2)):
        starts.append(p)
        lengths.append(length)
        cells.append(cell)
        p += length
    starts += [p + 2, num_points, num_points + 3]  # the last runs past the points; two start at or after them
    lengths += [num_points, 4, 2]
    cells += [9, 10, 11]
    starts, lengths = np.asarray(starts, dtype=np.int32), np.asarray(lengths, dtype=np.int32)
    assert (np.diff(starts) >= 0).all()
    geom = np.zeros((num_points, 4), dtype=np.int32)
    for s, ln, cell in zip(starts, lengths, cells):
        lo, hi = max(s, 0), min(s + ln, num_points)
        if cell == -1:
            geom[lo:hi] = (0, 0, 0, 1)  # batch past the end
        elif cell == -2:
            geom[lo:hi] = (-1, 0, 0, 0)
        else:
            geom[lo:hi] = (cell // grid[3], cell % grid[3], 0, 0)
    return starts, lengths, geom, grid


def source_cells(starts, lengths, geom, grid, num_points):
    """bev_cell of each interval: its flat cell, or -1 when it is dropped."""
    cells, valid = interval_cells(torch.from_numpy(geom), torch.from_numpy(starts), *grid)
    return torch.where(valid, cells, -1).numpy()


@pytest.mark.parametrize("num_points", (1, 255, 256, 257, 1000, 1_630_118))
def test_bev_backward_blocks_cover_the_points(num_points):
    """A block for every 256 points, in point order; no block without points."""
    blocks = bev_backward_blocks(num_points)
    assert (blocks - 1) * BWD_BLOCK_POINTS < num_points <= blocks * BWD_BLOCK_POINTS


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("every", (1, 3, 32))
def test_bev_backward_resolve_matches_plain(seed, every):
    """Warps starting at every point (``every`` 1), or as the kernel places
    them (every 32): each warp's first point takes the interval that holds
    it, and each of its points the plain backward's source row."""
    starts, lengths, geom, grid = trap_case(seed=seed)
    num_points = geom.shape[0]
    cells = source_cells(starts, lengths, geom, grid, num_points)
    plain = plain_sources(starts, lengths, geom, grid, num_points)
    for p0 in range(0, num_points, every):
        src, taken = kernel_sources(starts, lengths, cells, num_points, p0)
        assert taken == holding_interval(starts, lengths, p0), f"warp at point {p0}"
        np.testing.assert_array_equal(src, plain[p0 : p0 + 32], err_msg=f"warp at point {p0}")


def test_bev_backward_resolve_matches_plain_on_many_intervals():
    """3000 points in about 200 intervals: searches of several rounds."""
    starts, lengths, geom, grid = trap_case(num_points=3000, seed=7)
    num_points = geom.shape[0]
    cells = source_cells(starts, lengths, geom, grid, num_points)
    src = np.concatenate([kernel_sources(starts, lengths, cells, num_points, p0)[0]
                          for p0 in range(0, num_points, 32)])
    np.testing.assert_array_equal(src, plain_sources(starts, lengths, geom, grid, num_points))


def test_bev_plain_backward_matches_jax_on_shared_starts(rng):
    """Zero-length intervals sharing a start with a real one, before and
    after it, through the port's plain backward and the JAX sorted backward."""
    starts = np.asarray([0, 3, 3, 7, 7, 10, 12], dtype=np.int32)
    lengths = np.asarray([3, 0, 4, 3, 0, 0, 4], dtype=np.int32)
    num_points, grid = 16, (1, 1, 4, 4)
    geom = np.zeros((num_points, 4), dtype=np.int32)
    for s, ln, cell in zip(starts, lengths, (1, 2, 2, 6, 9, 11, 14)):
        geom[s : s + max(ln, 1)] = (cell // 4, cell % 4, 0, 0)
    grad = rng.normal(size=(*grid, 8)).astype(np.float32)
    out = bev_pool_backward(torch.from_numpy(grad), torch.from_numpy(geom), torch.from_numpy(starts),
                            torch.from_numpy(lengths), num_points)
    ref = jv.bev_pool_backward(jnp.asarray(grad), jnp.asarray(geom), jnp.asarray(starts), jnp.asarray(lengths),
                               cells_sorted=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
