# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""K13c's, K13b's and K13a's launch plans, on the CPU, against what the kernels do.

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

K13a (``kernels/vision/bev_pool.py:bev_forward_plan``, ``csrc/bev_pool.cu``):
a block owns the kept intervals that start in its tile of points and the
runs (kept intervals of one cell) that open among them; its producer warp
reads the intervals 32 at a time and writes pieces of the owned intervals'
rows into a ring of stages (TMA bulk copies where rows are 16-byte
vectors), its consumers sum them in point order, carrying a run's sums
from stage to stage, and the producer zeros the grid rows between runs.
``forward_producer`` and ``forward_consumer`` repeat that step for step;
on ``chip_smoke.bev_forward_trap_case`` (a negative start, zero-length
intervals, an end past the last point, starts at and past it, a dropped
interval inside a run, runs across tile edges, an interval over several
tiles, the grid's first and last cells) every kept interval has one
owner, every grid row is written once, and the model's output equals the
plain forward (``reference/vision/vision.py:bev_pool``) bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conch_tpu.ops.vision as jv
from chip_smoke import bev_cell_coords, bev_forward_trap_case, bev_out_of_range
from conch_tpu_torch.kernels.vision.bev_pool import (
    BWD_BLOCK_POINTS,
    FWD_HEADER_BYTES,
    FWD_MAX_STAGES,
    FWD_PIECES,
    FWD_STAGE_BYTES,
    FWD_TILE_POINTS,
    bev_backward_blocks,
    bev_forward_plan,
    vector_width,
)
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
from conch_tpu_torch.reference.vision.vision import bev_pool, bev_pool_backward, interval_cells
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


# --- K13a ---------------------------------------------------------------------

BEVFUSION_POINTS = 1_630_118  # chip_smoke.bevfusion_inputs' kept points
FWD_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
OPEN_INTERVAL, CLOSE_INTERVAL, OPEN_RUN, CLOSE_RUN = 1, 2, 4, 8  # a piece's flags (csrc/bev_pool.cu)


def kernel_vec(channels, dtype, offset=0):
    """vector_width for features of ``channels`` whose base is ``offset``
    elements past an allocation's (16-byte aligned) start."""
    feats = torch.empty(2 * channels + offset, dtype=dtype)[offset:]
    return vector_width(channels, feats.element_size(), feats)


@pytest.mark.parametrize("dtype", FWD_DTYPES)
@pytest.mark.parametrize("channels", (5, 6, 24, 80, 256))
@pytest.mark.parametrize("offset", (0, 1))
def test_bev_forward_plan_fits_the_card(channels, dtype, offset):
    """At BEVFusion's point count: a block a tile; TMA stages exactly where a
    row is whole 16-byte vectors on a 16-byte base, each stage whole rows
    of at most FWD_STAGE_BYTES, a multiple of 16 bytes; the shared memory
    within the H100's 227 KB, and as many stages as fit up to the cap."""
    es = torch.empty((), dtype=dtype).element_size()
    vec = kernel_vec(channels, dtype, offset)
    plan = bev_forward_plan(BEVFUSION_POINTS, channels, es, vec)
    row = channels * es
    assert plan.tile_points == FWD_TILE_POINTS
    assert (plan.blocks - 1) * plan.tile_points < BEVFUSION_POINTS <= plan.blocks * plan.tile_points
    assert plan.tma == (row % 16 == 0 and offset == 0) == (vec * es == 16)
    if plan.tma:
        assert plan.stage_rows == min(max(1, FWD_STAGE_BYTES // row), FWD_PIECES)
        assert plan.stage_bytes == plan.stage_rows * row and plan.stage_bytes % 16 == 0
        assert plan.stage_bytes <= max(FWD_STAGE_BYTES, row) and 2 <= plan.stages <= FWD_MAX_STAGES
    else:
        assert plan.stage_rows == FWD_PIECES and plan.stage_bytes == 0 and plan.stages == FWD_MAX_STAGES
    one_stage = plan.stage_bytes + FWD_HEADER_BYTES + 16  # its rows, its header, two mbarriers
    assert plan.smem_bytes == 16 * channels + FWD_HEADER_BYTES + plan.stages * one_stage
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.stages == FWD_MAX_STAGES or plan.smem_bytes + one_stage > SMEM_LIMIT
    if channels == 80 and offset == 0:  # BEVFusion's rows: stages of 56 f32 or 112 bf16 / f16 rows, 5 blocks an SM
        assert plan.tma and plan.stage_rows == FWD_STAGE_BYTES // row and 5 * (plan.smem_bytes + 1024) <= 228 * 1024


def test_bev_forward_plan_wide_rows():
    """Rows too wide for two stages are read from global memory; channels
    whose carried sums leave no room raise."""
    wide = bev_forward_plan(1000, 12288, 4, 4)
    assert not wide.tma and wide.smem_bytes <= SMEM_LIMIT
    assert bev_forward_plan(1000, 8192, 2, 8).tma
    with pytest.raises(NotImplementedError):
        bev_forward_plan(1000, 15000, 4, 4)


class Stage:
    """One published stage: its pieces (first feats row, cell, first stage
    row, rows, flags), segment starts, rows and whether it is the last."""

    def __init__(self, pieces, rows, done):
        self.pieces, self.rows, self.done = pieces, rows, done
        self.segs = [k for k in range(len(pieces)) if k == 0 or pieces[k - 1][4] & CLOSE_RUN]


def kept_cells(starts, geom, grid):
    """bev_cell of each interval: its flat cell, or -1 when it is dropped."""
    cells, valid = interval_cells(torch.from_numpy(geom), torch.from_numpy(starts), *grid)
    return torch.where(valid, cells, -1).numpy()


def first_bit(lanes, above=-1):
    """The first lane above ``above`` in ``lanes`` (32: none), as next_bit."""
    return min([lane for lane in lanes if lane > above], default=32)


def forward_producer(block, starts, lengths, cells, num_points, grid_rows, plan):
    """bev_pool_fwd_kernel's producer warp for one block, step for step:
    (its published stages in order, the grid rows it zeros as [lo, hi)
    ranges, the intervals it emits rows of)."""
    ni, p0, sr = len(starts), block * plan.tile_points, plan.stage_rows
    p1 = min(p0 + plan.tile_points, num_points)
    first = int(np.searchsorted(starts, p0, side="left"))  # the 32-way search's answer (ascending starts)
    cur_cell = next((int(cells[i]) for i in range(first - 1, -1, -1) if cells[i] >= 0), -1)
    stages, zeros, emitted, open_pieces = [], [], [], []
    streamed = t_pub = 0
    pending = -1

    def publish(done):
        nonlocal t_pub
        stages.append(Stage(list(open_pieces), min(streamed - t_pub * sr, sr), done))
        t_pub += 1
        open_pieces.clear()

    owned_run = run_rows = any_run = reached_end = False
    j = first
    while True:
        idx = [j + lane for lane in range(32)]
        valid = [i < ni for i in idx]
        start = [int(starts[i]) if v else num_points for i, v in zip(idx, valid)]
        length = [int(lengths[i]) if v else 0 for i, v in zip(idx, valid)]
        cell = [int(cells[i]) if v else -1 for i, v in zip(idx, valid)]
        kept = [c >= 0 for c in cell]
        in_tile = [v and st < p1 for v, st in zip(valid, start)]
        prev, run_start, own = [], [], []
        for lane in range(32):
            below = [m for m in range(lane) if kept[m]]
            prev.append(cell[below[-1]] if below else cur_cell)
            run_start.append(kept[lane] and cell[lane] != prev[lane])
            openers = [m for m in range(lane + 1) if run_start[m]]
            own.append(in_tile[openers[-1]] if openers else owned_run)
        stop = [not valid[lane] or (not in_tile[lane] and not own[lane]) for lane in range(32)]
        count = stop.index(True) if any(stop) else 32
        opens = [lane for lane in range(count) if run_start[lane] and own[lane]]
        zeros += [(prev[lane] + 1, cell[lane]) for lane in opens if cell[lane] > prev[lane] + 1]
        end = [min(st + max(ln, 0), num_points) for st, ln in zip(start, length)]
        emits = [lane for lane in range(count) if kept[lane] and own[lane] and end[lane] > start[lane]]
        events = opens + ([count] if count < 32 else [])
        for e in events:  # a run that closes without rows: its cell's zeros
            r = max([lane for lane in opens if lane < e], default=-1)
            rows_between = any(max(r, 0) <= m < e for m in emits)
            if r >= 0 and not rows_between:
                zeros.append((cell[r], cell[r] + 1))
            if r < 0 and owned_run and not run_rows and not rows_between:
                zeros.append((cur_cell, cur_cell + 1))
        opens_rows = {}  # the first rows since the run opened (its opening interval may have none)
        for m in emits:
            r = max([lane for lane in opens if lane <= m], default=-1)
            opens_rows[m] = not any(max(r, 0) <= x < m for x in emits) and (r >= 0 or not run_rows)
        decided = {m: first_bit(events, m) < 32 or first_bit(emits, m) < 32 for m in emits}
        closes = {m: first_bit(events, m) < 32 and first_bit(events, m) <= first_bit(emits, m) for m in emits}
        if pending >= 0:
            e0, m0 = first_bit(events), first_bit(emits)
            if e0 < 32 or m0 < 32:
                if e0 < 32 and e0 <= m0:
                    grow, c, srow, n, flags = open_pieces[pending]
                    open_pieces[pending] = (grow, c, srow, n, flags | CLOSE_RUN)
                pending = -1
                if streamed == (t_pub + 1) * sr:
                    publish(False)
        rows = {m: end[m] - start[m] for m in emits}
        pos, at = {}, streamed
        for m in emits:
            pos[m], at = at, at + rows[m]
        batch_end = at
        emitted += [idx[m] for m in emits]
        while emits:
            lo, hi = t_pub * sr, t_pub * sr + sr
            for m in emits:
                a, b = max(pos[m], lo), min(pos[m] + rows[m], hi)
                if a < b:
                    flags = (OPEN_INTERVAL | (OPEN_RUN if opens_rows[m] else 0) if a == pos[m] else 0) | (
                        CLOSE_INTERVAL | (CLOSE_RUN if closes[m] else 0) if b == pos[m] + rows[m] else 0)
                    open_pieces.append((start[m] + a - pos[m], cell[m], a - lo, b - a, flags))
            if batch_end < hi:
                if not decided[emits[-1]]:
                    pending = len(open_pieces) - 1
                break
            streamed = hi
            if batch_end == hi and not decided[emits[-1]]:
                pending = len(open_pieces) - 1
                break
            publish(False)
        streamed = batch_end
        any_run |= bool(opens)
        run_rows = any(m >= opens[-1] for m in emits) if opens else run_rows or bool(emits)
        if count > 0:
            owned_run = own[count - 1]
        mine = [lane for lane in range(count) if kept[lane]]
        if mine:
            cur_cell = cell[mine[-1]]
        if count < 32:
            reached_end = not valid[count]
            break
        j += 32
    if reached_end and owned_run and cur_cell + 1 < grid_rows:
        zeros.append((cur_cell + 1, grid_rows))
    if block == 0 and not any_run and not (cells[first:] >= 0).any():
        zeros.append((0, grid_rows))
    assert pending < 0
    publish(True)
    return stages, zeros, emitted


def forward_consumer(stages, feats, plan, row_bytes):
    """The consumers over one block's stages, step for step (f32 sums in
    numpy, every channel at once: a thread's chain is one channel's), with
    each TMA stage's rows put where its pieces' copies land: {cell: f32 row}."""
    channels, writes, carry = feats.shape[1], {}, None
    for stage in stages:
        assert len(stage.pieces) <= FWD_PIECES and stage.rows <= plan.stage_rows
        assert sum(p[3] for p in stage.pieces) == stage.rows
        rows = feats
        if plan.tma:
            rows = np.full((plan.stage_rows, channels), np.nan, dtype=np.float32)
            for grow, _, srow, n, _ in stage.pieces:
                # TMA's rule: 16-byte aligned source and destination, a multiple of 16 bytes, inside the stage.
                assert (grow * row_bytes) % 16 == 0 and (srow * row_bytes) % 16 == 0 and (n * row_bytes) % 16 == 0
                assert n >= 1 and srow + n <= plan.stage_rows
                rows[srow : srow + n] = feats[grow : grow + n]
            assert stage.rows * row_bytes <= plan.stage_bytes
        segs, out_carry = [*stage.segs, len(stage.pieces)], None
        for k in range(len(stage.segs)):
            pieces = stage.pieces[segs[k] : segs[k + 1]]
            first = pieces[0][4]
            if not first & (OPEN_INTERVAL | OPEN_RUN) == OPEN_INTERVAL | OPEN_RUN:
                assert k == 0 and carry is not None  # only a stage's first segment goes on from the last stage
            s = np.zeros(channels, np.float32) if first & OPEN_INTERVAL else carry[0]
            acc = np.zeros(channels, np.float32) if first & OPEN_RUN else carry[1]
            for grow, cell, srow, n, flags in pieces:
                if flags & OPEN_INTERVAL:
                    s = np.zeros(channels, np.float32)
                if flags & OPEN_RUN:
                    acc = np.zeros(channels, np.float32)
                base = srow if plan.tma else grow
                for r in range(base, base + n):
                    s = s + rows[r]  # in point order, f32
                if flags & CLOSE_INTERVAL:
                    acc = acc + s
                if flags & CLOSE_RUN:
                    assert cell not in writes
                    writes[cell] = acc
            if not pieces[-1][4] & CLOSE_RUN:
                assert k == len(stage.segs) - 1
                out_carry = (s, acc)
        carry = out_carry
    return writes


def forward_model(feats, geom, starts, lengths, grid, plan, sums=True):
    """The kernel's blocks over the intervals: checks that every kept
    interval is emitted by one block and every grid row written once, and
    returns the output (with ``sums``) as the kernel writes it."""
    num_points, grid_rows = geom.shape[0], int(np.prod(grid))
    cells = kept_cells(starts, geom, grid)
    owners, written, runs = np.zeros(len(starts), int), np.zeros(grid_rows, int), {}
    feats32 = feats.float().numpy() if sums else None
    row_bytes = feats.shape[1] * feats.element_size()
    for block in range(plan.blocks):
        stages, zeros, emitted = forward_producer(block, starts, lengths, cells, num_points, grid_rows, plan)
        assert stages[-1].done and not any(st.done for st in stages[:-1])
        owners[emitted] += 1
        for lo, hi in zeros:
            written[lo:hi] += 1
        closed = [p[1] for st in stages for p in st.pieces if p[4] & CLOSE_RUN]
        written[closed] += 1
        if sums:
            runs.update(forward_consumer(stages, feats32, plan, row_bytes))
    nonempty = np.minimum(starts.astype(np.int64) + np.maximum(lengths, 0), num_points) > starts
    np.testing.assert_array_equal(owners, ((cells >= 0) & nonempty).astype(int),
                                  err_msg="kept intervals with points owned once, the others never")
    np.testing.assert_array_equal(written, np.ones(grid_rows, int), err_msg="grid rows written once")
    if not sums:
        return None
    out = torch.zeros((grid_rows, feats.shape[1]), dtype=feats.dtype)
    for cell, acc in runs.items():
        out[cell] = torch.from_numpy(acc).to(feats.dtype)  # one cast, to nearest even
    return out.reshape(*grid, feats.shape[1])


def same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.reshape(-1).view(torch.uint8),
                                                                     b.reshape(-1).view(torch.uint8))


def check_model(geom, starts, lengths, grid, dtype, channels, tile_points, seed=0):
    feats = torch.from_numpy(np.random.default_rng(seed).normal(size=(geom.shape[0], channels)).astype(np.float32))
    feats = feats.to(dtype)
    es = feats.element_size()
    vec = kernel_vec(channels, dtype)
    plan = bev_forward_plan(geom.shape[0], channels, es, vec, tile_points=tile_points)
    got = forward_model(feats, geom, starts, lengths, grid, plan)
    ref = bev_pool(feats, torch.from_numpy(geom), torch.from_numpy(starts), torch.from_numpy(lengths), *grid)
    assert same_bits(got, ref)
    return plan


@pytest.mark.parametrize("dtype", FWD_DTYPES)
@pytest.mark.parametrize("channels", (6, 24))
@pytest.mark.parametrize("tile_points", (64, FWD_TILE_POINTS))
def test_bev_forward_model_matches_plain(tile_points, channels, dtype):
    """The trap case at 3000 points, in tiles of 64 (47 blocks, runs and an
    interval of 209 points across their edges) and of the kernel's 1024;
    C 24 through TMA stages, C 6 from global memory."""
    grid = (2, 2, 16, 16)
    geom, starts, lengths = bev_forward_trap_case(np.random.default_rng(tile_points + channels), 3000, grid,
                                                  tile_points)
    plan = check_model(geom, starts, lengths, grid, dtype, channels, tile_points)
    assert plan.tma == (channels == 24)


def test_bev_forward_model_small_stages():
    """Stages of 3 rows (a 16 KB stage of a 5456-byte row): every interval
    crosses stages, runs carry their sums from stage to stage."""
    grid = (2, 2, 16, 16)
    geom, starts, lengths = bev_forward_trap_case(np.random.default_rng(5), 600, grid, 64)
    check_model(geom, starts, lengths, grid, torch.float32, 1364, 64)


def test_bev_forward_ownership_at_many_tiles():
    """100,000 points in tiles of 1024 (98 blocks): intervals owned once,
    grid rows written once (no sums)."""
    grid = (2, 1, 128, 128)
    geom, starts, lengths = bev_forward_trap_case(np.random.default_rng(3), 100_000, grid, FWD_TILE_POINTS)
    feats = torch.empty((geom.shape[0], 80), dtype=torch.bfloat16)
    forward_model(feats, geom, starts, lengths, grid, bev_forward_plan(geom.shape[0], 80, 2, 8), sums=False)


def test_bev_forward_no_kept_interval():
    """Every interval dropped: block 0 zeros the grid, no block emits."""
    grid = (2, 2, 16, 16)
    geom = np.tile(np.asarray(bev_out_of_range(7, grid), dtype=np.int32), (500, 1))
    starts = np.arange(0, 500, 10, dtype=np.int32)
    check_model(geom, starts, np.full_like(starts, 10), grid, torch.float32, 24, 64)


def test_bev_forward_long_interval():
    """One interval of 20,000 points (over 300 tiles of 64) between two short
    ones: its owner streams it through the stages, the tiles it covers skip it."""
    grid, n = (2, 2, 16, 16), 20_020
    geom = np.zeros((n, 4), dtype=np.int32)
    geom[:10], geom[10:-10], geom[-10:] = bev_cell_coords(3, grid), bev_cell_coords(7, grid), bev_cell_coords(700, grid)
    starts = np.asarray([0, 10, n - 10], dtype=np.int32)
    lengths = np.asarray([10, n - 20, 10], dtype=np.int32)
    check_model(geom, starts, lengths, grid, torch.bfloat16, 24, 64)
