# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Time K13c (the NMS keep mask), K13b (the BEV pool backward) and K13a (the
BEV pool forward) in copies that change one thing each, and measure the
scan's serial floor.

    python3 -m conch_tpu_torch.tools.vision_diagnostics [NAME ...]

Run from the checkout's root on one Hopper card. For each copy below (or
the named ones), the tool copies the package to
``conch_tpu_torch/_build/diagnostics/<name>/`` with only ``csrc/nms.cu`` and
``csrc/bev_pool.cu``, makes the copy's change, and in a subprocess times,
through the launchers and at ``chip_smoke.py``'s sizes: K13c on 4096 tied
boxes at IoU 0.5 (``chip_smoke.time_ms``, and each kernel's device time
from a profile of 20 calls), K13b on BEVFusion's pool in f32 and bf16, and
``torch.zeros`` of K13b's output (a pure store of the same bytes); K13a on
the same pool (its kernels by name from a profile), ``torch.zeros`` of its
grid, and K13a on the pool with every interval cut to 64 points (not a
pool: the time without the longest intervals' tail); and, once, the
pool's interval count, longest interval and histogram of interval lengths.
Each run says whether its outputs equal the plain versions (the
diagnostic copies need not). The unchanged package runs first and last,
so a drift of the card shows. The copies:

- ``nms_resolve_x5``: the resolver runs its 64-step loop five times a word
  (each pass from the word's removed bits, chained on the one before;
  same result). Its scan time over the unchanged one's, per extra step,
  is the time of one resolve step: times the SM clock (``nvidia-smi``'s
  clocks.sm after the runs) its cycles, and 4096 steps the serial floor;
- ``nms_no_background_work``: the background warps wait and release as
  always but OR nothing (wrong keep masks): the scan without their work;
- ``nms_8_background_warps``: twice the background warps;
- ``nms_spin_waits``: every mbarrier wait polls (``test_wait``) instead of
  letting the hardware suspend the warp until the phase completes
  (``try_wait``);
- ``bev_plain_stores``: K13b's stores without the streaming hint;
- ``bev_no_gather``: K13b stores zeros for every row (no cell row read;
  wrong output): its stores and searches alone;
- ``bev_fwd_no_sums``: K13a's consumers wait for each stage and release it
  but add nothing (wrong output): the stream of rows and the grid's
  zeros alone;
- ``bev_fwd_producer_only``: K13a without its row copies and without the
  consumers' sums (wrong output): the producer's walk over the intervals,
  its stages and zeros alone;
- ``bev_fwd_no_zeros``: K13a without the gaps' zeros (unwritten rows);
- ``bev_fwd_wide_vectors``: K13a's consumers always take whole 16-byte
  vectors, never a narrower one for a stage of few runs;
- ``bev_fwd_3_stages``: K13a's ring of 3 stages (2 planned: five blocks
  an SM; 3 leave room for three);
- ``bev_fwd_tile_1024``: K13a's blocks own the intervals of 1024 points
  (640 planned);
- ``bev_fwd_default_carveout``: K13a without its shared-memory carveout
  set to the SM's whole shared memory (CUDA's default carveout).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from conch_tpu_torch.kernels.common import BUILD_DIR
from conch_tpu_torch.tools.parent_compare import PACKAGE_DIR, REPO_ROOT

RESOLVE = """#pragma unroll
      for (int r = 0; r < kNmsTile; ++r) {
        if (!((rem >> r) & 1)) rem |= diag[r];  // box r kept: it removes the later boxes it overlaps
      }
"""
RESOLVE_X5 = """const uint64_t zero = n < 0 ? ~0ull : 0ull, start = rem;
      uint64_t chain = start;
      for (int rep = 0; rep < 5; ++rep) {
        rem = chain;
#pragma unroll
        for (int r = 0; r < kNmsTile; ++r) {
          if (!((rem >> r) & 1)) rem |= diag[r];
        }
        chain = start | (rem & zero);
      }
"""
STORE = "    __stcs(dst + v, x);  // streamed: the cells' rows keep L2"
# name -> [(file under the package, text, changed text), ...]
COPIES = {
    "unchanged": [],
    "nms_resolve_x5": [("csrc/nms.cu", RESOLVE, RESOLVE_X5)],
    "nms_no_background_work": [("csrc/nms.cu", "      if (kept != 0 && cols > 0) {", "      if (false) {")],
    "nms_8_background_warps": [
        ("csrc/nms.cu", "constexpr int kNmsBackgroundWarps = 4;", "constexpr int kNmsBackgroundWarps = 8;"),
    ],
    "nms_spin_waits": [("csrc/bulk_copy.cuh", "mbarrier.try_wait.parity", "mbarrier.test_wait.parity")],
    "bev_plain_stores": [("csrc/bev_pool.cu", STORE, "    dst[v] = x;")],
    "bev_no_gather": [("csrc/bev_pool.cu", "    if (row >= 0) x = rows[row * vecs + c];", "    (void)row;")],
    "bev_fwd_no_sums": [("csrc/bev_pool.cu", "  for (int u = tid; u < h.segs * per_seg; u += kFwdConsumers) {",
                         "  for (int u = tid + h.segs * per_seg; u < h.segs * per_seg; u += kFwdConsumers) {")],
    "bev_fwd_producer_only": [
        ("csrc/bev_pool.cu", "  for (int u = tid; u < h.segs * per_seg; u += kFwdConsumers) {",
         "  for (int u = tid + h.segs * per_seg; u < h.segs * per_seg; u += kFwdConsumers) {"),
        ("csrc/bev_pool.cu", "        mbar_arrive_expect(full + 8 * s, static_cast<uint32_t>(rows * row_bytes));",
         "        mbar_arrive(full + 8 * s);"),
        ("csrc/bev_pool.cu", "      if (one_span) {", "      if (one_span && rows < 0) {"),
        ("csrc/bev_pool.cu", "        for (int k = lane; k < npieces; k += 32) {", "        for (int k = lane; k < 0; k += 32) {"),
    ],
    "bev_fwd_no_zeros": [("csrc/bev_pool.cu", "zero_later(opens && cell > prev + 1, prev + 1, cell);",
                          "zero_later(opens && cell > prev + 1 && ni < 0, prev + 1, cell);")],
    "bev_fwd_wide_vectors": [("csrc/bev_pool.cu", "      int w = 1;\n", "      int w = V;\n")],
    "bev_fwd_3_stages": [("kernels/vision/bev_pool.py", "FWD_MAX_STAGES = 2", "FWD_MAX_STAGES = 3")],
    "bev_fwd_tile_1024": [("kernels/vision/bev_pool.py", "FWD_TILE_POINTS = 640", "FWD_TILE_POINTS = 1024")],
    "bev_fwd_default_carveout": [
        ("csrc/bev_pool.cu",
         "  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);",
         "  return cudaSuccess;"),
    ],
}
RUN = r'''
import json, tempfile
import numpy as np, torch
import chip_smoke as cs
from torch.profiler import ProfilerActivity, profile
from conch_tpu_torch.kernels.vision.bev_pool import bev_pool_backward_launcher as k13b, bev_pool_backward_plain
from conch_tpu_torch.kernels.vision.bev_pool import bev_pool_forward_launcher as k13a, bev_pool_plain
from conch_tpu_torch.kernels.vision.bev_pool import bev_forward_plan
from conch_tpu_torch.kernels.common import kernel_function, storage_code
import ctypes
from conch_tpu_torch.kernels.vision.nms import nms_keep_mask_launcher as k13c, nms_keep_mask_plain, sorted_boxes

gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
out = {}
boxes, scores = cs.nms_boxes(np.random.default_rng(cs.SEED), cs.NMS_BOXES, ties=True)
_, parts = sorted_boxes(boxes, scores)
out["K13c equal"] = bool(torch.equal(k13c(*parts, cs.NMS_IOU), nms_keep_mask_plain(*parts, cs.NMS_IOU)))
out["K13c ms"] = cs.time_ms(lambda: k13c(*parts, cs.NMS_IOU))


def kernel_ms(fn, iters=20):
    """Device ms a call of each kernel ``fn`` launches, by name, from a profile of ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(f"{tmp}/t.json")
        events = [e for e in json.load(open(f"{tmp}/t.json"))["traceEvents"] if e.get("cat") == "kernel"]
    by = {}
    for e in events:
        name = e["name"].replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0].split("<")[0]
        by[name[-40:]] = by.get(name[-40:], 0.0) + e["dur"] / 1e3 / iters
    return by


def same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.reshape(-1).view(torch.uint8),
                                                                     b.reshape(-1).view(torch.uint8))


by = kernel_ms(lambda: k13c(*parts, cs.NMS_IOU))
for kernel in ("nms_mask_kernel", "nms_scan_kernel"):
    out[f"K13c {kernel} ms"] = sum(ms for name, ms in by.items() if kernel in name)
for dtype in (torch.float32, torch.bfloat16):
    bev = cs.bevfusion_inputs(gen, np.random.default_rng(cs.SEED), dtype)
    n, tag = bev["feats"].shape[0], str(dtype).split(".")[-1]
    grad = torch.randn((*cs.BEV_GRID, cs.BEV_C), generator=gen, device="cuda").to(dtype)
    args = (grad, bev["geom"], bev["starts"], bev["lengths"], n)
    out[f"K13b {tag} equal"] = bool(torch.equal(k13b(*args), bev_pool_backward_plain(*args)))
    out[f"K13b {tag} ms"] = cs.time_ms(lambda: k13b(*args))
    out[f"zero fill {tag} ms"] = cs.time_ms(lambda: torch.zeros((n, cs.BEV_C), dtype=dtype, device="cuda"))
    # K13a on the same inputs: through its launcher, its kernels by name, a fill of its grid alone, and
    # the inputs with every interval cut to 64 points (not a pool: the longest runs' tail taken away).
    fargs = (bev["feats"], bev["geom"], bev["starts"], bev["lengths"], *cs.BEV_GRID)
    out[f"K13a {tag} equal"] = bool(same_bits(k13a(*fargs), bev_pool_plain(*fargs)))
    out[f"K13a {tag} ms"] = cs.time_ms(lambda: k13a(*fargs))
    for kernel, ms in kernel_ms(lambda: k13a(*fargs)).items():
        out[f"K13a {tag} [profile] {kernel} ms"] = ms
    plan = bev_forward_plan(fargs[0].shape[0], cs.BEV_C, fargs[0].element_size(), 16 // fargs[0].element_size())
    occupancy = kernel_function("conch_bev_pool_forward_occupancy", (ctypes.c_int,) * 4)
    out[f"K13a {tag} blocks an SM"] = occupancy(storage_code(fargs[0]), 16 // fargs[0].element_size(),
                                                 int(plan.tma), plan.smem_bytes)
    grid_shape = (*cs.BEV_GRID, cs.BEV_C)
    out[f"grid zero fill {tag} ms"] = cs.time_ms(lambda: torch.zeros(grid_shape, dtype=dtype, device="cuda"))
    cut = (*fargs[:3], bev["lengths"].clamp(max=64), *cs.BEV_GRID)
    out[f"K13a {tag} intervals cut to 64 points ms"] = cs.time_ms(lambda: k13a(*cut))
    if dtype == torch.float32:
        lengths = bev["lengths"].long()
        out["BEVFusion intervals"] = lengths.numel()
        out["BEVFusion longest interval"] = int(lengths.max())
        edges = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 2**62]
        hist = {}
        for lo, hi in zip([0, *edges[:-1]], edges):
            sel = (lengths >= lo) & (lengths < hi)
            hist[f"{lo}-{hi - 1}" if hi < 2**62 else f"{lo}+"] = [int(sel.sum()), int(lengths[sel].sum())]
        out["BEVFusion interval lengths: [intervals, points] by length"] = hist
        out["BEVFusion points in intervals over 64"] = int((lengths - 64).clamp(min=0).sum())
    del bev, grad, args, fargs, cut
    torch.cuda.empty_cache()
print("DIAG " + json.dumps(out), flush=True)
'''


def run_copy(name: str, edits: list) -> dict:
    root = BUILD_DIR / "diagnostics" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PACKAGE_DIR, root / PACKAGE_DIR.name, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for source in (root / PACKAGE_DIR.name / "csrc").glob("*.cu"):
        if source.name not in ("nms.cu", "bev_pool.cu"):
            source.unlink()
    for path, text, changed in edits:
        target = root / PACKAGE_DIR.name / path
        code = target.read_text()
        if code.count(text) != 1:
            msg = f"{name}: the text to change is not in {path} exactly once"
            raise RuntimeError(msg)
        target.write_text(code.replace(text, changed))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(root), str(REPO_ROOT)])}
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=root, env=env, capture_output=True, text=True,
                          timeout=300, check=False)
    line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("DIAG ")), None)
    if proc.returncode != 0 or line is None:
        msg = f"{name} failed (exit code {proc.returncode}):\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}"
        raise RuntimeError(msg)
    return json.loads(line[len("DIAG "):])


def main() -> int:
    names = sys.argv[1:] or [n for n in COPIES if n != "unchanged"]
    runs = []
    for name in ["unchanged", *names, "unchanged"]:
        result = run_copy(name, COPIES[name])
        runs.append((name, result))
        print(f"{name}: " + "; ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                                      for k, v in result.items()), flush=True)
    shutil.rmtree(BUILD_DIR / "diagnostics", ignore_errors=True)
    query = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"]
    card = subprocess.run(query, capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name, limit, sm_mhz, max_mhz = (x.strip() for x in card.split(","))
    by = dict(runs)
    if "nms_resolve_x5" in by:
        base = sum(r["K13c nms_scan_kernel ms"] for n, r in runs if n == "unchanged") / 2
        step_ms = (by["nms_resolve_x5"]["K13c nms_scan_kernel ms"] - base) / (4 * 4096)
        for label, mhz in (("clocks.sm after the runs", float(sm_mhz)), ("clocks.max.sm", float(max_mhz))):
            print(f"{name}, {limit} W, {label} {mhz:.0f} MHz: a resolve step {step_ms * 1e6:.3f} ns = "
                  f"{step_ms * 1e-3 * mhz * 1e6:.2f} cycles; serial floor of 4096 steps {4096 * step_ms:.4f} ms "
                  f"against the scan's {base:.4f} ms", flush=True)
    ok = all(r["K13c equal"] and r["K13b float32 equal"] and r["K13b bfloat16 equal"] and r["K13a float32 equal"]
             and r["K13a bfloat16 equal"]
             for n, r in runs if n in ("unchanged", "nms_resolve_x5", "nms_8_background_warps", "nms_spin_waits",
                                       "bev_plain_stores", "bev_fwd_wide_vectors", "bev_fwd_3_stages",
                                       "bev_fwd_tile_1024", "bev_fwd_default_carveout"))
    print("the copies that keep the arithmetic equal the plain versions" if ok else "a copy differs", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
