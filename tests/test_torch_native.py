# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""The port's native C++ library (``native.py`` over ``ext/*.cc``).

- The g++ build at first use: into a fresh directory, reused while newer
  than every source; a failed build raises, and so does an engine under
  ``CONCH_ENABLE_CPP_EXT=1`` (no silent fallback to the Python allocator).
- tests/native_ext_test.py's cases: the native BEV pool (forward and
  backward) and voxelization against the port's plain vision ops and the
  JAX ops (the JAX side in interpret mode).
- ``NativeBlockAllocator`` against ``BlockAllocator`` over one seeded
  sequence of allocate, fork, free and cow, errors included (the native
  one raises the JAX package's types, the Python one ``RuntimeError``), and
  tests/native_ext_test.py's two allocator cases for both.
- The engine under ``CONCH_ENABLE_CPP_EXT=1`` takes the native allocator
  and gives the Python allocator's tokens, through preemption and the
  prefix cache.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from vision_test import _make_bev_inputs

from conch_tpu.ops.vision import VoxelizationParameter as JaxVoxelizationParameter
from conch_tpu.ops.vision import bev_pool as jax_bev_pool
from conch_tpu.ops.vision import bev_pool_backward as jax_bev_pool_backward
from conch_tpu.ops.vision import generate_voxels as jax_generate_voxels
from conch_tpu_torch import native
from conch_tpu_torch.models.llama import LlamaConfig, init_llama_params
from conch_tpu_torch.ops.vision import VoxelizationParameter, bev_pool, bev_pool_backward, generate_voxels
from conch_tpu_torch.serving import BlockAllocator, EngineConfig, LLMEngine, SamplingParams
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """``native`` building into an empty directory, its loaded library
    forgotten before and after."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    native.load_library.cache_clear()
    yield tmp_path
    native.load_library.cache_clear()


def test_build_at_first_use(fresh_build):
    library = fresh_build / native.LIBRARY_NAME
    assert not library.exists()
    lib = native.load_library()
    assert library.exists() and lib._name == str(library)
    mtime = library.stat().st_mtime_ns
    assert native.build_library() == library and library.stat().st_mtime_ns == mtime  # newer than every source
    assert [p.name for p in fresh_build.iterdir()] == [native.LIBRARY_NAME]  # no partial file left
    assert native.NativeBlockAllocator(3).num_free == 3


def test_failed_build_raises(fresh_build, monkeypatch):
    monkeypatch.setenv("CONCH_CXX", "false")  # a compiler that always fails
    with pytest.raises(RuntimeError, match="native library build failed"):
        native.load_library()
    monkeypatch.setenv("CONCH_CXX", str(fresh_build / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="native library build failed"):
        native.build_library()
    monkeypatch.setenv("CONCH_ENABLE_CPP_EXT", "1")
    cfg = LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=128, num_layers=1, num_heads=2,
                      num_kv_heads=1, head_dim=32, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="native library build failed"):
        LLMEngine(init_llama_params(0, cfg, device="cpu"), cfg, EngineConfig(num_pages=8), device="cpu")
    assert not list(fresh_build.iterdir())


def test_native_bev_pool_matches_plain_and_jax():
    rng = np.random.default_rng(0)
    for sort_cells in (True, False):
        feats, geom, starts, lengths, (b, gz, gx, gy) = _make_bev_inputs(rng, sort_cells=sort_cells)
        out = native.bev_pool_forward(feats, geom, starts, lengths, b, gz, gx, gy)
        t = [torch.from_numpy(a) for a in (feats, geom, starts, lengths)]
        plain = bev_pool(*t, b, gz, gx, gy, cells_sorted=sort_cells).numpy()
        ref = np.asarray(jax_bev_pool(*map(jnp.asarray, (feats, geom, starts, lengths)), b, gz, gx, gy,
                                      cells_sorted=sort_cells))
        np.testing.assert_allclose(out, plain, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)

        grad = rng.normal(size=out.shape).astype(np.float32)
        native_grad = native.bev_pool_backward(grad, geom, starts, lengths, feats.shape[0])
        plain_grad = bev_pool_backward(torch.from_numpy(grad), *t[1:], cells_sorted=sort_cells).numpy()
        ref_grad = np.asarray(jax_bev_pool_backward(*map(jnp.asarray, (grad, geom, starts, lengths)),
                                                    cells_sorted=sort_cells))
        np.testing.assert_array_equal(native_grad, plain_grad)  # copies: exact
        np.testing.assert_array_equal(native_grad, ref_grad)


def test_native_voxelize_matches_plain_and_jax():
    rng = np.random.default_rng(1)
    args = ((0.0, 0.0, 0.0), (8.0, 8.0, 4.0), (1.0, 1.0, 1.0), 4)
    param, jax_param = VoxelizationParameter(*args), JaxVoxelizationParameter(*args)
    pts = rng.uniform(-1, 9, size=(300, 4)).astype(np.float32)
    n, feats, idx, counts = native.voxelize(pts, param.min_range, param.voxel_dim, param.grid_dim, 4,
                                            param.max_num_voxels)
    for got in (generate_voxels(torch.from_numpy(pts), param), jax_generate_voxels(jnp.asarray(pts), jax_param)):
        n_ref, feats_ref, idx_ref, counts_ref = (np.asarray(a) for a in got)
        assert 0 < n == int(n_ref) < 300
        np.testing.assert_array_equal(idx[:n], idx_ref[:n])
        np.testing.assert_array_equal(counts[:n], counts_ref[:n])
        np.testing.assert_array_equal(feats[:n], feats_ref[:n])


@pytest.mark.parametrize("make", [native.NativeBlockAllocator, BlockAllocator], ids=["native", "python"])
def test_allocator_semantics(make):
    """tests/native_ext_test.py's two allocator cases."""
    alloc = make(8)
    pages = [alloc.allocate() for _ in range(8)]
    assert sorted(pages) == list(range(8)) and alloc.num_free == 0
    with pytest.raises(MemoryError, match="Out of KV-cache pages"):
        alloc.allocate()
    alloc.fork(pages[0])
    assert alloc.is_shared(pages[0])
    assert alloc.cow(pages[3]) == (pages[3], False)  # an exclusive page: no copy
    alloc.free(pages[1])
    assert alloc.num_free == 1
    w2, need_copy = alloc.cow(pages[0])
    assert need_copy and w2 != pages[0] and not alloc.is_shared(pages[0])

    alloc = make(4)
    page = alloc.allocate()
    alloc.free(page)
    with pytest.raises((AssertionError, RuntimeError), match="fork of"):
        alloc.fork(page)
    assert alloc.num_free == 4  # the failed fork leaves the free list as it was


def test_native_allocator_matches_python_over_a_seeded_sequence():
    rng = np.random.default_rng(7)
    pages_total = 12
    ours, ref = native.NativeBlockAllocator(pages_total), BlockAllocator(pages_total)
    held: list[int] = []
    raised = {"free": 0, "fork": 0, "allocate": 0, "cow": 0}
    for _ in range(2000):
        op = rng.choice(["allocate", "fork", "free", "cow", "free_any", "fork_any"], p=[0.3, 0.15, 0.25, 0.1, 0.1,
                                                                                          0.1])
        page = int(rng.integers(0, pages_total)) if op.endswith("_any") or not held else int(rng.choice(held))
        results = []
        for alloc in (ours, ref):
            try:
                if op == "allocate":
                    results.append(("ok", alloc.allocate()))
                elif op.startswith("fork"):
                    results.append(("ok", alloc.fork(page)))
                elif op.startswith("free"):
                    results.append(("ok", alloc.free(page)))
                else:
                    results.append(("ok", alloc.cow(page)))
            except (MemoryError, AssertionError, RuntimeError) as exc:
                results.append((type(exc).__name__, str(exc)))
        (kind, value), (ref_kind, ref_value) = results
        if ref_kind == "ok":
            assert (kind, value) == (ref_kind, ref_value), op
        else:  # the same refusal: JAX's types on the native side, RuntimeError on the Python one
            want = {"MemoryError": "MemoryError", "RuntimeError": "AssertionError"}[ref_kind]
            assert kind == want, (op, kind, ref_kind)
            if ref_kind == "MemoryError":
                assert value == ref_value == "Out of KV-cache pages"
            else:
                assert value.split(" of ")[0] == ref_value.split(" of ")[0] and value.endswith(f"page {page}")
            raised[op.split("_")[0]] += 1
        if ref_kind == "ok" and op == "allocate":
            held.append(value)
        elif ref_kind == "ok" and op == "cow" and value[1]:  # a fresh page for one of page's references
            held.remove(page)
            held.append(value[0])
        elif ref_kind == "ok" and op.startswith("fork"):
            held.append(page)
        elif ref_kind == "ok" and op.startswith("free"):
            held.remove(page)
        assert ours.num_free == ref.num_free
        assert [ours.refcount(p) for p in range(pages_total)] == [ref.refcount(p) for p in range(pages_total)]
    assert raised["free"] and raised["fork"] and raised["allocate"], raised  # every kind of refusal came up


def test_engine_with_native_allocator_gives_the_same_tokens(monkeypatch):
    cfg = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=2,
                      num_kv_heads=1, head_dim=32, dtype=torch.float32)
    params = init_llama_params(0, cfg, device="cpu")
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 128, 32).tolist()
    prompts = [shared + rng.integers(0, 128, n).tolist() for n in (5, 20, 40)] + [rng.integers(0, 128, 50).tolist()]
    ecfg = EngineConfig(page_size=16, num_pages=14, max_batch_size=4, max_pages_per_seq=8, max_prefill_tokens=64)
    runs = []
    for flag in ("0", "1"):
        monkeypatch.setenv("CONCH_ENABLE_CPP_EXT", flag)
        engine = LLMEngine(params, cfg, ecfg, device="cpu")
        assert isinstance(engine.allocator, native.NativeBlockAllocator) == (flag == "1")
        outs, preempted = [], 0
        for wave in (prompts, prompts[::-1]):  # the second wave hits the prefix cache
            ids = [engine.add_request(p, SamplingParams(max_tokens=24)) for p in wave]
            done = {}
            while engine.waiting or engine.running:
                for r in engine.step():
                    done[r.request_id] = r
            outs.append([done[i].output_tokens for i in ids])
            preempted += sum(done[i].num_preemptions for i in ids)
        runs.append((outs, preempted, engine.prefix_cache_hits, engine.allocator.num_free + len(engine._cached_lru)))
    assert runs[1] == runs[0]
    assert runs[0][1] > 0 and runs[0][2] > 0 and runs[0][3] == 14  # preempted, hit the cache, every page back
